"""Evolution strategies on the Nature-DQN policy in plain float32 ``torch``.

A reference for the port's ES trainer on pixels (``train/es.py`` with
``NatureDQN``), written from the papers and the port's documented
conventions. It imports nothing of the port, of the benchmark or of JAX but
the threefry-2x32 hash of its sibling ``rainbow.py``.

- The estimator of Salimans et al. (2017), Algorithm 1 with antithetic
  sampling: ``pop / 2`` standard normal perturbations ``eps_i`` of the flat
  mean parameters ``theta``, members ``theta + sigma eps_i`` and ``theta -
  sigma eps_i``, and ``g = 1 / (pop sigma) sum_j shape(F_j) eps_j`` over the
  whole population, ``shape`` the centred ranks of the fitnesses in
  [-0.5, 0.5] (``rank / (pop - 1) - 0.5``); the step ``theta' = (1 - lr
  wd) theta + lr g``: gradient ascent with an L2 pull toward 0.
- The policy (Mnih et al., 2015): conv 32x8/4, 64x4/2, 64x3/1, each with a
  relu, dense 512 and a relu, then 7 linear Q-values, on one 84 x 84
  channel scaled by 1/255; the greedy action is the largest Q-value.
- A member's fitness is the mean over its envs of the sum of its rewards
  over the horizon.

Departures, each the port's documented convention rather than the paper's:

- Plain gradient steps with weight decay, not Adam; no virtual batch
  normalisation, no observation normalisation, no shared noise table, no
  frame skip.
- Antithetic pairs are rows ``i`` and ``i + pop / 2`` (the first half the
  positive perturbations, the second their negatives), not interleaved.
- Ties in the ranks go by position (a stable sort).
- The noise is drawn afresh each generation from threefry-2x32 with
  jax.random's conventions, as the port draws it: element (i, j) of the
  draw [rows, dim] is the hash of the counter ``i * dim + j`` under the
  draw's key, u from its 23 random mantissa bits in (-1, 1), and the
  normal ``sqrt(2) erfinv(u)``. ``erfinv`` is Giles' single-precision
  polynomial (Giles, 2010, "Approximating the erfinv function"), each of
  its multiply-adds fused (one rounding to float32), in ``w = -log(1 -
  u^2)`` with ``u^2`` rounded to float32 and the log taken in float64, then
  rounded to float32. ``torch.erfinv`` is not that polynomial (up to 65
  ulp apart from it), nor is the log of ``1 - u^2`` formed in float64 (65
  ulp near ``|u| = 0.99983``).
- ``theta`` is laid out as flax's ``ravel_pytree`` lays out the policy's
  parameters: the modules in sorted name order (``conv1``, ``conv2``,
  ``conv3``, ``dense``, ``q``), bias before kernel in each, conv kernels
  HWIO and dense kernels [in, out], row-major; the flatten after the last
  conv is in NHWC order.
- Everything is float32: the port's bf16 rounding points (each layer's
  operands and outputs) are not emulated; the tolerances of a comparison
  cover them. TF32 is off while the reference computes (``rainbow``'s
  ``float32_matmuls``).

``dtype`` computes the Q-network in that dtype on the device's own
kernels, every operand cast to it (bfloat16, the configuration's
precision, gives the comparison's yardstick); ``act_round`` rounds every
operand and output through a dtype below it (float8), a precision no
configuration states. The control ``negate=False`` leaves the antithetic
half un-negated.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .rainbow import _hash, _key, _RoundThrough, float32_matmuls, split

CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

# Giles' single-precision erfinv coefficients, highest first, for w < 5
# and w >= 5
_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
            -4.39150654e-06, 0.00021858087, -0.00125372503,
            -0.00417768164, 0.246640727, 1.50140941)
_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
         0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
         2.83297682)


# --- the perturbations -------------------------------------------------------


def _fused(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (the product of two float32
    is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision erfinv of float32 ``x`` in (-1, 1)."""
    w = (-torch.log1p(-(x * x).double())).float()
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    c = lambda v: torch.full_like(x, v)
    p = torch.where(central, c(_CENTRAL[0]), c(_TAIL[0]))
    for lo, hi in zip(_CENTRAL[1:], _TAIL[1:]):
        p = _fused(p, w, torch.where(central, c(lo), c(hi)))
    return p * x


def normal(key, rows, cols, dim: int, device) -> torch.Tensor:
    """The block ``[rows[0]:rows[1], cols[0]:cols[1]]`` of a draw of
    standard normals ``[*, dim]`` from ``key``, float32 on ``device``."""
    k0, k1 = _key(key)
    r = torch.arange(*rows, dtype=torch.int64, device=device)
    c = torch.arange(*cols, dtype=torch.int64, device=device)
    ctr = (r[:, None] * dim + c[None, :]).reshape(-1)
    y0, y1 = _hash(k0, k1, torch.zeros_like(ctr), ctr)
    u = (((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).to(device)
    u = torch.maximum(lo, (u - 1.0) * (1.0 - lo) + lo)
    root2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32)
    return (float(root2) * erfinv(u)).reshape(rows[1] - rows[0],
                                              cols[1] - cols[0])


def antithetic(half: torch.Tensor, negate: bool = True) -> torch.Tensor:
    """The population's perturbations [pop, ...] from the first half's
    [pop / 2, ...]: the second half their negatives (``negate=False``, the
    control: the same again)."""
    return torch.cat([half, -half if negate else half])


def keys(state_key) -> tuple:
    """(eps key, env reset key, next key): a generation's three-way split
    of the trainer's key."""
    return tuple(split(state_key, 3))


# --- the policy --------------------------------------------------------------


def layout(frame: int = 84, channels: int = 1, convs=CONVS,
           dense: int = 512, actions: int = 7) -> list:
    """(module, leaf, shape) of each parameter in ``theta``'s order."""
    out, cin, side = [], channels, frame
    for i, (c, k, s) in enumerate(convs):
        out += [(f"conv{i + 1}", "bias", (c,)),
                (f"conv{i + 1}", "kernel", (k, k, cin, c))]
        cin, side = c, (side - k) // s + 1
    out += [("dense", "bias", (dense,)),
            ("dense", "kernel", (side * side * cin, dense)),
            ("q", "bias", (actions,)), ("q", "kernel", (dense, actions))]
    return sorted(out)


def unflatten(theta: torch.Tensor, lay: list) -> dict:
    """``theta`` [dim] -> {(module, leaf): tensor} in ``lay``'s shapes."""
    sizes = [math.prod(shape) for _, _, shape in lay]
    if sum(sizes) != theta.shape[-1]:
        raise ValueError(f"theta has {theta.shape[-1]} elements, the "
                         f"layout {sum(sizes)}")
    return {(m, leaf): part.reshape(shape) for (m, leaf, shape), part
            in zip(lay, theta.split(sizes))}


def q_values(params: dict, obs: torch.Tensor, dtype=torch.float32,
             act_round=None) -> torch.Tensor:
    """Q-values [N, A], float32, of frames [N, 84, 84] (palette values 0 /
    128 / 190) under one member's ``params`` (``unflatten``)."""
    r = lambda t: t.to(dtype) if act_round is None else \
        _RoundThrough.apply(t.to(dtype), act_round)
    x = r(obs.to(dtype)[:, None] / 255.0)
    for i, (_, _, stride) in enumerate(CONVS):
        name = f"conv{i + 1}"
        w = params[name, "kernel"].permute(3, 2, 0, 1)      # HWIO -> OIHW
        x = F.conv2d(x, r(w), stride=stride)
        x = F.relu(r(r(x) + r(params[name, "bias"])[:, None, None]))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # NHWC flatten
    x = F.relu(r(r(x @ r(params["dense", "kernel"]))
                 + r(params["dense", "bias"])))
    return r(r(x @ r(params["q", "kernel"])) + r(params["q", "bias"])).float()


def member_q_values(theta, eps_row, sigma: float, sign: float,
                    obs: torch.Tensor, lay: list, **kw) -> torch.Tensor:
    """The Q-values of the member ``theta + sign * sigma * eps_row`` on
    ``obs``, TF32 off."""
    with float32_matmuls():
        params = unflatten(theta + sign * sigma * eps_row, lay)
        return q_values(params, obs, **kw)


# --- fitness and the update --------------------------------------------------


def fitness(rewards: torch.Tensor, envs_per_member: int) -> torch.Tensor:
    """Each member's fitness [pop] from its envs' rewards [T, pop *
    envs_per_member] (member m plays envs m * k ... m * k + k - 1): the
    mean over its envs of the sum over the steps, in float64."""
    per_env = rewards.double().sum(0)
    return per_env.reshape(-1, envs_per_member).mean(1)


def centered_ranks(f: torch.Tensor) -> torch.Tensor:
    """rank / (n - 1) - 0.5, ties by position, float32."""
    n = f.shape[0]
    ranks = torch.argsort(torch.argsort(f, stable=True), stable=True)
    return ranks.float() / (n - 1) - 0.5


def gradient(shaped: torch.Tensor, eps: torch.Tensor,
             sigma: float) -> torch.Tensor:
    """``shaped @ eps / (pop sigma)`` (eps [pop, cols]), float32, TF32
    off."""
    with float32_matmuls():
        return shaped @ eps / (eps.shape[0] * sigma)


def step(theta: torch.Tensor, grad: torch.Tensor, lr: float,
         weight_decay: float) -> torch.Tensor:
    return (1.0 - lr * weight_decay) * theta + lr * grad
