"""The flagship Rainbow agent's learner update in plain float32 ``torch``.

A reference for the port's DQN trainer (``train/dqn.py`` with the Nature
trunk, the dueling C51 head, noisy layers, 3-step returns and PER on the obs
ring), written from the papers and the port's documented conventions. It
imports nothing of the port, of the benchmark or of JAX; its file is copied
byte for byte to ``perfbench/reference_torch/rainbow.py``.

- Trunk (Mnih et al., 2015): conv 32x8/4, 64x4/2, 64x3/1, each with a relu,
  then dense 512 and a relu, on 84 x 84 frames with the stack of 4 on the
  channel axis, pixels scaled by 1/255.
- Factorised-Gaussian noisy layers (Fortunato et al., 2018) for every dense
  layer: ``W = mu_W + sigma_W * f(eps_out) f(eps_in)^T``, ``b = mu_b +
  sigma_b * f(eps_out)``, ``f(x) = sign(x) sqrt(|x|)``; without a noise key,
  the mean weights.
- Dueling (Wang et al., 2016) per atom under C51 (Bellemare et al., 2017):
  ``logits[a, z] = V[z] + A[a, z] - mean_a A[a, z]``; a softmax over the 51
  atoms of a fixed support on ``[v_min, v_max]``.
- n-step returns folded from the raw per-step rewards and dones of the ring,
  truncated at the first done: ``R = sum_i gamma^i prod_{j<i} (1 - d_j)
  r_i``, discount ``gamma^n prod_j (1 - d_j)``.
- Double DQN (van Hasselt et al., 2016): the online network picks the next
  action, the target network's distribution of it is the target.
- The categorical projection of ``R + discount * z`` onto the support
  (Bellemare et al., Algorithm 1), the IS-weighted cross-entropy (Schaul et
  al., 2016), new priorities ``(|ce| + eps)^alpha``, IS weights ``(N
  P(i))^-beta`` over their largest.
- The gradients by autograd, clipped to a global norm, and Adam (Kingma and
  Ba, 2015; eps outside the square root, bias-corrected).

Departures, each the port's documented convention rather than the papers':

- The flatten after the last conv is in NHWC order (height, width,
  channel), as the port's ``NatureDQN`` flattens; weights are [out, in],
  convs OIHW; parameters keep the port's names.
- The noise comes from the reference's own threefry-2x32 with jax.random's
  conventions, as the port draws it: the forward's key is
  ``fold_in(key, first 4 bytes of sha1(module path + counter 1))``, split
  in two for ``eps_in`` and ``eps_out``; a standard normal is ``sqrt(2)
  erfinv(u)`` for u uniform in (-1, 1) from 23 random mantissa bits.
  ``torch.erfinv`` is not XLA's polynomial (up to some 80 ulp apart).
  The learner's three forwards draw from the three keys of a split of its
  noise key in three: online on s, target on s', online on s' (selection).
- The support is ``torch.linspace`` in float32 (the port's sits an ulp or
  two off at some points).
- Everything is float32: the port's bf16 rounding points (each layer's
  operands and outputs) are not emulated; the tolerances of a comparison
  cover them. TF32 is off while the reference runs.
- The double-DQN action may be given (``a_star``): the action the program
  took. With random weights the Q-values of two actions can lie within
  rounding of each other, so the comparison checks the program's choice
  against the reference's Q-values (``q_next``) instead of copying the
  argmax.

``dtype`` computes the network in that dtype, on the device's own kernels:
every operand (the scaled input, each layer's weight and bias, the noisy
ones after the noise) cast to it, the logits cast back to float32, the
gradients through the casts. In bfloat16, the configuration's precision,
its distance from the float32 update is how far rounding alone moves this
batch's update (the comparison's yardstick).

Controls, which a comparison must reject: ``act_round`` rounds every
operand and every output (each layer's, the logits) to a dtype below
bfloat16 in the forward, and every gradient through them in the backward,
without loss scaling (float8, which no convolution computes in); ``shift``
moves the projected target by that many atoms; ``dueling_mean=False``
leaves the advantage's mean in the logits.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

NOISY = (("dense",), ("C51Head_0", "value"), ("C51Head_0", "advantage"))
_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


# --- threefry-2x32 -----------------------------------------------------------


def _hash(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) of counters (x0, x1) under the key (k0,
    k1); counters int64 tensors holding values below 2**32."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _key(key) -> tuple:
    """Two words of key data (ints, or a tensor of two int32) as uint32."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    return int(key[0]) & _M32, int(key[1]) & _M32


def split(key, n: int = 2) -> list:
    """Key i of an n-way split is the hash of the counter (0, i)."""
    k0, k1 = _key(key)
    ctr = torch.arange(n, dtype=torch.int64)
    y0, y1 = _hash(k0, k1, torch.zeros_like(ctr), ctr)
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def fold_in(key, data: int) -> tuple:
    k0, k1 = _key(key)
    d = torch.tensor([data & _M32], dtype=torch.int64)
    y0, y1 = _hash(k0, k1, torch.zeros_like(d), d)
    return int(y0[0]), int(y1[0])


def layer_key(key, path) -> tuple:
    """A noisy layer's key: the first 4 bytes (big-endian) of the SHA-1 of
    its path's names and the counter 1, folded into the forward's key."""
    h = hashlib.sha1()
    for name in path:
        h.update(name.encode())
    h.update(b"\x01")
    return fold_in(key, int.from_bytes(h.digest()[:4], "big"))


def normal(key, n: int, device) -> torch.Tensor:
    """n standard normals, float32: ``sqrt(2) erfinv(u)``, u in (-1, 1)."""
    k0, k1 = _key(key)
    ctr = torch.arange(n, dtype=torch.int64)
    y0, y1 = _hash(k0, k1, torch.zeros_like(ctr), ctr)
    bits = (((y0 ^ y1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
    u = torch.maximum(lo, (bits - 1.0) * (1.0 - lo) + lo)
    return (math.sqrt(2.0) * torch.erfinv(u)).to(device)


# --- the network -------------------------------------------------------------


class _RoundThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def _act(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype is None else _RoundThrough.apply(x, dtype)


def _f(e: torch.Tensor) -> torch.Tensor:
    return torch.sign(e) * torch.sqrt(e.abs())


def noisy_weights(params: dict, path, key):
    """(W, b) of the noisy layer ``path`` under the forward's noise key (the
    mean weights without one)."""
    pre = ".".join(path)
    mu_w, mu_b = params[pre + ".weight_mu"], params[pre + ".bias_mu"]
    if key is None:
        return mu_w, mu_b
    out_f, in_f = mu_w.shape
    ki, ko = split(layer_key(key, path))
    e_in = _f(normal(ki, in_f, mu_w.device))
    e_out = _f(normal(ko, out_f, mu_w.device))
    w = mu_w + params[pre + ".weight_sigma"] * torch.outer(e_out, e_in)
    return w, mu_b + params[pre + ".bias_sigma"] * e_out


def forward(params: dict, obs: torch.Tensor, key=None, *, num_atoms: int = 51,
            dtype=torch.float32, act_round=None,
            dueling_mean: bool = True) -> torch.Tensor:
    """C51 logits [N, A, Z] of uint8 observations [N, 84, 84, stack], float32,
    computed in ``dtype``; ``act_round`` and ``dueling_mean=False`` are
    controls."""
    r = lambda t: _act(t.to(dtype), act_round)
    x = r(obs.to(dtype).permute(0, 3, 1, 2) / 255.0)
    for name, stride in (("conv1", 4), ("conv2", 2), ("conv3", 1)):
        x = F.conv2d(x, r(params[name + ".weight"]), stride=stride)
        x = F.relu(r(r(x) + r(params[name + ".bias"][:, None, None])))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def dense(x, path):
        w, b = noisy_weights(params, path, key)
        return x @ r(w).T + r(b)
    x = F.relu(r(dense(x, NOISY[0])))
    v = r(dense(x, NOISY[1]))
    a = r(dense(x, NOISY[2])).reshape(x.shape[0], -1, num_atoms)
    if dueling_mean:
        a = a - a.mean(dim=1, keepdim=True)
    return r(v[:, None, :] + a).float()


# --- replay ------------------------------------------------------------------


def stacks(rows: torch.Tensor, size: int = 84, stack: int = 4) -> torch.Tensor:
    """Obs-ring rows (uint8 [N, size * size * stack], the stack on the last
    axis) as observations [N, size, size, stack]."""
    return rows.reshape(rows.shape[0], size, size, stack)


def fold_nstep(rewards: torch.Tensor, dones: torch.Tensor, gamma: float):
    """(return, discount) [N] from the raw rewards and dones [N, n] of a
    slot and its n - 1 successors, truncated at the first done."""
    alive = torch.ones_like(rewards[:, 0])
    ret = torch.zeros_like(rewards[:, 0])
    for i in range(rewards.shape[1]):
        ret = ret + gamma ** i * alive * rewards[:, i]
        alive = alive * (1.0 - dones[:, i].float())
    return ret, gamma ** rewards.shape[1] * alive


def is_weights(priority: torch.Tensor, valid: torch.Tensor,
               index: torch.Tensor, beta: float) -> torch.Tensor:
    """Importance weights ``(N P(i))^-beta`` over their largest, of the
    flat indices ``index`` into the priority grid; ``valid`` [same shape]
    marks the N sampleable cells."""
    p = torch.where(valid, priority, 0.0).reshape(-1)
    prob = p / p.sum()
    n = valid.sum().float()
    w = (n * prob[index]) ** -beta
    w_max = (n * prob[p > 0].min()) ** -beta
    return w / w_max


def new_priorities(ce: torch.Tensor, alpha: float, eps: float) -> torch.Tensor:
    return (ce.abs() + eps) ** alpha


def support(v_min: float, v_max: float, num_atoms: int,
            device) -> torch.Tensor:
    return torch.linspace(v_min, v_max, num_atoms, dtype=torch.float32,
                          device=device)


def project(probs: torch.Tensor, tz: torch.Tensor, v_min: float, v_max: float,
            shift: int = 0) -> torch.Tensor:
    """Each atom's mass of ``probs`` [N, Z] at ``tz`` [N, Z], clipped to the
    support, split between its two neighbours by distance."""
    z = probs.shape[1]
    b = (tz.clamp(v_min, v_max) - v_min) / ((v_max - v_min) / (z - 1))
    lo = b.floor().long()
    hi = b.ceil().long()
    m = torch.zeros_like(probs)
    m.scatter_add_(1, lo, probs * (hi.float() - b))
    m.scatter_add_(1, hi, probs * (b - lo.float()))
    m.scatter_add_(1, lo, probs * (lo == hi).float())
    return torch.roll(m, shift, dims=1) if shift else m


# --- the update --------------------------------------------------------------


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.clamp(max_norm / norm, max=1.0)
    return {k: g * scale for k, g in grads.items()}


def adam(params: dict, grads: dict, mu: dict, nu: dict, count: int, lr: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step from the step count ``count`` before it: (params, mu,
    nu) after."""
    t = count + 1
    out_p, out_m, out_v = {}, {}, {}
    for k, g in grads.items():
        m = b1 * mu[k] + (1 - b1) * g
        v = b2 * nu[k] + (1 - b2) * g * g
        step = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
        out_p[k], out_m[k], out_v[k] = params[k] - lr * step, m, v
    return out_p, out_m, out_v


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for cuBLAS and cuDNN in the block, as it was after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def learner_update(params: dict, target: dict, mu: dict, nu: dict, count: int,
                   rows: torch.Tensor, next_rows: torch.Tensor,
                   actions: torch.Tensor, rewards: torch.Tensor,
                   dones: torch.Tensor, weights: torch.Tensor, noise_key,
                   hp: dict, a_star: Optional[torch.Tensor] = None,
                   dtype=torch.float32, act_round=None, shift: int = 0,
                   dueling_mean: bool = True) -> dict:
    """One learner update of a sampled batch from its raw obs-ring rows:
    ``rows`` / ``next_rows`` uint8 [N, F] at each slot and n slots on,
    ``actions`` [N], ``rewards`` and ``dones`` [N, n] of the slot and its
    successors, IS ``weights`` [N], the learner's ``noise_key``; ``hp``:
    gamma, v_min, v_max, num_atoms, frame_size, frame_stack, max_grad_norm,
    lr, per_alpha, per_eps. Returns logits [N, A, Z] (online, on s), q_next
    [N, A] (online, on s'), a_star, ce [N], loss, priorities [N], grads
    (clipped), params, mu and nu after Adam."""
    k_online, k_target, k_select = split(noise_key, 3)
    z = hp["num_atoms"]
    with float32_matmuls():
        sup = support(hp["v_min"], hp["v_max"], z, rows.device)
        obs = stacks(rows, hp["frame_size"], hp["frame_stack"])
        nxt = stacks(next_rows, hp["frame_size"], hp["frame_stack"])
        ret, disc = fold_nstep(rewards.float(), dones, hp["gamma"])
        p = {k: v.detach().float().requires_grad_() for k, v in params.items()}
        net = lambda ps, x, k: forward(ps, x, k, num_atoms=z, dtype=dtype,
                                       act_round=act_round,
                                       dueling_mean=dueling_mean)
        logits = net(p, obs, k_online)
        logp = F.log_softmax(logits, dim=-1)[torch.arange(len(actions)),
                                             actions.long()]
        with torch.no_grad():
            q_next = (F.softmax(net(p, nxt, k_select), -1) * sup).sum(-1)
            if a_star is None:
                a_star = q_next.argmax(dim=1)
            p_next = F.softmax(net(target, nxt, k_target), -1)[
                torch.arange(len(a_star)), a_star.long()]
            tz = ret[:, None] + disc[:, None] * sup
            m = project(p_next, tz, hp["v_min"], hp["v_max"], shift)
        ce = -(m * logp).sum(-1)
        loss = (ce * weights).mean()
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        grads = clip_by_global_norm(grads, hp["max_grad_norm"])
        new_p, new_m, new_v = adam(params, grads, mu, nu, count, hp["lr"])
    return dict(logits=logits.detach(), q_next=q_next, a_star=a_star,
                ce=ce.detach(), loss=loss.detach(),
                priorities=new_priorities(ce.detach(), hp["per_alpha"],
                                          hp["per_eps"]),
                grads=grads, params=new_p, mu=new_m, nu=new_v)
