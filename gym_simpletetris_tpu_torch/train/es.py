"""Evolution strategies (Salimans et al. 2017, OpenAI-ES) on a torch device:
port of ``gym_simpletetris_tpu.train.es``.

One generation draws ``pop_size // 2`` Gaussian perturbations of the flat
mean parameters ``theta`` and their negatives (antithetic pairs), rolls every
member greedily through its own ``envs_per_member`` envs of one batched env
(on CUDA one launch of the step kernel a step, and for images one of the
raster kernel: ``api/env.step_fn``), and moves theta along the rank-shaped
score gradient

    g = 1 / (pop * sigma) * sum_i shape(F_i) * eps_i,

with an L2 pull toward 0. There is no backward pass and no replay.

``theta`` is flattened as ``jax.flatten_util.ravel_pytree`` flattens the
flax parameters: the modules in sorted order (``dense0``, ``dense1``, ...,
``q``), ``bias`` before ``kernel`` in each, a Dense kernel [in, out] and a
Conv kernel HWIO, row-major. The port's layers hold [out, in] and OIHW
weights; ``unravel`` / ``ravel`` convert, so a JAX theta as a numpy array
goes straight into the port. The members' forwards are one
``torch.func.vmap`` over ``functional_call``: a batched matmul per layer
(a grouped convolution for images), each member's product of bf16-rounded
operands summed in float32 and rounded once, as the unbatched network does.

Spans (``utils/profiling.py``, recorded under a torch profiler):
``es.perturb`` (the draw of eps and the members' parameters),
``es.rollout`` (the env reset and the horizon loop), ``es.forward`` (each
step's ``member_forward``) and ``es.update`` (fitness, ranks,
``es_update``); counters ``es.generations``, ``es.member_forwards``
(members' networks evaluated, each on its ``envs_per_member`` envs) and
``es.noise_elements`` (normals drawn). A generation never waits for the
card, so the host runs ahead of the device and a span's host interval is
not the device time of its work.

The key stream is split as in the JAX trainer and the perturbations are
``jax.random.normal``'s bit for bit (``core/threefry``), so from the same
theta and key a generation draws the same eps and, where the forwards agree,
plays the same games. The elementwise steps follow XLA's CPU arithmetic
(read from its optimised HLO): ``theta + sigma * eps`` is one fused
multiply-add, a division by a constant is a product with its float32
reciprocal, the dot ``shaped @ eps`` accumulates one fused multiply-add per
member in index order, and the update folds lr into the reciprocal and fuses
the decay's product into the sum. A fresh init draws
from a ``torch.Generator`` seeded by the init key, so theta0 differs from
the JAX package's for the same seed.

Data parallelism (``make_es(cfg, mesh=...)``, one process per card): the
env batch, and with it the population, is split over the data axis; each
rank rolls its members through its envs (its envs' share of the draws),
the perturbations are drawn replicated, and the fitness vector is
all-gathered, so the update runs replicated in the unsharded index order
and theta is the unsharded run's bit for bit. On a 2-D (``data``,
``model``) mesh theta stays replicated, as JAX pins it: the population
splits over ``data`` and the model ranks at one data index play the same
members.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import functional_call, vmap

from ..api import spaces
from ..api.env import check_device, reset_fn, step_fn
from ..core import threefry
from ..core.config import EnvConfig
from ..core.state import _key_tensor
from ..models.actor_critic import _FLAX_LEAVES
from ..models.dqn import RamDQN, build_q_network
from ..utils.profiling import count, span
from .ppo import _seed_of
from .replay import _sum_f32
from .sharding import DataParallel


@dataclasses.dataclass(frozen=True)
class ESConfig:
    env: EnvConfig = EnvConfig(obs_type="ram", auto_reset=True,
                               reward_step=True, penalise_holes=True)
    pop_size: int = 256          # perturbed members per generation (even)
    envs_per_member: int = 4     # fitness = mean return over this many envs
    horizon: int = 256           # env steps per evaluation
    sigma: float = 0.05          # perturbation scale
    lr: float = 0.02
    weight_decay: float = 0.005  # L2 pull toward 0
    rank_shaping: bool = True    # centered ranks instead of raw returns
    hidden: tuple = (64, 64)     # policy MLP widths (ram observations)

    def __post_init__(self):
        if self.pop_size % 2:
            raise ValueError("pop_size must be even (antithetic pairs)")
        if not self.env.auto_reset:
            raise ValueError("ES training requires env auto_reset=True")


@dataclasses.dataclass
class ESState:
    theta: torch.Tensor        # float32[dim], the flat mean parameters
    key: torch.Tensor          # int32[2] threefry key data
    generation: torch.Tensor   # int32[]

    def replace(self, **kw) -> "ESState":
        return dataclasses.replace(self, **kw)


def _f32_recip(c) -> float:
    """The float32 reciprocal of the float32 constant ``c``, as XLA folds a
    division by a constant into a product."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.tensor(c, dtype=torch.float32))


def centered_ranks(f: torch.Tensor) -> torch.Tensor:
    """Fitness values -> centered ranks in [-0.5, 0.5], ties broken by
    position (a stable argsort of a stable argsort, as ``jnp.argsort``)."""
    n = f.shape[0]
    ranks = torch.argsort(torch.argsort(f, stable=True), stable=True)
    return threefry._fma(ranks.float(), _f32_recip(n - 1), -0.5)


def _mean_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` over the last axis: XLA's summation order, times the
    reciprocal of the count."""
    return _sum_f32(x) * _f32_recip(x.shape[-1])


def _std_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.std`` (no correction) in XLA's order."""
    c = x - _mean_f32(x)[..., None]
    return threefry.sqrt_f32(_mean_f32(c * c))


def _vecmat_f32(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """float32 ``v @ m`` (v [n], m [n, d]) in XLA's CPU order: one fused
    multiply-add per row of m, accumulated in index order."""
    acc = torch.zeros(m.shape[1], dtype=torch.float32, device=m.device)
    for i in range(m.shape[0]):
        acc = threefry._fma(v[i], m[i], acc)
    return acc


def es_update(theta: torch.Tensor, eps: torch.Tensor, fitness: torch.Tensor,
              *, sigma: float, lr: float, weight_decay: float,
              rank_shaping: bool = True):
    """One ES step: theta [dim], eps [pop, dim], fitness [pop] -> (theta',
    grad), grad = shape(F) @ eps / (pop * sigma), theta' = (1 - lr * wd) *
    theta + lr * grad."""
    pop = eps.shape[0]
    if rank_shaping:
        shaped = centered_ranks(fitness)
    else:
        shaped = (fitness - _mean_f32(fitness)) / (_std_f32(fitness) + 1e-8)
    dot = _vecmat_f32(shaped, eps)
    inv = _f32_recip(pop * sigma)
    grad = dot * inv
    # XLA folds lr into the reciprocal and fuses the decay's product into
    # the sum
    lr_inv = float(torch.tensor(lr, dtype=torch.float32) * inv)
    return threefry._fma(theta, 1.0 - lr * weight_decay, dot * lr_inv), grad


def make_ravel(network: torch.nn.Module):
    """(ravel, unravel, dim) for ``network``: ``ravel(params) -> theta``
    and ``unravel(theta) -> params`` in ``ravel_pytree``'s order; unravel
    keeps any leading axes of theta (one per member)."""
    to_flax_leaf = {port: flax for flax, (port, _) in _FLAX_LEAVES.items()}
    entries = []
    for name, v in network.state_dict().items():
        *mods, leaf = name.split(".")
        shape = tuple(v.shape)
        if v.dim() == 2:
            shape = shape[::-1]                                # [in, out]
        elif v.dim() == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])   # HWIO
        entries.append((tuple(mods) + (to_flax_leaf[leaf],), name, shape))
    # ravel_pytree's order: the flax paths sorted
    order = [(name, shape) for _, name, shape in sorted(entries)]
    sizes = [math.prod(shape) for _, shape in order]

    def to_flax(a: torch.Tensor) -> torch.Tensor:
        if a.dim() == 2:
            return a.T
        return a.permute(2, 3, 1, 0) if a.dim() == 4 else a

    def ravel(params: dict) -> torch.Tensor:
        return torch.cat([to_flax(params[name]).reshape(-1)
                          for name, _ in order])

    def unravel(theta: torch.Tensor) -> dict:
        lead = theta.shape[:-1]
        out = {}
        for (name, shape), part in zip(order, theta.split(sizes, dim=-1)):
            a = part.reshape(lead + shape)
            L = len(lead)
            if len(shape) == 2:
                a = a.transpose(-1, -2)
            elif len(shape) == 4:                          # HWIO -> OIHW
                a = a.permute(*range(L), L + 3, L + 2, L, L + 1)
            out[name] = a.contiguous()
        return out

    return ravel, unravel, sum(sizes)


def _build_policy(cfg: ESConfig):
    """(network, ravel, unravel, obs_shape, dim) of the ES policy: RamDQN
    with ``cfg.hidden`` for ram, NatureDQN for images."""
    ecfg = cfg.env
    obs_shape = spaces.observation_space(ecfg).shape
    if ecfg.obs_type == "ram":
        network = RamDQN(obs_shape, hidden=tuple(cfg.hidden))
    else:
        network = build_q_network(ecfg.obs_type, obs_shape)
    ravel, unravel, dim = make_ravel(network)
    return network, ravel, unravel, obs_shape, dim


def make_es(cfg: ESConfig, device="cuda", mesh=None):
    """Returns (init_fn, gen_step_fn, network) on ``device`` ("cpu" or
    "cuda"; a CUDA request without a card raises).

    init_fn(key) -> ESState                 # key: int seed or 2 key words
    gen_step_fn(state) -> (state, metrics)  # one generation

    ``gen_step_fn.ravel`` / ``.unravel`` carry theta to and from the
    network's state_dict; ``.member_forward(params, obs)`` is the members'
    forward: params with a leading population axis (``unravel`` of
    [pop, dim]), obs [pop, k_env, ...] -> Q-values [pop, k_env, A]. With
    ``mesh`` (a ``DeviceMesh`` with a ``data`` axis, and any other) each
    rank plays its data index's block of the population (module
    docstring)."""
    device = check_device(device)
    ecfg = cfg.env
    network, ravel, unravel, obs_shape, dim = _build_policy(cfg)
    network.to(device)
    pop, k_env = cfg.pop_size, cfg.envs_per_member
    dp = DataParallel(mesh, device, pop)
    m0, n_mem = dp.offset, dp.b          # the rank's members

    def init_fn(key) -> ESState:
        k_net, k_state = threefry.split(_key_tensor(key, device))
        net = _build_policy(cfg)[0]      # drawn on the CPU, as DQN's init
        net.reset_parameters(torch.Generator().manual_seed(_seed_of(k_net)))
        params = {n: v.detach().to(device)
                  for n, v in net.state_dict().items()}
        return ESState(theta=ravel(params), key=k_state,
                       generation=torch.zeros((), dtype=torch.int32,
                                              device=device))

    # members' params [pop, ...], obs [pop, k_env, ...] -> Q [pop, k_env, A]
    member_forward = vmap(lambda p, o: functional_call(network, p, (o,)))

    @torch.no_grad()
    def gen_step_fn(state: ESState):
        count("es.generations")
        k_eps, k_reset, key = threefry.split(state.key, 3)
        with span("es.perturb"):
            eps_half = threefry.normal(k_eps, (pop // 2, dim))
            count("es.noise_elements", eps_half.numel())
            eps = torch.cat([eps_half, -eps_half])             # [pop, dim]
            members = unravel(threefry._fma(eps[m0:m0 + n_mem], cfg.sigma,
                                            state.theta[None]))
        with span("es.rollout"):
            obs, env_state = reset_fn(ecfg, n_mem * k_env, k_reset,
                                      device=device, env_offset=m0 * k_env)
            ret = torch.zeros(n_mem * k_env, dtype=torch.float32,
                              device=device)
            for _ in range(cfg.horizon):
                with span("es.forward"):
                    count("es.member_forwards", n_mem)
                    q = member_forward(members, obs.reshape(
                        (n_mem, k_env) + obs.shape[1:]))
                a = torch.argmax(q, dim=-1).to(torch.int32)
                obs, env_state, reward, _, _ = step_fn(ecfg, env_state,
                                                       a.reshape(-1))
                ret = ret + reward
        with span("es.update"):
            fitness = dp.gather(_sum_f32(ret.reshape(n_mem, k_env))
                                * _f32_recip(k_env), 0)
            theta, grad = es_update(state.theta, eps, fitness,
                                    sigma=cfg.sigma, lr=cfg.lr,
                                    weight_decay=cfg.weight_decay,
                                    rank_shaping=cfg.rank_shaping)
            norm = lambda x: threefry.sqrt_f32(_sum_f32(x * x))
            metrics = {"fitness_mean": _mean_f32(fitness),
                       "fitness_max": fitness.max(),
                       "fitness_std": _std_f32(fitness),
                       "theta_norm": norm(theta), "grad_norm": norm(grad)}
        return ESState(theta=theta, key=key,
                       generation=state.generation + 1), metrics

    gen_step_fn.ravel, gen_step_fn.unravel = ravel, unravel
    gen_step_fn.member_forward = member_forward
    return init_fn, gen_step_fn, network


def train(cfg: ESConfig, generations: int, key=0, log_fn=print,
          device="cuda") -> ESState:
    """The host loop: ``generations`` generations, metrics logged after
    each."""
    init_fn, gen_fn, _ = make_es(cfg, device)
    state = init_fn(key)
    for g in range(generations):
        state, metrics = gen_fn(state)
        if log_fn is not None:
            host = {k: float(v) for k, v in metrics.items()}
            host["generation"] = g + 1
            host["env_steps"] = ((g + 1) * cfg.pop_size * cfg.envs_per_member
                                 * cfg.horizon)
            log_fn(host)
    return state


def greedy_params(cfg: ESConfig, theta) -> dict:
    """A flat mean-parameter vector (``ESState.theta``, or a JAX theta as a
    numpy array) -> the policy network's state_dict."""
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().float().cpu()
    else:
        theta = torch.tensor(np.asarray(theta, dtype=np.float32))
    return _build_policy(cfg)[2](theta)
