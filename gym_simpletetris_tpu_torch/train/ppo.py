"""PPO actor-learner on a torch device (port of
``gym_simpletetris_tpu.train.ppo``).

One update collects a T-step on-policy rollout from the batched env, computes
GAE advantages and runs epochs of shuffled minibatches of the clipped
objective on the shared actor-critic. The JAX ``lax.scan`` loops are Python
loops. On CUDA every collected step is one launch of the step kernel, and
image observations one launch of the raster kernel (``api/env.step_fn``);
the network, the loss and the optimizer are plain PyTorch (cuBLAS / cuDNN on
the card), as the JAX learner is plain XLA.

The random draws (per-step action keys, epoch permutations) are
``jax.random``'s bit for bit (``core/threefry.py``), the optimizer is optax's
``clip_by_global_norm`` then ``adam`` written out, and the parameters are a
dict of tensors that ``torch.func.functional_call`` applies: the state is
explicit, as in the JAX trainer, so a checkpoint of it resumes exactly.

Data parallelism (``make_ppo(cfg, mesh=...)``, one process per card): each
rank collects on its block of the envs, drawing its envs' share of the
action draws, and computes its GAE alone. The epoch permutation runs over
the global ``T * B`` rows (or blocks) with the replicated key; each rank
takes the rows of a minibatch that it owns. The advantage mean and spread
are global (an ``all_reduce`` of the mean's parts, then one of the squared
deviations' mean), the loss terms are parts of means over the global
minibatch, and the gradients and loss metrics are summed by one
``all_reduce``; the collection metrics by one more at the end. At world 1
this is the unsharded trainer bit for bit.

Tensor parallelism (a 2-D (``data``, ``model``) mesh): the model ranks at
one data index collect on the same envs and hold the same rows; every
layer of the actor-critic whose width divides by the model axis holds its
block of output rows (``models.actor_critic.shard_layers``), so each
forward gathers and each backward sums over the model group, and the
parameters and Adam's moments are the rank's blocks. The global gradient
norm sums each block's squares over the model group (one ``all_reduce``)
and counts the whole tensors once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import functional_call

from ..api import spaces
from ..api.env import check_device, reset_fn, step_fn
from ..core import threefry
from ..core.config import EnvConfig
from ..core.state import EnvState, _key_tensor
from ..models.actor_critic import ActorCritic, shard_layers
from .sharding import MODEL_AXIS, DataParallel, sharded_weights

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    env: EnvConfig = EnvConfig(obs_type="ram", auto_reset=True,
                               reward_step=True, penalise_holes=True)
    num_envs: int = 1024
    rollout_len: int = 64
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    lr: float = 3e-4
    epochs: int = 2
    num_minibatches: int = 8
    max_grad_norm: float = 0.5
    reward_scale: float = 0.01  # tame the -100 death spikes for value learning
    shuffle_block: int = 1  # epoch-shuffle granularity: 1 = exact per-row
    # permutation; >1 permutes contiguous row BLOCKS instead. The flat
    # rollout is [T, B]-major, so a block of K <= num_envs rows is K
    # different envs at the same timestep.

    def __post_init__(self):
        if (self.num_envs * self.rollout_len) % self.num_minibatches:
            raise ValueError(
                "num_envs*rollout_len must be divisible by num_minibatches")
        n = self.num_envs * self.rollout_len
        if self.shuffle_block < 1 or n % self.shuffle_block:
            raise ValueError("shuffle_block must divide num_envs*rollout_len")
        if (n // self.num_minibatches) % self.shuffle_block:
            raise ValueError("shuffle_block must divide the minibatch size")
        if self.num_envs % self.shuffle_block:
            # blocks that straddle timestep boundaries would break the
            # same-timestep mixing the block shuffle rests on
            raise ValueError("shuffle_block must divide num_envs")


@dataclasses.dataclass
class PPOState:
    params: Dict[str, torch.Tensor]   # ActorCritic state_dict, float32
    opt_state: dict                   # {"count": int32[], "mu": {}, "nu": {}}
    env_state: EnvState
    obs: torch.Tensor
    key: torch.Tensor                 # int32[2] threefry key data
    update: torch.Tensor              # int32[]


def _seed_of(key: torch.Tensor) -> int:
    """A 64-bit generator seed from 2 words of key data."""
    w = key.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    return int(w[0]) << 32 | int(w[1])


def clip_by_global_norm(grads: dict, max_norm: float, model=None) -> dict:
    """optax's ``clip_by_global_norm``: ``g / g_norm * max_norm`` when the
    global norm reaches max_norm, else g unchanged (no epsilon). With
    ``model`` (a ``ModelShard``) the split weights' gradients are the
    rank's blocks: their squared sums are summed over the model group, the
    whole tensors' counted once."""
    sq = [torch.sum(g * g) for g in grads.values()]
    if model is not None:
        split = sharded_weights(grads, model.n)
        part = torch.stack([s if k in split else torch.zeros_like(s)
                            for k, s in zip(grads, sq)])
        dist.all_reduce(part, group=model.group)
        sq = [p if k in split else s
              for k, s, p in zip(grads, sq, part.unbind())]
    g_norm = torch.sqrt(sum(sq))
    keep = g_norm < max_norm
    return {k: torch.where(keep, g, (g / g_norm) * max_norm)
            for k, g in grads.items()}


def adam_update(grads: dict, opt_state: dict, lr: float):
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    bias-corrected) followed by the ``-lr`` scale: (updates, new state)."""
    count = opt_state["count"] + 1
    c = count.float()
    bc1 = 1 - torch.tensor(_ADAM_B1, device=c.device) ** c
    bc2 = 1 - torch.tensor(_ADAM_B2, device=c.device) ** c
    mu, nu, updates = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - _ADAM_B1) * g + _ADAM_B1 * opt_state["mu"][k]
        nu[k] = (1 - _ADAM_B2) * (g * g) + _ADAM_B2 * opt_state["nu"][k]
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + _ADAM_EPS)
        updates[k] = u * -lr
    return updates, {"count": count, "mu": mu, "nu": nu}


def make_ppo(cfg: PPOConfig, device="cuda", mesh=None,
             model_axis: str = MODEL_AXIS):
    """Returns (init_fn, update_fn, network) on ``device`` ("cpu" or
    "cuda"; a CUDA request without a card raises). ``init_fn(key)`` takes an
    int seed or 2 words of key data; ``update_fn(state)`` runs one full PPO
    iteration (rollout + GAE + epochs) and returns (state, metrics).
    ``update_fn.collect(state)`` and ``update_fn.learn(state, rollout)`` are
    its two halves, for timing them apart. With ``mesh`` (a ``DeviceMesh``
    with a ``data`` axis, and a ``model_axis`` for tensor parallelism), the
    rank's share of a sharded trainer (module docstring): its state holds
    its block of the envs and of the split weights, its metrics are
    global."""
    device = check_device(device)
    ecfg = cfg.env
    if not ecfg.auto_reset:
        raise ValueError("PPO requires env auto_reset=True")
    obs_shape = spaces.observation_space(ecfg).shape
    T, B = cfg.rollout_len, cfg.num_envs
    dp = DataParallel(mesh, device, B, model_axis=model_axis)
    network = ActorCritic(obs_shape, obs_type=ecfg.obs_type).to(device)
    shard_layers(network, dp.model)
    b = dp.b

    def apply(params, x):
        return functional_call(network, params, (x,))

    def init_fn(key) -> PPOState:
        k_env, k_net, k_state = threefry.split(_key_tensor(key, device), 3)
        obs, env_state = reset_fn(ecfg, b, k_env, device=device,
                                  env_offset=dp.offset)
        net = ActorCritic(obs_shape, obs_type=ecfg.obs_type)
        net.reset_parameters(torch.Generator().manual_seed(_seed_of(k_net)))
        params = dp.own(dp.broadcast({k: v.detach().to(device)
                                      for k, v in net.state_dict().items()}))
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        opt_state = {"count": torch.zeros((), dtype=torch.int32, device=device),
                     "mu": zeros(), "nu": zeros()}
        return PPOState(params=params, opt_state=opt_state,
                        env_state=env_state, obs=obs, key=k_state,
                        update=torch.zeros((), dtype=torch.int32,
                                           device=device))

    @torch.no_grad()
    def collect(state: PPOState):
        """T-step on-policy rollout: (env_state, obs, traj, last_value)."""
        keys = threefry.split(threefry.fold_in(state.key, state.update), T)
        env_state, obs = state.env_state, state.obs
        rows = torch.arange(b, device=device)
        steps = []
        for t in range(T):
            logits, value = apply(state.params, obs)
            action = threefry.categorical(keys[t], logits,
                                          dp.block).to(torch.int32)
            logp = F.log_softmax(logits, dim=-1)[rows, action]
            nobs, env_state, reward, done, info = step_fn(ecfg, env_state,
                                                          action)
            # flat uint8 observations: exact, the env's values fit the palette
            steps.append(dict(
                obs=obs.reshape(b, -1).to(torch.uint8), action=action,
                logp=logp, value=value, reward=reward * cfg.reward_scale,
                done=done.float(),
                # per-step line clears (taken before auto-reset): metrics only
                lines=info["lines_delta"].float()))
            obs = nobs
        traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        _, last_value = apply(state.params, obs)
        return env_state, obs, traj, last_value

    def gae(traj, last_value):
        adv_next, v_next = torch.zeros_like(last_value), last_value
        advs = [None] * T
        for t in reversed(range(T)):
            r, d, v = traj["reward"][t], traj["done"][t], traj["value"][t]
            delta = r + cfg.gamma * v_next * (1 - d) - v
            adv_next = delta + cfg.gamma * cfg.gae_lambda * (1 - d) * adv_next
            advs[t], v_next = adv_next, v
        advs = torch.stack(advs)
        return advs, advs + traj["value"]

    def loss_fn(params, batch, mb, own=None):
        """The clipped objective on the rank's rows of a minibatch of ``mb``
        global rows (``own``: which of them, under a mesh): every term the
        rank's part of its minibatch mean."""
        n = batch["obs"].shape[0]
        x = batch["obs"].float().reshape((n,) + obs_shape)  # exact u8 -> f32
        logits, value = apply(params, x)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["action"].long()[:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        # normalised over the minibatch, jnp.std's two passes; under a mesh
        # over the whole minibatch's advantages, assembled in its order
        adv = batch["adv"]
        if own is not None:
            adv = dp.assemble({"adv": adv.new_zeros(mb).index_put((own,), adv)},
                              own)["adv"]
        adv = adv - adv.mean()
        adv = adv / (torch.sqrt((adv * adv).mean()) + 1e-8)
        if own is not None:
            adv = adv[own]
        part = lambda v: dp.part_mean(v, mb)
        pg = -part(torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv))
        v_loss = 0.5 * part(torch.square(value - batch["ret"]))
        entropy = -part((torch.exp(logp_all) * logp_all).sum(dim=1))
        loss = pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
        clip_frac = part(((ratio - 1).abs() > cfg.clip_eps).float())
        return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy,
                      "clip_frac": clip_frac}

    def learn(state: PPOState, rollout):
        """GAE and the minibatch epochs on a collected rollout."""
        env_state, obs, traj, last_value = rollout
        advs, returns = gae(traj, last_value)
        n = T * B                       # the global rows, [T, B]-major
        flat = {"obs": traj["obs"].reshape(T * b, -1),
                "action": traj["action"].reshape(-1),
                "logp": traj["logp"].reshape(-1),
                "adv": advs.reshape(-1), "ret": returns.reshape(-1)}
        mb = n // cfg.num_minibatches
        blk = cfg.shuffle_block
        ekeys = threefry.split(
            threefry.fold_in(state.key, state.update + 7777), cfg.epochs)
        params, opt_state = state.params, state.opt_state
        auxs = []
        for key_e in ekeys:
            if blk > 1:
                perm = threefry.permutation(key_e, n // blk)
                perm = (perm[:, None] * blk + torch.arange(
                    blk, device=device)).reshape(-1)
            else:
                perm = threefry.permutation(key_e, n)
            for i in range(cfg.num_minibatches):
                rows, own = perm[i * mb:(i + 1) * mb], None
                if mesh is not None:        # the rank's rows, local index
                    t, e = rows // B, rows % B - dp.offset
                    own = (e >= 0) & (e < b)
                    rows = (t * b + e)[own]
                batch = {k: x[rows] for k, x in flat.items()}
                p = {k: v.detach().requires_grad_() for k, v in params.items()}
                with dp.forward_points() as points:
                    loss, aux = loss_fn(p, batch, mb, own)
                grads, aux = dp.grads(loss, p, points,
                                      {k: v.detach() for k, v in aux.items()})
                grads = clip_by_global_norm(grads, cfg.max_grad_norm,
                                            dp.model)
                updates, opt_state = adam_update(grads, opt_state, cfg.lr)
                params = {k: params[k] + updates[k] for k in params}
                auxs.append(aux)
        metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        metrics.update(dp.all_reduce({
            "mean_reward": dp.share_mean(traj["reward"]) / cfg.reward_scale,
            "episodes_done": traj["done"].sum(),
            "lines_cleared": traj["lines"].sum()}))
        new_state = PPOState(params=params, opt_state=opt_state,
                             env_state=env_state, obs=obs, key=state.key,
                             update=state.update + 1)
        # sorted, as the JAX trainer's metrics come out of jit
        return new_state, dict(sorted(metrics.items()))

    def update_fn(state: PPOState):
        return learn(state, collect(state))

    update_fn.collect, update_fn.learn = collect, learn
    return init_fn, update_fn, network
