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
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..api import spaces
from ..api.env import check_device, reset_fn, step_fn
from ..core import threefry
from ..core.config import EnvConfig
from ..core.state import EnvState, _key_tensor
from ..models.actor_critic import ActorCritic

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


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax's ``clip_by_global_norm``: ``g / g_norm * max_norm`` when the
    global norm reaches max_norm, else g unchanged (no epsilon)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
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


def make_ppo(cfg: PPOConfig, device):
    """Returns (init_fn, update_fn, network) on ``device`` ("cpu" or
    "cuda"; a CUDA request without a card raises). ``init_fn(key)`` takes an
    int seed or 2 words of key data; ``update_fn(state)`` runs one full PPO
    iteration (rollout + GAE + epochs) and returns (state, metrics).
    ``update_fn.collect(state)`` and ``update_fn.learn(state, rollout)`` are
    its two halves, for timing them apart."""
    device = check_device(device)
    ecfg = cfg.env
    if not ecfg.auto_reset:
        raise ValueError("PPO requires env auto_reset=True")
    obs_shape = spaces.observation_space(ecfg).shape
    network = ActorCritic(obs_shape, obs_type=ecfg.obs_type).to(device)
    T, B = cfg.rollout_len, cfg.num_envs

    def apply(params, x):
        return functional_call(network, params, (x,))

    def init_fn(key) -> PPOState:
        k_env, k_net, k_state = threefry.split(_key_tensor(key, device), 3)
        obs, env_state = reset_fn(ecfg, B, k_env, device=device)
        net = ActorCritic(obs_shape, obs_type=ecfg.obs_type)
        net.reset_parameters(torch.Generator().manual_seed(_seed_of(k_net)))
        params = {k: v.detach().to(device) for k, v in net.state_dict().items()}
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
        rows = torch.arange(B, device=device)
        steps = []
        for t in range(T):
            logits, value = apply(state.params, obs)
            action = threefry.categorical(keys[t], logits).to(torch.int32)
            logp = F.log_softmax(logits, dim=-1)[rows, action]
            nobs, env_state, reward, done, info = step_fn(ecfg, env_state,
                                                          action)
            # flat uint8 observations: exact, the env's values fit the palette
            steps.append(dict(
                obs=obs.reshape(B, -1).to(torch.uint8), action=action,
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

    def loss_fn(params, batch):
        n = batch["obs"].shape[0]
        x = batch["obs"].float().reshape((n,) + obs_shape)  # exact u8 -> f32
        logits, value = apply(params, x)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["action"].long()[:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
        v_loss = 0.5 * torch.square(value - batch["ret"]).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(dim=1).mean()
        loss = pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
        clip_frac = ((ratio - 1).abs() > cfg.clip_eps).float().mean()
        return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": entropy,
                      "clip_frac": clip_frac}

    def learn(state: PPOState, rollout):
        """GAE and the minibatch epochs on a collected rollout."""
        env_state, obs, traj, last_value = rollout
        advs, returns = gae(traj, last_value)
        n = T * B
        flat = {"obs": traj["obs"].reshape(n, -1),
                "action": traj["action"].reshape(n),
                "logp": traj["logp"].reshape(n),
                "adv": advs.reshape(n), "ret": returns.reshape(n)}
        mb = n // cfg.num_minibatches
        blk = cfg.shuffle_block
        ekeys = threefry.split(
            threefry.fold_in(state.key, state.update + 7777), cfg.epochs)
        params, opt_state = state.params, state.opt_state
        auxs = []
        for key_e in ekeys:
            if blk > 1:
                nb = n // blk
                perm = threefry.permutation(key_e, nb)
                shuf = {k: x.reshape((nb, blk) + x.shape[1:])[perm]
                        .reshape(x.shape) for k, x in flat.items()}
            else:
                perm = threefry.permutation(key_e, n)
                shuf = {k: x[perm] for k, x in flat.items()}
            for i in range(cfg.num_minibatches):
                batch = {k: x[i * mb:(i + 1) * mb] for k, x in shuf.items()}
                p = {k: v.detach().requires_grad_() for k, v in params.items()}
                loss, aux = loss_fn(p, batch)
                grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
                grads = clip_by_global_norm(grads, cfg.max_grad_norm)
                updates, opt_state = adam_update(grads, opt_state, cfg.lr)
                params = {k: params[k] + updates[k] for k in params}
                auxs.append({k: v.detach() for k, v in aux.items()})
        metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        metrics["mean_reward"] = traj["reward"].mean() / cfg.reward_scale
        metrics["episodes_done"] = traj["done"].sum()
        metrics["lines_cleared"] = traj["lines"].sum()
        new_state = PPOState(params=params, opt_state=opt_state,
                             env_state=env_state, obs=obs, key=state.key,
                             update=state.update + 1)
        # sorted, as the JAX trainer's metrics come out of jit
        return new_state, dict(sorted(metrics.items()))

    def update_fn(state: PPOState):
        return learn(state, collect(state))

    update_fn.collect, update_fn.learn = collect, learn
    return init_fn, update_fn, network
