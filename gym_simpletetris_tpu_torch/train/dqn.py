"""Rainbow DQN actor-learner on a torch device (port of
``gym_simpletetris_tpu.train.dqn``).

Double DQN, dueling heads, C51, NoisyNets, n-step returns and prioritized
replay, each switchable in ``DQNConfig``; epsilon is annealed linearly. One
actor step takes a batched env step with its observation (on CUDA one
launch of the step kernel, and for images one of the raster kernel:
``api/env.step_fn``) and inserts one slot row into the replay ring; one
learner step samples a batch, takes the TD (or C51) loss, its gradient and
an Adam step, and syncs the target every ``target_update_period`` learner
steps. The JAX ``lax.scan`` / ``lax.cond`` are a Python loop and a Python
branch: the warm-up gate and the target sync read host-side counters, so a
chunk reads the card once, at its start.

The key stream is split exactly as in the JAX trainer, and every draw is
``jax.random``'s (``core/threefry``): from the same init state and
parameters the actions, rewards, dones and replay rows are the JAX
trainer's bit for bit up to the first learner step. The learner's float
sums run in torch's order, so its loss and parameters agree to about 1e-6
(``tests/test_torch_dqn.py`` holds them to 1e-4). A fresh init draws the
parameters from a ``torch.Generator`` seeded by the init key (flax's
initialisers, not its draws).

Replay layouts (``train/replay.py``): the legacy ring stores matured
transitions (obs and next obs per slot, n-step returns from a rolling
window); ``frame_ring=True`` stores one row per actor step and folds the
n-step return when a batch is sampled, with no window: a single frame
(the actor reads its stack back out of the ring), or with ``ring_stacks``
the whole stack (the obs ring, the JAX package's flagship image layout).

Data parallelism (``make_train(cfg, mesh=...)``, a ``DeviceMesh`` with a
``data`` axis; one process per card): each rank owns a block of the envs
and their columns of the ring, its ``obs``, its n-step window and its env
state, and draws its envs' share of every per-env draw (``env_offset``), so
its actor and its inserts are the unsharded trainer's rows, with no
communication. Parameters, target and Adam state are replicated (broadcast
from rank 0 at init). A learner step draws the unsharded batch on every
rank alike (the PER grid all-gathered), each drawn row is gathered by the
rank owning its env column and the batch assembled by one ``all_reduce``;
each rank takes the gradient of its share of the rows (the loss scaled by
share / batch), and one ``all_reduce`` of one flat buffer sums the
gradients and the learner metrics. The PER write-back all-gathers the TD
errors and each rank writes its own columns. At world 1 the mesh trainer is
the unsharded one bit for bit; above it the gradient sum's order differs.

Tensor parallelism (a 2-D (``data``, ``model``) mesh): the env state, the
obs, the n-step window and the replay ring shard over ``data`` and
replicate over ``model`` (JAX's ``P(None, "data")``), so the model ranks at
one data index step the same envs and hold the same ring columns. Every
layer of the Q-network whose width divides by the model axis (the trunk's,
not the shipped heads') holds its block of output rows
(``models.actor_critic.shard_layers``): the actor's and the learner's
forwards gather the blocks, the backward sums the input gradients over the
model group, and params, target and Adam's moments hold the same blocks
(the target sync copies blocks). The gradient norm is global (``ppo``'s
``clip_by_global_norm``). The forward is the unsharded one's; the
backward's float32 sums run in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..api import spaces
from ..api.env import check_device, reset_fn, step_fn
from ..core import threefry
from ..core.config import EnvConfig
from ..core.engine import NUM_ACTIONS
from ..core.state import EnvState, _key_tensor
from ..models.actor_critic import shard_layers
from ..models.dqn import build_q_network
from ..utils.profiling import count, span
from .ppo import _seed_of, adam_update, clip_by_global_norm
from .sharding import MODEL_AXIS, DataParallel
from .replay import (FrameRingState, ReplayState, _recip_f32, _sum_f32,
                     frame_ring_init, frame_ring_insert_frame,
                     frame_ring_insert_step, frame_ring_stack_newest,
                     gather_rows, replay_init, replay_insert, sample_draw,
                     update_priority_block)

_LEARNER_KEYS = ("loss", "mean_q", "td_abs_err")


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    env: EnvConfig = EnvConfig(obs_type="ram", auto_reset=True,
                               reward_step=True, penalise_holes=True)
    num_envs: int = 1024
    buffer_capacity: int = 262144
    learn_batch: int = 1024
    gamma: float = 0.99
    lr: float = 3e-4
    target_update_period: int = 500    # learner steps between target syncs
    learn_starts: int = 4096           # transitions before learning begins
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 100_000
    double_dqn: bool = True
    dueling: bool = False
    max_grad_norm: float = 10.0
    frame_stack: int = 1   # > 1 stacks the last K obs on a trailing axis
    n_step: int = 1        # > 1: n-step returns, exactly truncated
    prioritized: bool = False
    per_alpha: float = 0.6
    per_beta0: float = 0.4
    per_beta_steps: int = 100_000
    per_eps: float = 1e-3
    distributional: bool = False   # C51 on a fixed support
    num_atoms: int = 51
    v_min: float = -110.0
    v_max: float = 110.0
    noisy: bool = False    # NoisyNet layers; no epsilon-greedy
    noisy_shared_selection: bool = False  # one online noise draw for the
                           # loss forward and the double-DQN selection
    learn_every: int = 1   # actor steps per learner update
    frame_ring: bool = False   # one row per step, n-step folded at sample time
    ring_stacks: bool = False  # with frame_ring: a row is the whole stack
    sample_slots: bool = False  # learner batches are whole slot rows

    def __post_init__(self):
        if self.buffer_capacity % self.num_envs:
            raise ValueError("buffer_capacity must be a multiple of num_envs")
        if self.learn_every < 1:
            raise ValueError("learn_every must be >= 1")
        if self.ring_stacks and not self.frame_ring:
            raise ValueError("ring_stacks requires frame_ring=True")
        if self.sample_slots:
            if self.learn_batch % self.num_envs:
                raise ValueError("sample_slots needs learn_batch to be a "
                                 "multiple of num_envs (whole slot rows)")
            if self.frame_ring and self.frame_stack > 1 and \
                    not self.ring_stacks:
                raise ValueError("sample_slots on the frame ring needs "
                                 "ring_stacks=True or frame_stack == 1 "
                                 "(per-env stack clamping would reintroduce "
                                 "the gathers it removes)")


@dataclasses.dataclass
class DQNState:
    params: Dict[str, torch.Tensor]         # Q-network state_dict, float32
    target_params: Dict[str, torch.Tensor]
    opt_state: dict                         # {"count", "mu", "nu"}
    replay: "ReplayState | FrameRingState"
    env_state: EnvState
    obs: torch.Tensor          # current observation (stack) [num_envs, ...];
                               # uint8 on the frame ring: the newest frame,
                               # or the stack on the obs ring
    key: torch.Tensor          # int32[2] threefry key data
    step: torch.Tensor         # int32[], actor steps taken
    learn_steps: torch.Tensor  # int32[]
    window: Optional[dict] = None   # n-step pending transitions [n-1, B, ...]

    def replace(self, **kw) -> "DQNState":
        return dataclasses.replace(self, **kw)


def support_f32(v_min: float, v_max: float, num_atoms: int,
                device="cuda") -> torch.Tensor:
    """The C51 support, ``jnp.linspace(v_min, v_max, num_atoms)``'s formula
    in float32: ``start * (1 - t) + stop * t`` for t = i / (n - 1), the last
    point ``stop``. About half the points sit an ulp or two from the JAX
    support's (XLA fuses it in an order not emulated here)."""
    div = num_atoms - 1
    t = torch.arange(div, dtype=torch.float32, device=device) / float(div)
    out = v_min * (1 - t) + v_max * t
    return torch.cat([out, out.new_tensor([v_max])])


def project_distribution(probs: torch.Tensor, tz: torch.Tensor, v_min: float,
                         v_max: float, num_atoms: int) -> torch.Tensor:
    """Project a categorical distribution onto the fixed support (C51):
    each Bellman-shifted atom ``tz`` [B, n] splits its mass ``probs``
    [B, n] linearly between its two support neighbours, as two one-hot
    expansions summed over the source atoms (no scatter), in XLA's order:
    bitwise equal to the JAX function on XLA's CPU backend."""
    dz = (v_max - v_min) / (num_atoms - 1)
    b = (torch.clamp(tz, v_min, v_max) - v_min) / dz
    low = torch.floor(b)
    up = torch.clamp(low + 1.0, max=num_atoms - 1.0)
    w_up = b - low
    low_oh = F.one_hot(low.long(), num_atoms).to(probs.dtype)
    up_oh = F.one_hot(up.long(), num_atoms).to(probs.dtype)
    mass = ((probs * (1.0 - w_up))[..., None] * low_oh
            + (probs * w_up)[..., None] * up_oh)        # [B, source, target]
    return _sum_f32(mass.transpose(1, 2))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) over its sum,
    summed in XLA's order."""
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return e / _sum_f32(e)[..., None]


def _select(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[b, index[b]]`` along axis 1 as a one-hot product and sum: exact,
    and its gradient is a product, not a scatter."""
    oh = F.one_hot(index.long(), x.shape[1]).to(x.dtype)
    if x.dim() == 3:
        oh = oh[..., None]
    return (x * oh).sum(dim=1)


def make_train(cfg: DQNConfig, device="cuda", mesh=None,
               model_axis: str = MODEL_AXIS):
    """Returns (init_fn, train_step_fn, train_chunk_fn, network) on
    ``device`` ("cpu" or "cuda"; a CUDA request without a card raises).
    With ``mesh`` (a ``DeviceMesh`` over the ranks with a ``data`` axis,
    and a ``model_axis`` for tensor parallelism), the rank's share of a
    sharded trainer (module docstring); its state holds the rank's blocks,
    its metrics are global.

    init_fn(key) -> DQNState                # key: int seed or 2 key words
    train_step_fn(state) -> (state, metrics)           # one actor+learner step
    train_chunk_fn(state, n) -> (state, metrics_mean)  # n actor steps

    ``train_chunk_fn.actor_half(state)`` and ``.learner_half(state,
    k_sample, k_nlearn)`` are its two halves, for timing them apart. The
    replay ring is written in place (``train/replay.py``).
    """
    device = check_device(device)
    ecfg = cfg.env
    if not ecfg.auto_reset:
        raise ValueError("DQN training requires env auto_reset=True")
    dp = DataParallel(mesh, device, cfg.num_envs, cfg.learn_batch,
                      model_axis=model_axis)
    base_shape = spaces.observation_space(ecfg).shape
    k = cfg.frame_stack
    obs_shape = base_shape + (k,) if k > 1 else base_shape
    atoms = cfg.num_atoms if cfg.distributional else 0
    build = lambda: build_q_network(ecfg.obs_type, obs_shape,
                                    dueling=cfg.dueling, num_atoms=atoms,
                                    noisy=cfg.noisy)
    network = build().to(device)
    shard_layers(network, dp.model)
    support = support_f32(cfg.v_min, cfg.v_max, cfg.num_atoms, device)
    B, b = cfg.num_envs, dp.b          # the global env batch, the rank's
    L = cfg.learn_batch
    slots = cfg.buffer_capacity // B
    blk = dp.block

    def apply_net(params, obs, nk=None):
        """Forward pass; a noisy network draws fresh noise from ``nk``."""
        return functional_call(network, params,
                               (obs, nk if cfg.noisy else None))

    def q_values(params, obs, nk=None):
        """Scalar Q [B, A]: the output, or E[Z] under the C51 head."""
        out = apply_net(params, obs, nk)
        if not cfg.distributional:
            return out
        return _sum_f32(_softmax(out) * support)

    def _stack_reset(obs):
        return obs[..., None].expand(obs.shape + (k,)).clone() if k > 1 \
            else obs

    def _stack_next(frames, obs, done):
        """Shift the stack; restart it from the reset obs where done."""
        if k == 1:
            return obs
        nxt = torch.cat([frames[..., 1:], obs[..., None]], dim=-1)
        d = done.reshape(done.shape + (1,) * (nxt.dim() - 1))
        return torch.where(d, _stack_reset(obs), nxt)

    def epsilon(step):
        # XLA divides by a constant as a product with its reciprocal
        frac = torch.clamp(step.float() * _recip_f32(cfg.eps_decay_steps),
                           0, 1)
        return threefry._fma(frac, cfg.eps_end - cfg.eps_start,
                             cfg.eps_start)

    def init_fn(key) -> DQNState:
        k_env, k_net, k_state = threefry.split(_key_tensor(key, device), 3)
        obs, env_state = reset_fn(ecfg, b, k_env, device=device,
                                  env_offset=dp.offset)
        net = build()
        net.reset_parameters(torch.Generator().manual_seed(_seed_of(k_net)))
        params = dp.own(dp.broadcast({n: v.detach().to(device)
                                      for n, v in net.state_dict().items()}))
        zeros = lambda: {n: torch.zeros_like(v) for n, v in params.items()}
        if cfg.frame_ring:
            # no window and no prefill: a slot matures once its n
            # successors exist
            replay = frame_ring_init(slots * b, base_shape, b, k,
                                     cfg.n_step, cfg.gamma,
                                     stacked=cfg.ring_stacks, device=device)
            obs = obs.to(torch.uint8)
            if cfg.ring_stacks:
                obs = _stack_reset(obs)
        else:
            replay = replay_init(slots * b, obs_shape, b, device)
            obs = _stack_reset(obs)
        state = DQNState(
            params=params, target_params=dict(params),
            opt_state={"count": torch.zeros((), dtype=torch.int32,
                                            device=device),
                       "mu": zeros(), "nu": zeros()},
            replay=replay, env_state=env_state, obs=obs, key=k_state,
            step=torch.zeros((), dtype=torch.int32, device=device),
            learn_steps=torch.zeros((), dtype=torch.int32, device=device))
        if cfg.n_step > 1 and not cfg.frame_ring:
            # prefill the window with n-1 random-policy transitions so that
            # every actor step matures exactly one insertable transition
            state = state.replace(window=_empty_window())
            for _ in range(cfg.n_step - 1):
                state = _prefill_step(state)
        return state

    def _empty_window():
        n1 = cfg.n_step - 1
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
        return {"obs": z((n1, b) + obs_shape, torch.uint8),
                "action": z((n1, b), torch.int8),
                "reward": z((n1, b), torch.float32),
                # True done marks the slots invalid until prefill fills them
                "done": torch.ones((n1, b), dtype=torch.bool, device=device)}

    @torch.no_grad()
    def _prefill_step(state: DQNState) -> DQNState:
        k_act, key = threefry.split(state.key)
        action = threefry.randint(k_act, (B,), 0, NUM_ACTIONS, blk)
        raw_next, env_state, reward, done, _ = step_fn(ecfg, state.env_state,
                                                       action)
        next_obs = _stack_next(state.obs, raw_next, done)
        window = _push_window(state.window, state.obs, action, reward, done)
        return state.replace(env_state=env_state, obs=next_obs, key=key,
                             window=window)

    def _push_window(window, obs, action, reward, done):
        """Drop the oldest pending transition, append the newest."""
        new = {"obs": obs.to(torch.uint8), "action": action.to(torch.int8),
               "reward": reward.float(), "done": done}
        return {n: torch.cat([window[n][1:], new[n][None]]) for n in window}

    def _mature_nstep(window, action_t, reward_t, done_t, next_obs_t):
        """The window and the current transition folded into the matured
        n-step transition (obs_0, a_0, R_n, next_obs_t, discount,
        done_any), truncated exactly at the first episode end."""
        rew_seq = torch.cat([window["reward"], reward_t.float()[None]])
        done_seq = torch.cat([window["done"], done_t[None]])
        alive = torch.ones_like(rew_seq[0])
        ret = torch.zeros_like(rew_seq[0])
        for j in range(cfg.n_step):
            # one fused multiply-add, as XLA's CPU backend contracts it
            ret = threefry._fma((cfg.gamma ** j) * alive, rew_seq[j], ret)
            alive = alive * (1.0 - done_seq[j].float())
        discount = (cfg.gamma ** cfg.n_step) * alive
        return (window["obs"][0], window["action"][0], ret, next_obs_t,
                discount, done_seq.any(dim=0))

    def td_loss(params, target_params, batch, weights, nkey):
        k1, k2, k3 = threefry.split(nkey, 3)
        if cfg.noisy_shared_selection:
            k3 = k1
        q = apply_net(params, batch["obs"], k1)                    # [B, A]
        q_sel = _select(q, batch["action"])
        with torch.no_grad():
            q_next_t = apply_net(target_params, batch["next_obs"], k2)
            if cfg.double_dqn:
                a_star = torch.argmax(
                    apply_net(params, batch["next_obs"], k3), dim=1)
                q_next = _select(q_next_t, a_star)
            else:
                q_next = q_next_t.max(dim=1).values
            target = batch["reward"] + batch["discount"] * q_next
        err = q_sel - target
        loss = torch.where(err.abs() <= 1.0, 0.5 * err * err,
                           err.abs() - 0.5)
        return dp.part_mean(loss * weights, L), (err, q_sel)

    def c51_loss(params, target_params, batch, weights, nkey):
        """Projected categorical cross-entropy; the per-sample
        cross-entropy is also the PER priority signal."""
        k1, k2, k3 = threefry.split(nkey, 3)
        if cfg.noisy_shared_selection:
            k3 = k1
        logits = apply_net(params, batch["obs"], k1)              # [B, A, n]
        logp_a = _select(F.log_softmax(logits, dim=-1), batch["action"])
        q_sel = (torch.exp(logp_a) * support).sum(dim=-1)
        with torch.no_grad():
            p_t = _softmax(apply_net(target_params, batch["next_obs"], k2))
            if cfg.double_dqn:
                a_star = torch.argmax(
                    q_values(params, batch["next_obs"], k3), dim=1)
            else:
                a_star = torch.argmax((p_t * support).sum(dim=-1), dim=1)
            p_next = _select(p_t, a_star)
            tz = batch["reward"][:, None] + batch["discount"][:, None] * support
            m = project_distribution(p_next, tz, cfg.v_min, cfg.v_max,
                                     cfg.num_atoms)
        ce = -(m * logp_a).sum(dim=-1)
        return dp.part_mean(ce * weights, L), (ce, q_sel)

    loss_fn = c51_loss if cfg.distributional else td_loss

    @span("dqn.actor")
    @torch.no_grad()
    def actor_half(state: DQNState):
        """One env interaction and replay insert: (state, (k_sample,
        k_nlearn, actor metrics))."""
        count("dqn.actor_steps")
        k_eps, k_act, k_sample, k_nact, k_nlearn, key = threefry.split(
            state.key, 6)
        cur_obs = state.obs
        if cfg.frame_ring:
            # this step's row (the frame, or the stack); on the single-frame
            # ring the actor reads its stack back out of the ring
            replay = frame_ring_insert_frame(state.replay, state.obs)
            if not cfg.ring_stacks:
                cur_obs = frame_ring_stack_newest(replay)
        q = q_values(state.params, cur_obs, k_nact)
        greedy = torch.argmax(q, dim=1).to(torch.int32)
        if cfg.noisy:
            # exploration by parameter noise; k_eps / k_act stay drawn so
            # the key stream is the eps-greedy variants'
            action, eps_metric = greedy, torch.zeros((), device=device)
        else:
            eps_metric = epsilon(state.step)
            rand_a = threefry.randint(k_act, (B,), 0, NUM_ACTIONS, blk)
            explore = threefry.uniform(k_eps, (B,), block=blk) < eps_metric
            action = torch.where(explore, rand_a, greedy)
        raw_next, env_state, reward, done, info = step_fn(
            ecfg, state.env_state, action)
        window = state.window
        if cfg.frame_ring:
            replay = frame_ring_insert_step(replay, action, reward, done)
            next_obs = raw_next.to(torch.uint8)
            if cfg.ring_stacks:
                next_obs = _stack_next(state.obs, next_obs, done)
        elif cfg.n_step > 1:
            next_obs = _stack_next(state.obs, raw_next, done)
            m_obs, m_act, m_ret, m_next, m_disc, m_done = _mature_nstep(
                state.window, action, reward, done, next_obs)
            replay = replay_insert(state.replay, m_obs, m_next, m_act, m_ret,
                                   m_done, discount=m_disc)
            window = _push_window(state.window, state.obs, action, reward,
                                  done)
        else:
            next_obs = _stack_next(state.obs, raw_next, done)
            replay = replay_insert(state.replay, state.obs, next_obs, action,
                                   reward, done, gamma=cfg.gamma)
        state = state.replace(replay=replay, env_state=env_state,
                              obs=next_obs, key=key, step=state.step + 1,
                              window=window)
        metrics = {"mean_reward": dp.share_mean(reward),
                   "episodes_done": done.sum().float(),
                   "lines_cleared": info["lines_delta"].sum().float(),
                   "epsilon": eps_metric}
        return state, (k_sample, k_nlearn, metrics)

    @span("replay.sample")
    def learner_batch(replay, k_sample, beta):
        """The learner batch over the global ring, drawn alike on every
        rank (the priority grid gathered); each drawn row gathered by the
        rank that owns its env column and assembled on every rank:
        (batch, weights, slot, env), each of L rows."""
        count("replay.rows_sampled", L)
        slot, env, weights = sample_draw(
            replay, k_sample, L, beta, prioritized=cfg.prioritized,
            slots=cfg.sample_slots, width=B,
            priority=dp.gather(replay.priority, 1) if cfg.prioritized
            else replay.priority)
        if mesh is None:
            batch = gather_rows(replay, slot, env)
        else:
            own = (env >= dp.offset) & (env < dp.offset + b)
            batch = dp.assemble(gather_rows(
                replay, slot, (env - dp.offset).clamp(0, b - 1)), own)
        if weights is None:
            weights = torch.ones(L, device=device)
        return batch, weights, slot, env

    @span("dqn.learn")
    def learner_half(state: DQNState, k_sample, k_nlearn,
                     learn_steps: Optional[int] = None):
        """One TD step; the caller gates it on ``learn_starts``.
        ``learn_steps``: the host's copy of ``state.learn_steps`` (read
        from the card when not given), for the target sync."""
        count("dqn.learner_updates")
        if learn_steps is None:
            learn_steps = int(state.learn_steps)
        replay = state.replay
        beta = None
        if cfg.prioritized:
            frac = torch.clamp(state.learn_steps.float()
                               * _recip_f32(cfg.per_beta_steps), 0, 1)
            beta = threefry._fma(1.0 - cfg.per_beta0, frac, cfg.per_beta0)
        batch, weights, slot, env = learner_batch(replay, k_sample, beta)
        batch = {n: dp.share(v) for n, v in batch.items()}
        weights = dp.share(weights)
        p = {n: v.detach().requires_grad_() for n, v in state.params.items()}
        with dp.forward_points() as points:
            loss, (err, q_sel) = loss_fn(p, state.target_params, batch,
                                         weights, k_nlearn)
        err = err.detach()
        learner_m = {"loss": loss.detach(),
                     "mean_q": dp.part_mean(q_sel.detach(), L),
                     "td_abs_err": dp.part_mean(err.abs(), L)}
        grads, learner_m = dp.grads(loss, p, points, learner_m)
        if cfg.prioritized:
            replay = update_priority_block(
                replay, slot, env, dp.gather(err, 0), cfg.per_alpha,
                cfg.per_eps, dp.offset)
        grads = clip_by_global_norm(grads, cfg.max_grad_norm, dp.model)
        updates, opt_state = adam_update(grads, state.opt_state, cfg.lr)
        params = {n: state.params[n] + updates[n] for n in state.params}
        target = state.target_params
        if (learn_steps + 1) % cfg.target_update_period == 0:
            with span("dqn.target_sync"):
                count("dqn.target_syncs")
                target = dict(params)
        return state.replace(params=params, target_params=target,
                             opt_state=opt_state, replay=replay,
                             learn_steps=state.learn_steps + 1), learner_m

    def _zeros():
        return {n: torch.zeros((), device=device) for n in _LEARNER_KEYS}

    def can_learn(filled_slots: int) -> bool:
        """The warm-up gate; a frame-ring slot is sampleable only once its
        history and its n successors exist."""
        history = 1 if cfg.ring_stacks else k
        if cfg.frame_ring and filled_slots - history - cfg.n_step + 1 <= 0:
            return False
        return filled_slots * B >= cfg.learn_starts

    def train_step_fn(state: DQNState):
        state, (k_sample, k_nlearn, actor_m) = actor_half(state)
        if can_learn(int(state.replay.filled_slots)):
            state, learner_m = learner_half(state, k_sample, k_nlearn)
        else:
            learner_m = _zeros()
        return state, dict(sorted({**dp.reduce_actor(actor_m),
                                   **learner_m}.items()))

    def train_chunk_fn(state: DQNState, n: int):
        """``n`` actor steps, one learner update per ``cfg.learn_every`` of
        them once the ring holds ``learn_starts`` transitions. Actor metrics
        are means over the n steps, learner metrics over the n //
        learn_every learner slots (0 for a skipped one)."""
        le = cfg.learn_every
        if n % le:
            raise ValueError(f"chunk length {n} must be a multiple of "
                             f"learn_every={le}")
        filled_slots = int(state.replay.filled_slots)
        learn_steps = int(state.learn_steps)
        rows = []
        for t in range(n):
            state, (k_sample, k_nlearn, actor_m) = actor_half(state)
            filled_slots = min(filled_slots + 1, slots)
            if t % le == le - 1 and can_learn(filled_slots):
                state, learner_m = learner_half(state, k_sample, k_nlearn,
                                                learn_steps)
                learn_steps += 1
            else:
                learner_m = _zeros()
            rows.append({**actor_m, **learner_m})
        metrics = {m: torch.stack([r[m] for r in rows]).sum(dim=0)
                   / (n // le if m in _LEARNER_KEYS else n) for m in rows[0]}
        return state, dict(sorted(dp.reduce_actor(metrics).items()))

    train_chunk_fn.actor_half = actor_half
    train_chunk_fn.learner_half = learner_half
    return init_fn, train_step_fn, train_chunk_fn, network


def train(cfg: DQNConfig, total_steps: int, key=0, chunk: int = 128,
          log_fn=print, device="cuda") -> DQNState:
    """The host loop: init, run chunks, log aggregated metrics."""
    init_fn, _, chunk_fn, _ = make_train(cfg, device)
    state = init_fn(key)
    steps = 0
    while steps < total_steps:
        state, metrics = chunk_fn(state, chunk)
        steps += chunk
        if log_fn is not None:
            host = {m: float(v) for m, v in metrics.items()}
            host["env_steps"] = steps * cfg.num_envs
            log_fn(host)
    return state
