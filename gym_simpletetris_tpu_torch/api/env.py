"""Batched environment API of the PyTorch port (the main path).

Port of ``gym_simpletetris_tpu.api.env``: explicit state, ``reset`` / ``step``
functions over a batch of envs, auto-reset, and a multi-step ``rollout`` that
folds every step's observation into an accumulator. State and observations
live on the env's device; on CUDA the step, the image observation, the
image rollout's accumulation and the episode reset run the port's CUDA
kernels (``ops/cuda_step.py``, ``ops/cuda_raster.py``,
``ops/cuda_reset.py``), on the CPU their plain PyTorch versions. The JAX
``lax.scan`` is a Python loop here. Board rows are ``[H, B]``, or
``[H, NW, B]`` for wide boards (width > 24); every per-env select
broadcasts over the trailing batch axis, so both layouts go through the
same code.

Observations match the reference's ``TetrisEnv._observation``: ram is the
board[x, y] 0/1 grid, grayscale/rgb the 84 x 84 raster, delivered as float32
(or uint8 with ``obs_dtype="uint8"``); reset observes the empty board.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import EnvConfig
from ..core import engine as E
from ..core.pieces import PIECE_NAMES
from ..core.state import EnvState, init_state
from ..ops.bitops import unpack_board
from ..ops.cuda_raster import rasterize_rows, raster_accumulate
from ..ops.cuda_reset import reset as reset_kernel
from ..ops.raster import grayscale_to_rgb
from ..utils.profiling import count, span
from . import spaces

OBS_SIZE = 84


def storage_obs_shape(cfg: EnvConfig) -> tuple:
    """Per-env shape of the storage observation."""
    if cfg.obs_type == "ram":
        return (cfg.width, cfg.height)
    return (OBS_SIZE, OBS_SIZE)


def build_observation_storage(cfg: EnvConfig,
                              emitted_rows: torch.Tensor) -> torch.Tensor:
    """Packed rows (piece burned in, either layout) -> the storage observation,
    always uint8: ram [B, W, H] 0/1; grayscale/rgb [B, 84, 84] in
    {0, 128, 190}. The delivered observation is a cast / view of it."""
    if cfg.obs_type == "ram":
        return unpack_board(cfg, emitted_rows, dtype=torch.uint8)
    return rasterize_rows(cfg, emitted_rows, OBS_SIZE)


def obs_from_storage(cfg: EnvConfig, storage: torch.Tensor) -> torch.Tensor:
    """Storage observation -> delivered observation: the dtype cast, the rgb
    channel triple as an ``expand`` view, and the extend_dims axis."""
    dt = torch.float32 if cfg.obs_dtype == "float32" else torch.uint8
    obs = storage.to(dt)
    if cfg.obs_type == "rgb":
        return grayscale_to_rgb(obs)
    return obs[..., None] if cfg.extend_dims else obs


def build_observation(cfg: EnvConfig, emitted_rows: torch.Tensor) -> torch.Tensor:
    """Packed rows -> the observation the API delivers for cfg.obs_type."""
    return obs_from_storage(cfg, build_observation_storage(cfg, emitted_rows))


def _select_reset(mask: torch.Tensor, cleared: EnvState,
                  cleared_rows: torch.Tensor, state: EnvState,
                  emitted: torch.Tensor):
    """Per-env select of the reset envs' cleared state and rows over the
    others' own: batch is the last axis of every field (rows [H, B] or
    [H, NW, B]) but the key, which is global (the clear's is kept)."""
    pick = lambda n, o: torch.where(mask, n, o)
    new_state = state.replace(
        rows=pick(cleared.rows, state.rows),
        shape_counts=pick(cleared.shape_counts, state.shape_counts),
        key=cleared.key,
        **{f: pick(getattr(cleared, f), getattr(state, f)) for f in (
            "piece", "rot", "ax", "ay", "lock", "time", "score", "holes",
            "lines_cleared", "piece_height", "deaths")})
    return new_state, pick(cleared_rows, emitted)


def apply_reset_mask_plain(cfg: EnvConfig, state: EnvState,
                           emitted: torch.Tensor, mask: torch.Tensor,
                           injected_r: Optional[torch.Tensor] = None,
                           cleared_from: Optional[EnvState] = None):
    """``apply_reset_mask`` in plain PyTorch on any device, its draw
    included (the reset kernel's oracle)."""
    cleared = E.engine_clear_plain(
        cfg, state if cleared_from is None else cleared_from, injected_r)
    return _select_reset(mask, *cleared, state, emitted)


@span("env.reset_mask")
def apply_reset_mask(cfg: EnvConfig, state: EnvState, emitted: torch.Tensor,
                     mask: torch.Tensor,
                     injected_r: Optional[torch.Tensor] = None,
                     cleared_from: Optional[EnvState] = None):
    """Episode-reset the envs selected by ``mask`` (bool[B]): their state is
    cleared (carry-over semantics) and their emitted board becomes the empty
    reset board; the key is the clear's. Every auto-reset of the port goes
    through here. ``injected_r`` replaces the clear's spawn draws.
    ``cleared_from`` (default ``state``) is the state the selected envs are
    cleared from: the gymnasium adapter clears its pending envs from their
    pre-step state and keeps the stepped state of the others. On the card
    two launches, the clear's draw and the reset kernel
    (``ops/cuda_reset.py``); on the CPU the plain body, ``engine_clear``
    and a select."""
    src = state if cleared_from is None else cleared_from
    if not state.rows.is_cuda:
        return _select_reset(mask, *E.engine_clear(cfg, src, injected_r),
                             state, emitted)
    key, r = E.spawn_draw(src, injected_r)
    return reset_kernel(cfg, state, r, key, emitted, mask, cleared_from)


def _step_and_reset(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
                    injected_r: Optional[torch.Tensor] = None):
    """``engine_step``, then with ``cfg.auto_reset`` the reset of the envs
    that died: (state, emitted rows, reward, done, the stepped
    ``lines_cleared`` before the reset zeroes it). The stepped state is
    not returned, so it is freed before the caller builds its
    observation."""
    out = E.engine_step(cfg, state, action, injected_r=injected_r)
    new_state, emitted = out.state, out.emitted_rows
    if cfg.auto_reset:
        new_state, emitted = apply_reset_mask(cfg, new_state, emitted,
                                              out.done)
    return new_state, emitted, out.reward, out.done, out.state.lines_cleared


def reset_fn(cfg: EnvConfig, batch_size: int, key,
             injected_r: Optional[torch.Tensor] = None,
             device="cuda", env_offset: int = 0) -> Tuple[torch.Tensor, EnvState]:
    """Fresh engine + episode reset. The observation is the empty board.
    On the card unless ``device="cpu"``; without a card a CUDA request
    raises. ``env_offset``: the first env's index in a sharded global batch
    (the state carries it to every later draw)."""
    state = init_state(cfg, batch_size, key, check_device(device), env_offset)
    state, emitted = E.engine_clear(cfg, state, injected_r=injected_r)
    return build_observation(cfg, emitted), state


def soft_reset_fn(cfg: EnvConfig, state: EnvState,
                  injected_r: Optional[torch.Tensor] = None):
    """Episode reset carrying over the lock counter, deaths and shape counts
    (``TetrisEngine.clear``)."""
    state, emitted = E.engine_clear(cfg, state, injected_r=injected_r)
    return build_observation(cfg, emitted), state


@span("env.step")
def step_fn(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
            injected_r: Optional[torch.Tensor] = None):
    """One batched transition: (obs, state, reward, done, info). With
    ``cfg.auto_reset`` the envs that died are cleared in the same call and
    observe the empty board; reward and done report the terminal step."""
    new_state, emitted, reward, done, lines = _step_and_reset(
        cfg, state, action, injected_r)
    info = make_info(new_state)
    info["lines_delta"] = lines - state.lines_cleared
    return build_observation(cfg, emitted), new_state, reward, done, info


def make_info(state: EnvState) -> dict:
    """Batched ``get_info``: the reference's keys as tensors over the batch;
    ``current_piece`` is an id into PIECE_NAMES, ``statistics`` [B, 7]."""
    return {
        "time": state.time,
        "current_piece": state.piece,
        "score": state.score,
        "lines_cleared": state.lines_cleared,
        "holes": state.holes,
        "deaths": state.deaths,
        "statistics": state.shape_counts.T,
    }


def build_rollout(cfg: EnvConfig, batch_size: int, obs_shape=None,
                  with_obs: bool = True, acc_mode: str = "storage"):
    """Multi-step rollout: returns a function (state, actions[T, B]) ->
    (final_state, obs_acc, reward[T, B], done[T, B]).

    ``with_obs`` folds every step's observation into an accumulator (uint8
    and float32 sums wrap and round exactly as the JAX rollout's do).
    ``acc_mode="storage"`` accumulates the uint8 storage observation; for
    image observations that is one in-place raster-accumulate per step (the
    CUDA kernel on the card). ``acc_mode="delivered"`` accumulates the
    delivered observation in cfg.obs_dtype, rgb channels materialized.
    """
    if acc_mode not in ("storage", "delivered"):
        raise ValueError(f"acc_mode={acc_mode!r}")

    @span("rollout.step")
    def step(state: EnvState, a: torch.Tensor, acc: torch.Tensor):
        if acc_mode == "delivered":
            obs, state, reward, done, _ = step_fn(cfg, state, a)
            if with_obs:
                acc += obs
            return state, reward, done
        state, emitted, reward, done = _step_and_reset(cfg, state, a)[:4]
        if with_obs and cfg.obs_type != "ram":
            raster_accumulate(cfg, emitted, acc, OBS_SIZE)
        elif with_obs:
            acc += build_observation_storage(cfg, emitted)
        return state, reward, done

    @span("rollout.call")
    def rollout(state: EnvState, actions: torch.Tensor):
        dev = state.device
        actions = torch.as_tensor(actions, device=dev).to(torch.int32)
        if acc_mode == "storage":
            acc = torch.zeros((batch_size,) + storage_obs_shape(cfg),
                              dtype=torch.uint8, device=dev)
        else:
            shape = obs_shape or spaces.observation_space(cfg).shape
            acc = torch.zeros((batch_size,) + tuple(shape), device=dev,
                              dtype=torch.float32 if cfg.obs_dtype == "float32"
                              else torch.uint8)
        rewards, dones = [], []
        for a in actions:
            state, reward, done = step(state, a, acc)
            rewards.append(reward)
            dones.append(done)
        empty = lambda dt: torch.empty((0, batch_size), dtype=dt, device=dev)
        rew = torch.stack(rewards) if rewards else empty(torch.float32)
        don = torch.stack(dones) if dones else empty(torch.bool)
        return state, acc, rew, don

    return rollout


@span("env.to_host")
def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors as numpy arrays of their dtypes and shapes, through one
    device -> host copy: each is flattened into one int32 buffer (4-byte
    dtypes by their bits, others by value), which is copied once and cut
    apart. On the card each separate ``.cpu()`` or ``int()`` is a sync.
    Takes 4-byte dtypes and integer or bool dtypes of 1-2 bytes. Counted
    as ``env.to_host.calls`` and ``env.to_host.bytes`` (the tensors'
    bytes, from their shapes)."""
    for t in tensors:
        if t.element_size() > 4 or (t.is_floating_point()
                                    and t.element_size() != 4):
            raise TypeError(f"to_host does not take {t.dtype}")
    count("env.to_host.calls")
    count("env.to_host.bytes", sum(t.numel() * t.element_size()
                                   for t in tensors))
    parts = [t.reshape(-1) for t in tensors]
    parts = [p.view(torch.int32) if p.element_size() == 4
             else p.to(torch.int32) for p in parts]
    flat = torch.cat(parts).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        a = flat[at:at + n]
        dt = np.dtype(str(t.dtype).replace("torch.", ""))
        a = a.view(dt) if dt.itemsize == 4 else a.astype(dt)
        out.append(a.reshape(tuple(t.shape)))
        at += n
    return out


def check_device(device) -> torch.device:
    """``device`` as a torch.device: cpu, or cuda where a card is present.
    A CUDA request without a card raises; it never runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but "
                           "torch.cuda.is_available() is false")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


class TetrisVectorEnv:
    """Batched SimpleTetris on a torch device: the card unless
    ``device="cpu"`` (a CUDA request without a card raises).

    >>> env = TetrisVectorEnv(EnvConfig(obs_type="ram"), 4096, device="cuda")
    >>> obs, state = env.reset(0)
    >>> obs, state, reward, done, info = env.step(state, actions)
    """

    PIECE_NAMES = PIECE_NAMES

    def __init__(self, config: EnvConfig = EnvConfig(), batch_size: int = 1,
                 device="cuda"):
        device = check_device(device)
        self.config = config
        self.batch_size = batch_size
        self.device = device
        self.observation_space = spaces.observation_space(config)
        self.action_space = spaces.action_space()
        self._rollouts = {}

    def _vec(self, x) -> Optional[torch.Tensor]:
        if x is None:
            return None
        return torch.as_tensor(x, device=self.device).to(torch.int32)

    # -- core API ---------------------------------------------------------------
    def reset(self, key_or_seed, injected_r=None):
        """(obs, state) from an int seed or 2 words of threefry key data
        (``jax.random.key_data`` of a JAX key gives the same stream)."""
        return reset_fn(self.config, self.batch_size, key_or_seed,
                        injected_r=self._vec(injected_r), device=self.device)

    def step(self, state: EnvState, action, injected_r=None):
        return step_fn(self.config, state, self._vec(action),
                       injected_r=self._vec(injected_r))

    def soft_reset(self, state: EnvState, injected_r=None):
        return soft_reset_fn(self.config, state, self._vec(injected_r))

    # -- aux --------------------------------------------------------------------
    def render_rows(self, state: EnvState) -> torch.Tensor:
        """Packed board with the active piece burned in."""
        return E.render_rows(self.config, state)

    def valid_action_count(self, state: EnvState) -> torch.Tensor:
        return E.valid_action_count(self.config, state)

    def rollout(self, state: EnvState, actions, with_obs: bool = True,
                acc_mode: str = "storage"):
        """Step through ``T`` pre-chosen action batches, actions int32[T, B].
        Returns (final_state, obs_acc, reward[T, B], done[T, B]); see
        ``build_rollout``. Use cfg.auto_reset for horizons past episode ends."""
        fn = self._rollouts.get((with_obs, acc_mode))
        if fn is None:
            fn = build_rollout(self.config, self.batch_size,
                               self.observation_space.shape, with_obs, acc_mode)
            self._rollouts[(with_obs, acc_mode)] = fn
        return fn(state, actions)
