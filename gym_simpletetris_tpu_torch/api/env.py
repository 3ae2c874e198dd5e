"""Batched environment API of the PyTorch port (the main path).

Port of ``gym_simpletetris_tpu.api.env``: explicit state, ``reset`` / ``step``
functions over a batch of envs, auto-reset, and a multi-step ``rollout`` that
folds every step's observation into an accumulator. State and observations
live on the env's device; on CUDA the step, the image observation and the
image rollout's accumulation run the port's CUDA kernels
(``ops/cuda_step.py``, ``ops/cuda_raster.py``), on the CPU their plain
PyTorch versions. The JAX ``lax.scan`` is a Python loop here. Board rows
are ``[H, B]``, or ``[H, NW, B]`` for wide boards (width > 24); every
per-env select broadcasts over the trailing batch axis, so both layouts go
through the same code.

Observations match the reference's ``TetrisEnv._observation``: ram is the
board[x, y] 0/1 grid, grayscale/rgb the 84 x 84 raster, delivered as float32
(or uint8 with ``obs_dtype="uint8"``); reset observes the empty board.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.config import EnvConfig
from ..core import engine as E
from ..core.pieces import PIECE_NAMES
from ..core.state import EnvState, init_state
from ..ops.bitops import unpack_board
from ..ops.cuda_raster import rasterize_rows, raster_accumulate
from ..ops.raster import grayscale_to_rgb
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


def _select_done(done: torch.Tensor, new: EnvState, old: EnvState) -> EnvState:
    """Per-env select over the state: batch is the last axis of every field
    (rows [H, B] or [H, NW, B]) but the key, which is global (the advanced
    key is kept)."""
    pick = lambda n, o: torch.where(done, n, o)
    return old.replace(
        rows=pick(new.rows, old.rows),
        shape_counts=pick(new.shape_counts, old.shape_counts),
        key=new.key,
        **{f: pick(getattr(new, f), getattr(old, f)) for f in (
            "piece", "rot", "ax", "ay", "lock", "time", "score", "holes",
            "lines_cleared", "piece_height", "deaths")})


def apply_reset_mask(cfg: EnvConfig, state: EnvState, emitted: torch.Tensor,
                     mask: torch.Tensor):
    """Episode-reset the envs selected by ``mask`` (bool[B]): their state is
    cleared (carry-over semantics) and their emitted board becomes the empty
    reset board."""
    cleared_state, cleared_rows = E.engine_clear(cfg, state)
    new_state = _select_done(mask, cleared_state, state)
    return new_state, torch.where(mask, cleared_rows, emitted)


def reset_fn(cfg: EnvConfig, batch_size: int, key,
             injected_r: Optional[torch.Tensor] = None,
             device="cuda") -> Tuple[torch.Tensor, EnvState]:
    """Fresh engine + episode reset. The observation is the empty board.
    On the card unless ``device="cpu"``; without a card a CUDA request
    raises."""
    state = init_state(cfg, batch_size, key, check_device(device))
    state, emitted = E.engine_clear(cfg, state, injected_r=injected_r)
    return build_observation(cfg, emitted), state


def soft_reset_fn(cfg: EnvConfig, state: EnvState,
                  injected_r: Optional[torch.Tensor] = None):
    """Episode reset carrying over the lock counter, deaths and shape counts
    (``TetrisEngine.clear``)."""
    state, emitted = E.engine_clear(cfg, state, injected_r=injected_r)
    return build_observation(cfg, emitted), state


def step_fn(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
            injected_r: Optional[torch.Tensor] = None):
    """One batched transition: (obs, state, reward, done, info). With
    ``cfg.auto_reset`` the envs that died are cleared in the same call and
    observe the empty board; reward and done report the terminal step."""
    out = E.engine_step(cfg, state, action, injected_r=injected_r)
    new_state, emitted = out.state, out.emitted_rows
    if cfg.auto_reset:
        new_state, emitted = apply_reset_mask(cfg, new_state, emitted, out.done)
    info = make_info(new_state)
    # lines cleared this step, taken before the reset mask zeroes the counter
    info["lines_delta"] = out.state.lines_cleared - state.lines_cleared
    return build_observation(cfg, emitted), new_state, out.reward, out.done, info


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
            if acc_mode == "delivered":
                obs, state, reward, done, _ = step_fn(cfg, state, a)
                if with_obs:
                    acc += obs
            else:
                out = E.engine_step(cfg, state, a)
                state, emitted, reward, done = out
                if cfg.auto_reset:
                    state, emitted = apply_reset_mask(cfg, state, emitted, done)
                if with_obs and cfg.obs_type != "ram":
                    raster_accumulate(cfg, emitted, acc, OBS_SIZE)
                elif with_obs:
                    acc += build_observation_storage(cfg, emitted)
            rewards.append(reward)
            dones.append(done)
        empty = lambda dt: torch.empty((0, batch_size), dtype=dt, device=dev)
        rew = torch.stack(rewards) if rewards else empty(torch.float32)
        don = torch.stack(dones) if dones else empty(torch.bool)
        return state, acc, rew, don

    return rollout


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
