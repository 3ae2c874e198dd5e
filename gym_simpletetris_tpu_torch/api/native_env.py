"""Host-native single-env TetrisEnv backed by the C++ engine, no torch
device (port of ``gym_simpletetris_tpu.api.native_env``).

Same old-gym-API surface as the reference ``TetrisEnv`` (tetris_env.py:338-467)
and as ``api/gym_compat.TetrisEnv``, but the transition runs in
``native/oracle.cc`` and observations are rendered with the pure-numpy host
raster (``ops.raster.rasterize_host``): the backend for laptop debugging, CI,
or light single-env workloads where a device round-trip a step would
dominate.

Width is not limited by the packed engine's layout here: the C++ engine is
per-cell, like the reference (which has no limit either, tetris_env.py:126-140).

Differences from the reference (same set as gym_compat, documented not silent):
a ``seed`` kwarg (splitmix64) replaces the global-``random`` dependence, with an
``injected_r`` hook for oracle-parity replay; ``info['statistics']`` is a fresh
dict per call; out-of-range actions act as idle rather than raising KeyError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..native import NativeTetrisEngine, PIECE_NAMES, load_library
from ..ops.raster import rasterize_host
from . import spaces

OBS_TYPES = ("ram", "grayscale", "rgb")


class NativeTetrisEnv:
    """Drop-in, old-gym-API SimpleTetris on the host-native C++ engine."""

    metadata = {"render.modes": ["human", "rgb_array"], "render_fps": 8}

    def __init__(self,
                 width=10,
                 height=20,
                 obs_type="ram",
                 extend_dims=False,
                 render_mode="rgb_array",
                 reward_step=False,
                 penalise_height=False,
                 penalise_height_increase=False,
                 advanced_clears=False,
                 high_scoring=False,
                 penalise_holes=False,
                 penalise_holes_increase=False,
                 lock_delay=0,
                 step_reset=False,
                 seed: int = 0):
        if obs_type not in OBS_TYPES:
            raise ValueError(f"obs_type={obs_type!r} not in {OBS_TYPES}")
        self.width, self.height = width, height
        self.obs_type, self.extend_dims = obs_type, extend_dims
        self.render_mode = render_mode  # stored-but-unused, like the reference
        self.window_size = 512
        self.engine = NativeTetrisEngine(
            width=width, height=height, lock_delay=lock_delay,
            step_reset=step_reset, reward_step=reward_step,
            penalise_height=penalise_height,
            penalise_height_increase=penalise_height_increase,
            advanced_clears=advanced_clears, high_scoring=high_scoring,
            penalise_holes=penalise_holes,
            penalise_holes_increase=penalise_holes_increase, seed=seed)

        self.action_space = spaces.action_space()
        if obs_type == "ram":
            shape = (width, height, 1) if extend_dims else (width, height)
        elif obs_type == "grayscale":
            shape = (84, 84, 1) if extend_dims else (84, 84)
        else:  # rgb — extend_dims ignored, like the reference (:391-392)
            shape = (84, 84, 3)
        self.observation_space = spaces.Box(0, 1, shape, np.float32)
        self.window = None
        self.clock = None
        self.value_action_map = {
            0: "left", 1: "right", 2: "hard_drop", 3: "soft_drop",
            4: "rotate_left", 5: "rotate_right", 6: "idle"}
        self.action_value_map = {v: k for k, v in self.value_action_map.items()}
        self.nb_actions = len(self.value_action_map)

    # -- observation conversion (`_observation`, tetris_env.py:413-433) ---------
    def _observation(self, board: np.ndarray) -> np.ndarray:
        if self.obs_type == "ram":
            obs = board.astype(np.float32)
            return obs.reshape(self.width, self.height, 1) \
                if self.extend_dims else obs
        # convert_grayscale transposes internally (:82): raster of (H, W)
        gray = rasterize_host(board.T, self.height, self.width, 84)
        if self.obs_type == "grayscale":
            obs = gray.astype(np.float32)
            return obs.reshape(84, 84, 1) if self.extend_dims else obs
        return np.repeat(gray[..., None], 3, axis=-1).astype(np.float32)

    # -- gym API -----------------------------------------------------------------
    def reset(self, return_info: bool = False, injected_r: Optional[int] = None):
        board, _ = self.engine.clear(0 if injected_r is None else injected_r)
        obs = self._observation(board)
        return (obs, self._get_info()) if return_info else obs

    def step(self, action, injected_r: Optional[int] = None):
        (board, reward, done), _ = self.engine.step(
            int(action), 0 if injected_r is None else injected_r)
        return self._observation(board), float(reward), bool(done), \
            self._get_info()

    def _get_info(self) -> dict:
        return self.engine.info()

    def valid_action_count(self) -> int:
        return self.engine.valid_action_count()

    def render(self, mode: str = "human"):
        if mode == "rgb_array":
            # (160,160,3) (tetris_env.py:458-462)
            gray = rasterize_host(self.engine.render().T,
                                  self.height, self.width, 160)
            return np.repeat(gray[..., None], 3, axis=-1)
        if mode == "human":
            # transpose *before* convert_grayscale (:445): raster of (W, H)
            import pygame
            if self.window is None:
                pygame.init()
                pygame.display.init()
                self.window = pygame.display.set_mode(
                    (self.window_size, self.window_size))
            if self.clock is None:
                self.clock = pygame.time.Clock()
            gray = rasterize_host(self.engine.render(),
                                  self.width, self.height, self.window_size)
            rgb = np.repeat(gray[..., None], 3, axis=-1)
            pygame.pixelcopy.array_to_surface(self.window, rgb)
            canvas = pygame.surfarray.make_surface(rgb)
            self.window.blit(canvas, canvas.get_rect())
            pygame.event.pump()
            pygame.display.update()
            self.clock.tick(self.metadata["render_fps"])
            return None
        raise NotImplementedError(mode)

    def close(self):
        if self.window is not None:
            import pygame
            pygame.display.quit()
            self.window = None

    def __repr__(self):
        b = self.engine.render()
        s = "o" + "-" * self.width + "o\n"
        s += "\n".join(
            "|" + "".join("X" if b[x, y] else " " for x in range(self.width))
            + "|" for y in range(self.height))
        return s + "\no" + "-" * self.width + "o"


class NativeVectorEnv:
    """Batched host vector env: ``batch_size`` independent C++ games stepped by
    ONE ctypes call (optionally fanned over OS threads) — the numpy analog of
    ``TetrisVectorEnv`` for machines without an accelerator.

    Semantics per game match the reference exactly (same engine as
    NativeTetrisEnv); ``auto_reset`` mirrors ``EnvConfig.auto_reset``: games
    that die are clear()ed in the same step, their observation is the reset
    observation (empty board), and reward/done still report the terminal
    transition.

    ``step`` returns (obs, reward, done, info); info is a dict of arrays
    gathered per-env only when constructed ``with_info=True`` (it costs a
    Python loop per step), else {}.
    """

    PIECE_NAMES = PIECE_NAMES

    def __init__(self, batch_size: int, obs_type: str = "ram",
                 extend_dims: bool = False, auto_reset: bool = True,
                 seed: int = 0, threads: int = 0, with_info: bool = False,
                 obs_dtype: str = "float32",
                 render_mode: str = "rgb_array",  # stored-but-unused, like
                 **engine_flags):                 # the reference (:348,362)
        if obs_type not in OBS_TYPES:
            raise ValueError(f"obs_type={obs_type!r} not in {OBS_TYPES}")
        if obs_dtype not in ("float32", "uint8"):
            raise ValueError(f"obs_dtype={obs_dtype!r}")
        self.render_mode = render_mode
        self._lib = load_library()
        self.batch_size = batch_size
        self.obs_type, self.extend_dims = obs_type, extend_dims
        self.obs_dtype = np.float32 if obs_dtype == "float32" else np.uint8
        self.auto_reset = auto_reset
        # default single-thread: per-call work is ~100us at B=1024 and thread
        # spawn costs more than it saves on small hosts (measured: 2 threads
        # at B=256-1024 consistently slower); pass threads>1 on many-core
        # hosts with large batches
        self.threads = threads or 1
        self.with_info = with_info
        self.width = engine_flags.get("width", 10)
        self.height = engine_flags.get("height", 20)
        self._engine_flags = dict(engine_flags)
        self.engines = [NativeTetrisEngine(seed=seed + i, **engine_flags)
                        for i in range(batch_size)]
        self._handles = np.array([e._h.value for e in self.engines], np.uint64)
        self.action_space = spaces.action_space()
        if obs_type == "ram":
            oshape = (self.width, self.height) + ((1,) if extend_dims else ())
        elif obs_type == "grayscale":
            oshape = (84, 84) + ((1,) if extend_dims else ())
        else:
            oshape = (84, 84, 3)
        # float32 keeps the reference's Box(0,1) declaration quirk; uint8 is a
        # framework extension and declares honest image bounds
        if obs_dtype == "float32":
            self.observation_space = spaces.Box(0, 1, oshape, np.float32)
        else:
            high = 1 if obs_type == "ram" else 255
            self.observation_space = spaces.Box(0, high, oshape, np.uint8)
        if obs_type != "ram":
            # static raster geometry as per-cell pixel rectangles, indexed in
            # the engine's x-major board order (no transpose at step time)
            from ..ops.raster import build_raster_maps, PIECE_SHADE
            base, cell = build_raster_maps(self.height, self.width, 84)
            rects = np.zeros((self.width * self.height, 4), np.int32)
            for c in np.unique(cell[cell >= 0]):
                rows, cols = np.nonzero(cell == c)
                y, x = divmod(int(c), self.width)   # raster order y*W + x
                rects[x * self.height + y] = (rows.min(), cols.min(),
                                              rows.max() - rows.min() + 1,
                                              cols.max() - cols.min() + 1)
            self._raster_rects = np.ascontiguousarray(rects.reshape(-1))
            self._raster_ch = 3 if obs_type == "rgb" else 1
            if self._raster_ch == 3:
                base = np.repeat(base[..., None], 3, axis=-1)
            self._raster_base = np.ascontiguousarray(base.reshape(-1))
            self._raster_shade = PIECE_SHADE

    def _observation(self, boards: np.ndarray) -> np.ndarray:
        """boards u8[B, W, H] -> obs per obs_type/obs_dtype (batched; the
        grayscale raster runs in C++ over static per-cell rectangles)."""
        if self.obs_type == "ram":
            obs = np.asarray(boards, self.obs_dtype)
            return obs[..., None] if self.extend_dims else obs
        n = boards.shape[0]
        ch = self._raster_ch
        out = np.empty((n, 84 * 84 * ch), np.uint8)
        self._lib.tetris_raster_vec(
            np.ascontiguousarray(boards.reshape(n, -1)), n,
            self.width * self.height, self._raster_base, self._raster_rects,
            84, ch, self._raster_shade, self.threads, out)
        if self.obs_type == "grayscale":
            obs = np.asarray(out.reshape(n, 84, 84), self.obs_dtype)
            return obs[..., None] if self.extend_dims else obs
        return np.asarray(out.reshape(n, 84, 84, 3), self.obs_dtype)

    def reset(self) -> np.ndarray:
        """clear() every game; returns the (empty-board) reset observation."""
        n = self.batch_size
        r0 = np.empty(n, np.int32)
        boards = np.empty((n, self.width, self.height), np.uint8)
        rc = self._lib.tetris_clear_vec(self._handles, n, r0, boards)
        if rc != 0:
            raise RuntimeError(
                "tetris_clear_vec failed: mixed board geometries in one batch")
        return self._observation(boards)

    def step(self, actions):
        n = self.batch_size
        actions = np.ascontiguousarray(actions, np.int32)
        assert actions.shape == (n,), actions.shape
        boards = np.empty((n, self.width, self.height), np.uint8)
        rewards = np.empty(n, np.float32)
        dones = np.empty(n, np.uint8)
        r_step = np.empty(n, np.int32)
        r_clear = np.empty(n, np.int32)
        rc = self._lib.tetris_step_vec(self._handles, n, actions,
                                       int(self.auto_reset), self.threads,
                                       boards, rewards, dones, r_step, r_clear)
        if rc != 0:
            raise RuntimeError(
                "tetris_step_vec failed: mixed board geometries in one batch")
        if self.auto_reset:
            boards[dones != 0] = 0      # reset observation = empty board
        info = self.infos() if self.with_info else {}
        return (self._observation(boards), rewards,
                dones.astype(bool), info)

    def reseed(self, seed: int) -> None:
        """Replace every game with a fresh engine (new splitmix64 streams).
        Call reset() afterwards to start the new episodes."""
        self.engines = [NativeTetrisEngine(seed=seed + i, **self._engine_flags)
                        for i in range(self.batch_size)]
        self._handles = np.array([e._h.value for e in self.engines],
                                 np.uint64)

    def infos(self) -> dict:
        """Batched get_info (one FFI call): dict of arrays (time/score/...
        int32[B], statistics int32[B, 7])."""
        keys = ("time", "current_piece", "score", "lines_cleared", "holes",
                "deaths")
        out6 = np.empty((self.batch_size, 6), np.int32)
        counts = np.empty((self.batch_size, 7), np.int32)
        self._lib.tetris_info_vec(self._handles, self.batch_size, out6, counts)
        info = {k: out6[:, j].copy() for j, k in enumerate(keys)}
        info["statistics"] = counts
        return info
