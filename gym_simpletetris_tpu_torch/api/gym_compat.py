"""Single-env, old-gym-API compatibility shim (port of
``gym_simpletetris_tpu.api.gym_compat``).

Mirrors the reference ``TetrisEnv`` surface (tetris_env.py:338-467): 4-tuple
``step`` -> (obs, reward, done, info), ``reset(return_info=False)``,
``render(mode='human'|'rgb_array')`` (pygame window at 512 px / 8 fps cap, or
a (160, 160, 3) array), ``close()``, and the same constructor kwargs; backed
by the batched engine at B = 1 on a torch device (the card unless
``device="cpu"``) with numpy I/O. On the card every step and reset runs step
kernel A, and image observations and renders run raster kernel B. A step's
observation, reward, done and info come to the host in one copy
(``api.env.to_host``).

Differences (documented, not silent), as in the JAX package:
- RNG: a ``seed`` kwarg drives the env's threefry stream (that of
  ``jax.random.PRNGKey(seed)``) instead of the global Python Mersenne
  Twister; an ``injected_r`` hook supports oracle-parity replay.
- ``info['statistics']`` is a fresh dict per call, not the engine's live,
  mutated dict object (reference quirk, tetris_env.py:240-241).
- Out-of-range actions act as no-ops instead of raising KeyError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.config import EnvConfig
from ..ops.bitops import unpack_board
from ..utils.profiling import span
from . import env as api_env
from . import spaces
from .engine import (StateReads, ascii_board, convert_grayscale,
                     convert_grayscale_rgb, info_dict, info_tensors)
from .primitives import VALUE_ACTION_MAP

RGB_ARRAY_SIZE = 160


def board_image(cfg: EnvConfig, rows, size: int) -> np.ndarray:
    """uint8 (size, size, 3) image of env 0's packed rows (piece burned in),
    in the orientation of the observation raster: image rows are board rows
    y (the reference's ``render('rgb_array')``, which rasterizes the
    transposed (W, H) board). Raster kernel B on the card."""
    img = api_env.rasterize_rows(cfg, rows, size)[0].cpu().numpy()
    return np.repeat(img[..., None], 3, axis=2)


def human_image(cfg: EnvConfig, rows, size: int = 512) -> np.ndarray:
    """uint8 (size, size, 3) image the ``human`` render blits: the reference
    rasterizes the (W, H) board itself (tetris_env.py:445), so image rows are
    columns x. ``raster_geometry`` is symmetric in its two axes (the block
    comes from the larger, each axis has its own pad), so that image is the
    transpose of ``board_image``'s, which raster kernel B draws."""
    return board_image(cfg, rows, size).transpose(1, 0, 2)


class _EngineView(StateReads):
    """Read-only adapter exposing reference-TetrisEngine attribute names
    (tetris_env.py:125-181) over the packed batched state."""

    def __init__(self, env: "TetrisEnv"):
        self._env = env
        self.config = env.config

    def _live(self):
        if self._env._state is None:
            raise RuntimeError("engine state unavailable before reset()")
        return self._env._state

    @property
    def width(self) -> int:
        return self._env.width

    @property
    def height(self) -> int:
        return self._env.height

    def valid_action_count(self) -> int:
        return self._env.valid_action_count()

    def render(self) -> np.ndarray:
        """Board copy with the piece burned in (tetris_env.py:317-321)."""
        return self._env._board().astype(float)

    def get_info(self) -> dict:
        return self._env._get_info()


class TetrisEnv:
    """Drop-in, old-gym-API SimpleTetris on the port's batched engine, on
    the card unless ``device="cpu"`` (a CUDA request without a card
    raises)."""

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
                 seed: int = 0,
                 device="cuda"):
        self.config = EnvConfig(
            width=width, height=height, obs_type=obs_type,
            extend_dims=extend_dims, render_mode=render_mode,
            reward_step=reward_step, penalise_height=penalise_height,
            penalise_height_increase=penalise_height_increase,
            advanced_clears=advanced_clears, high_scoring=high_scoring,
            penalise_holes=penalise_holes,
            penalise_holes_increase=penalise_holes_increase,
            lock_delay=lock_delay, step_reset=step_reset)
        self.width, self.height = width, height
        self.obs_type, self.extend_dims = obs_type, extend_dims
        self.render_mode = render_mode
        self.window_size = 512

        self._venv = api_env.TetrisVectorEnv(self.config, batch_size=1,
                                             device=device)
        self.device = self._venv.device
        self._seed = seed
        self._state = None
        self._info = None
        self.action_space = spaces.action_space()
        self.observation_space = spaces.observation_space(self.config)
        self.window = None
        self.clock = None
        # engine attribute parity (tetris_env.py:152-162): the maps hold the
        # movement-primitive FUNCTION OBJECTS like the reference's
        self.value_action_map = dict(VALUE_ACTION_MAP)
        self.action_value_map = {v: k for k, v in self.value_action_map.items()}
        self.nb_actions = len(self.value_action_map)

    # -- gym API ----------------------------------------------------------------
    @span("shim.reset")
    def reset(self, return_info: bool = False, injected_r: Optional[int] = None):
        inj = None if injected_r is None else [injected_r]
        if self._state is None:
            obs, self._state = self._venv.reset(self._seed, injected_r=inj)
        else:
            # episode reset on a live engine: carry-over semantics (clear())
            obs, self._state = self._venv.soft_reset(self._state,
                                                     injected_r=inj)
        (obs,) = self._fetch(obs)
        return (obs, self._get_info()) if return_info else obs

    @span("shim.step")
    def step(self, action, injected_r: Optional[int] = None):
        if self._state is None:
            raise RuntimeError("step() before reset()")
        inj = None if injected_r is None else [injected_r]
        obs, self._state, reward, done, _ = self._venv.step(
            self._state, [int(action)], injected_r=inj)
        obs, reward, done = self._fetch(obs, reward, done)
        return obs, float(reward[0]), bool(done[0]), self._get_info()

    def _fetch(self, obs, *more):
        """Env 0's observation, ``more`` and the info fields in one device ->
        host copy; the info fields are kept for ``_get_info``. rgb comes
        over as its grayscale channel and is tripled here."""
        s = self._state
        rgb = self.obs_type == "rgb"
        got = api_env.to_host(obs[0, ..., 0] if rgb else obs[0], *more,
                              *info_tensors(s))
        n = len(more) + 1
        self._info = got[n:]
        o = got[0]
        if rgb:
            o = np.repeat(o[..., None], 3, axis=2)
        return (o,) + tuple(got[1:n])

    def _get_info(self):
        return info_dict(self._info)

    def seed(self, seed: int) -> None:
        """Reseed the env RNG in place (fresh-engine semantics: the next
        ``reset()`` behaves like a newly constructed env with this seed),
        without rebuilding the env (the reference has no seeding API at all;
        callers had to use ``random.seed()``, tetris_env.py:2,187)."""
        self._seed = seed
        self._state = None

    def _observation(self, mode=None, state=None, extend_dims=None):
        """Observation conversion hook, mirroring the reference's de-facto
        "render the board as a different obs type" API
        (``TetrisEnv._observation``, tetris_env.py:413-433): ``state`` is a
        (W, H) board (defaults to the live board with the active piece burned
        in, like ``engine.render()``); ``mode`` / ``extend_dims`` default to
        the env's own. Returns the raw converted array (float board for ram,
        uint8 {0, 128, 190} image for grayscale / rgb) like the reference;
        the float32 cast there happens in step / reset, not here. Host numpy
        (``convert_grayscale``, with its value pass-through quirk for
        user-supplied arrays)."""
        obs = state
        if obs is None:
            obs = self._board().astype(float)
        obs = np.asarray(obs)
        new_mode = self.obs_type if mode is None else mode
        extend = self.extend_dims if extend_dims is None else extend_dims
        if new_mode == "ram":
            return (np.reshape(obs, (self.width, self.height, 1))
                    if extend else obs)
        img = convert_grayscale(obs, 84)
        if new_mode == "grayscale":
            return np.reshape(img, (84, 84, 1)) if extend else img
        return convert_grayscale_rgb(img)

    @property
    def engine(self):
        """Read-only view with the reference TetrisEngine's public attribute
        names (board / anchor / shape_name / ..., tetris_env.py:125-181), for
        user code that pokes ``env.engine`` directly."""
        return _EngineView(self)

    def valid_action_count(self) -> int:
        """Count of actions that would change (shape, anchor)
        (``TetrisEngine.valid_action_count``, tetris_env.py:222-230)."""
        if self._state is None:
            raise RuntimeError("valid_action_count() before reset()")
        return int(self._venv.valid_action_count(self._state)[0])

    def _rows(self):
        """Packed rows of the live board with the active piece burned in."""
        return self._venv.render_rows(self._state)

    def _board(self) -> np.ndarray:
        """(W, H) float32 board with the active piece burned in."""
        return unpack_board(self.config, self._rows())[0].cpu().numpy()

    def render(self, mode: str = "human"):
        if mode == "rgb_array":
            # (160, 160, 3) image of the (internally transposed) board
            # (tetris_env.py:458-462)
            return board_image(self.config, self._rows(), RGB_ARRAY_SIZE)
        if mode == "human":
            # pygame window path (tetris_env.py:436-457): the board is
            # transposed *before* convert_grayscale, i.e. rasterized as (W, H)
            import pygame
            if self.window is None:
                pygame.init()
                pygame.display.init()
                self.window = pygame.display.set_mode(
                    (self.window_size, self.window_size))
            if self.clock is None:
                self.clock = pygame.time.Clock()
            rgb = human_image(self.config, self._rows(), self.window_size)
            pygame.pixelcopy.array_to_surface(self.window, rgb)
            canvas = pygame.surfarray.make_surface(rgb)
            self.window.blit(canvas, canvas.get_rect())
            pygame.event.pump()
            pygame.display.update()
            self.clock.tick(self.metadata["render_fps"])
            return None
        # unknown mode: the reference falls through to gym.Env.render
        # (tetris_env.py:463-464), which in the old gym API raises
        # NotImplementedError itself; delegate when gym is importable,
        # reproduce its behaviour when it isn't.
        try:
            import gym
        except ImportError:
            raise NotImplementedError(mode)
        try:
            return gym.Env.render(self, mode=mode)
        except TypeError:      # newer gym dropped the mode parameter
            return gym.Env.render(self)

    def close(self):
        # the reference just `del self.engine` and leaks the window
        # (:466-467); this closes the window.
        self._state = None
        if self.window is not None:
            import pygame
            pygame.display.quit()
            self.window = None

    def __repr__(self):
        """ASCII board like TetrisEngine.__repr__ (tetris_env.py:329-335)."""
        if self._state is None:
            return f"TetrisEnv({self.width}x{self.height}, unreset)"
        return ascii_board(self._board())
