"""Standalone ``TetrisEngine`` and the public raster conversion functions
(port of ``gym_simpletetris_tpu.api.engine``).

The reference exposes three module-level entry points that user code imports
directly (not through the gym env):

- ``TetrisEngine(width, height, ...)``: the tetrisRL-style engine class
  (tetris_env.py:125-335): construct, ``clear()``, ``step(action)`` ->
  (board_copy, reward, done), read ``.board`` / ``.anchor`` / ``.shape`` /
  the counters.
- ``convert_grayscale(board, size)`` (tetris_env.py:76-114) and
  ``convert_grayscale_rgb(array)`` (:117-122): host functions over
  arbitrary arrays.

``TetrisEngine`` runs the batched engine at B = 1 on a torch device (the card
unless ``device="cpu"``): every transition is ``core.engine.engine_step``,
step kernel A on the card, so its trajectories are bitwise those of the
vectorized env. The conversion functions are numpy over the raster's static
geometry (``ops.raster.build_raster_maps``), the geometry the raster kernel
reads.

Differences from the reference, as in the JAX package:
- RNG: a keyword-only ``seed`` drives the engine's threefry stream (the
  stream of ``jax.random.PRNGKey(seed)``) instead of the global Python
  Mersenne Twister; ``injected_r`` replays recorded reference draws.
- ``.board`` is a property returning a fresh (W, H) float copy of the packed
  state (piece erased). Element writes to it don't write through; assign a
  whole array to ``.board`` (the setter re-packs it).
- ``.anchor`` reads back the int-coerced anchor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import EnvConfig
from ..core.pieces import PIECE_NAMES, OFFSETS
from ..ops.bitops import pack_board, unpack_board
from ..ops.raster import BACKGROUND_SHADE, PIECE_SHADE, build_raster_maps
from .env import TetrisVectorEnv, to_host
from .primitives import VALUE_ACTION_MAP

__all__ = ["TetrisEngine", "convert_grayscale", "convert_grayscale_rgb"]


def convert_grayscale(board, size: int) -> np.ndarray:
    """Rasterize a 2-D array into a ``size`` x ``size`` uint8 grayscale
    image, the reference's ``convert_grayscale`` (tetris_env.py:76-114):

    - the input is uint8-cast then transposed (:81-82), so image axis 0
      indexes the input's *second* axis (for (W, H) boards: image rows = y);
    - values: 0 -> 128 (background), 1 -> 190 (piece), any OTHER value
      becomes that pixel's shade verbatim (:96-97);
    - integer block / gap / padding geometry: gap = size // 100 + 1, block =
      (size - 2 * gap) // max(d0, d1) - gap, centering pad floor-halved;
    - gaps render background (128), outer padding renders border (0).

    Raises ValueError where the block would be < 1 (the reference's
    ``np.repeat`` / ``np.insert`` chain would produce malformed output).
    """
    arr = np.asarray(np.array(board, dtype=np.uint8).T)
    d0, d1 = arr.shape
    shades = np.where(arr == 0, np.uint8(BACKGROUND_SHADE),
                      np.where(arr == 1, np.uint8(PIECE_SHADE), arr))
    base, cellmap = build_raster_maps(d0, d1, size)
    flat = np.append(shades.astype(np.uint8).reshape(-1), np.uint8(0))
    img = np.where(cellmap < 0, base,
                   flat[np.where(cellmap < 0, d0 * d1, cellmap)])
    return img.astype(np.uint8)


def convert_grayscale_rgb(array) -> np.ndarray:
    """HxW -> HxWx3 channel triple (``convert_grayscale_rgb``,
    tetris_env.py:117-122), with its reshape semantics (the target shape is
    always ``(shape[0], shape[1], 1)``)."""
    array = np.asarray(array)
    shape = (array.shape[0], array.shape[1])
    grayscale = np.reshape(array, (*shape, 1))
    return np.repeat(grayscale, 3, axis=2)


INFO_FIELDS = ("time", "piece", "score", "lines_cleared", "holes", "deaths")


def info_tensors(state) -> list:
    """The info fields of a B = 1 packed state, to be fetched together with
    ``to_host`` (one device -> host copy); ``info_dict`` reads them."""
    return [getattr(state, f) for f in INFO_FIELDS] + [state.shape_counts[:, 0]]


def info_dict(host) -> dict:
    """The reference info dict (tetris_env.py:232-241) from the host arrays
    of ``info_tensors``; ``statistics`` is a fresh dict per call, not the
    live mutated object (:240-241 quirk)."""
    *scalars, counts = host
    info = {f: int(v[0]) for f, v in zip(INFO_FIELDS, scalars)}
    return {
        "time": info["time"],
        "current_piece": PIECE_NAMES[info["piece"]],
        "score": info["score"],
        "lines_cleared": info["lines_cleared"],
        "holes": info["holes"],
        "deaths": info["deaths"],
        "statistics": {n: int(c) for n, c in zip(PIECE_NAMES, counts)},
    }


class StateReads:
    """The reference TetrisEngine's read-only attributes (tetris_env.py:
    125-181) over env 0 of a B = 1 packed state. A subclass gives ``config``
    and ``_live()``, the state or None; with None each attribute reads as
    the reference's post-``__init__`` engine (no piece, ``time == score ==
    -1``)."""

    def _int(self, field: str, default: int) -> int:
        """Env 0's ``field`` of the state, ``default`` without one."""
        s = self._live()
        return default if s is None else int(getattr(s, field)[0])

    @property
    def board(self) -> np.ndarray:
        """(W, H) float board indexed ``board[x, y]``, active piece erased:
        the persistent board between steps (tetris_env.py:140). A fresh
        copy."""
        s = self._live()
        if s is None:
            return np.zeros((self.config.width, self.config.height),
                            dtype=float)
        return unpack_board(self.config, s.rows)[0].cpu().numpy() \
            .astype(float)

    @property
    def anchor(self):
        s = self._live()
        if s is None:
            return None
        ax, ay = to_host(s.ax, s.ay)
        return (int(ax[0]), int(ay[0]))

    @property
    def shape(self):
        """Current piece offsets [(dx, dy), ...] at its current rotation
        (the reference mutates ``self.shape`` on rotation, :171, :245)."""
        s = self._live()
        if s is None:
            return None
        piece, rot = to_host(s.piece, s.rot)
        return [tuple(c) for c in OFFSETS[int(piece[0]), int(rot[0])].tolist()]

    @property
    def shape_name(self):
        s = self._live()
        return None if s is None else PIECE_NAMES[self._int("piece", 0)]

    @property
    def shape_counts(self) -> dict:
        """Per-piece spawn counts as the reference's name-keyed dict (:181)."""
        s = self._live()
        if s is None:
            return {n: 0 for n in PIECE_NAMES}
        counts = s.shape_counts[:, 0].cpu().numpy()
        return {n: int(c) for n, c in zip(PIECE_NAMES, counts)}

    @property
    def time(self) -> int:
        return self._int("time", -1)

    @property
    def score(self) -> int:
        return self._int("score", -1)

    @property
    def holes(self) -> int:
        return self._int("holes", 0)

    @property
    def lines_cleared(self) -> int:
        return self._int("lines_cleared", 0)

    @property
    def n_deaths(self) -> int:
        return self._int("deaths", 0)


class TetrisEngine(StateReads):
    """Drop-in standalone engine with the reference ``TetrisEngine`` surface
    (tetris_env.py:125-335), on the batched engine at B = 1.

    The constructor matches the reference positionally (:126-137), plus the
    keyword-only ``seed`` and ``device``. Before the first ``clear()`` the
    engine mirrors the reference's post-``__init__`` state: empty board,
    ``time == score == -1``, no piece (``anchor`` / ``shape`` /
    ``shape_name`` are None) and ``step()`` raises (:165-172).
    """

    def __init__(self,
                 width,
                 height,
                 lock_delay=0,
                 step_reset=False,
                 reward_step=False,
                 penalise_height=False,
                 penalise_height_increase=False,
                 advanced_clears=False,
                 high_scoring=False,
                 penalise_holes=False,
                 penalise_holes_increase=False,
                 *,
                 seed: int = 0,
                 device="cuda"):
        self.width, self.height = width, height
        self.config = EnvConfig(
            width=width, height=height, obs_type="ram",
            reward_step=reward_step, penalise_height=penalise_height,
            penalise_height_increase=penalise_height_increase,
            advanced_clears=advanced_clears, high_scoring=high_scoring,
            penalise_holes=penalise_holes,
            penalise_holes_increase=penalise_holes_increase,
            lock_delay=lock_delay, step_reset=step_reset)
        # the reference's introspectable attributes (:141-162, :175-177)
        self._scoring = self.config.scoring_dict()
        self.value_action_map = dict(VALUE_ACTION_MAP)
        self.action_value_map = {v: k for k, v in self.value_action_map.items()}
        self.nb_actions = len(self.value_action_map)
        self._step_reset = step_reset

        self._venv = TetrisVectorEnv(self.config, batch_size=1, device=device)
        self.device = self._venv.device
        self._seed = seed
        self._state = None

    # -- engine API (tetris_env.py:243-335) -----------------------------------
    def step(self, action, injected_r: Optional[int] = None):
        """One transition: returns ``(board_copy, reward, done)`` where
        ``board_copy`` is the (W, H) float board with the active piece burned
        in (tetris_env.py:301-304)."""
        if self._state is None:
            # the reference dies coercing the None anchor (:244)
            raise TypeError("step() before clear(): no piece spawned yet "
                            "(the reference raises here too)")
        inj = None if injected_r is None else [injected_r]
        obs, self._state, reward, done, _ = self._venv.step(
            self._state, [int(action)], injected_r=inj)
        board, reward, done = to_host(obs[0], reward, done)
        return board.astype(float), float(reward[0]), bool(done[0])

    def clear(self, injected_r: Optional[int] = None) -> np.ndarray:
        """Episode reset (tetris_env.py:306-315): zero the board and the
        per-episode counters, spawn a piece; carries over the lock counter,
        ``n_deaths`` and ``shape_counts`` like the reference. Returns the
        (empty) board."""
        inj = None if injected_r is None else [injected_r]
        if self._state is None:
            _, self._state = self._venv.reset(self._seed, injected_r=inj)
        else:
            _, self._state = self._venv.soft_reset(self._state, injected_r=inj)
        return self.board

    def render(self) -> np.ndarray:
        """Board copy with the active piece burned in (tetris_env.py:317-321)."""
        if self._state is None:
            return self.board
        rows = self._venv.render_rows(self._state)
        return unpack_board(self.config, rows)[0].cpu().numpy().astype(float)

    def get_info(self) -> dict:
        """The reference info dict (tetris_env.py:232-241), its fields in one
        device -> host copy; ``statistics`` is a fresh dict per call, not the
        live mutated object (:240-241 quirk)."""
        if self._state is None:
            return {"time": -1, "current_piece": None, "score": -1,
                    "lines_cleared": 0, "holes": 0, "deaths": 0,
                    "statistics": self.shape_counts}
        return info_dict(to_host(*info_tensors(self._state)))

    def valid_action_count(self) -> int:
        """Count of actions that would change (shape, anchor)
        (tetris_env.py:222-230)."""
        if self._state is None:
            raise TypeError("valid_action_count() before clear()")
        return int(self._venv.valid_action_count(self._state)[0])

    def seed(self, seed: int) -> None:
        """Reseed the engine RNG (fresh-engine semantics: the next ``clear()``
        behaves like a newly constructed engine with this seed). No reference
        counterpart: it had no seeding API (tetris_env.py:2,187)."""
        self._seed = seed
        self._state = None

    # -- reference attributes over the packed state (StateReads) ------------
    def _live(self):
        return self._state

    @property
    def board(self) -> np.ndarray:
        """(W, H) float board indexed ``board[x, y]``, active piece erased:
        the persistent board between steps (tetris_env.py:140). A fresh copy;
        assign a whole array to write (the setter re-packs it)."""
        return StateReads.board.fget(self)

    @board.setter
    def board(self, value) -> None:
        if self._state is None:
            raise RuntimeError("cannot assign board before clear()")
        value = np.asarray(value)
        if value.shape != (self.width, self.height):
            raise ValueError(f"board shape {value.shape} != "
                             f"{(self.width, self.height)}")
        rows = pack_board(self.config, (value != 0)[None])  # [H, (NW,) 1]
        # uint32 bits as the state's int32 words (torch lacks uint32 ops)
        words = np.ascontiguousarray(rows).view(np.int32)
        self._state = self._state.replace(
            rows=torch.as_tensor(words.copy(), device=self.device))

    @property
    def piece_height(self) -> int:
        return self._int("piece_height", 0)

    @property
    def _lock_delay(self) -> int:
        """The live lock-delay counter (reference attribute ``_lock_delay``,
        tetris_env.py:176), read-only."""
        return self._int("lock", 0)

    def __repr__(self) -> str:
        """ASCII board with the piece burned in (tetris_env.py:329-335)."""
        return ascii_board(self.render())


def ascii_board(b: np.ndarray) -> str:
    """The reference's ``TetrisEngine.__repr__`` of a (W, H) board."""
    w, h = b.shape
    s = "o" + "-" * w + "o\n"
    s += "\n".join("|" + "".join("X" if b[x, y] else " " for x in range(w))
                   + "|" for y in range(h))
    return s + "\no" + "-" * w + "o"
