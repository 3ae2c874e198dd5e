"""Native (C++) host engine: build-on-demand ctypes bindings (port of
``gym_simpletetris_tpu.native``).

``oracle.cc`` implements the exact reference transition semantics
(tetris_env.py:125-335) as a single-env C++ engine, with per-cell loops
like the reference: an implementation independent of the port's packed
engine and of its CUDA step kernel, and a fast host CPU env
(``api/native_env.py``). The file is a byte-identical copy of the JAX
package's ``native/oracle.cc`` (importing that package's ``native`` would
import jax); ``tests/test_torch_native.py`` holds the two identical.

The shared library is compiled lazily with ``g++ -O3`` into the port's
``_build/`` directory (gitignored) and rebuilt whenever ``oracle.cc`` is
newer. A missing or failing ``g++`` raises ``NativeBuildError``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "oracle.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB = os.path.join(_BUILD_DIR, "_oracle.so")

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def _build() -> str:
    # per-process tmp name: concurrent first builds (several test workers)
    # must not interleave writes into one file before the atomic replace
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-pthread", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:  # g++ missing/hung
        raise NativeBuildError(f"native build unavailable: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ failed:\n{proc.stderr}")
    os.replace(tmp, _LIB)
    return _LIB


def native_available() -> bool:
    try:
        load_library()
        return True
    except NativeBuildError:
        return False


def load_library() -> ctypes.CDLL:
    """Compile (if stale) and load the native engine, declaring signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            # stale/corrupt .so (e.g. from an interrupted build): one rebuild,
            # and report load failure as NativeBuildError so callers can skip
            _build()
            try:
                lib = ctypes.CDLL(_LIB)
            except OSError as e:
                raise NativeBuildError(f"built library fails to load: {e}") \
                    from e
        c = ctypes
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.tetris_new.restype = c.c_void_p
        lib.tetris_new.argtypes = [c.c_int] * 11 + [c.c_uint64]
        lib.tetris_free.argtypes = [c.c_void_p]
        lib.tetris_clear.restype = c.c_int
        lib.tetris_clear.argtypes = [c.c_void_p, c.c_int, u8p]
        lib.tetris_step.restype = c.c_int
        lib.tetris_step.argtypes = [c.c_void_p, c.c_int, c.c_int, u8p,
                                    c.POINTER(c.c_double), c.POINTER(c.c_int)]
        lib.tetris_render.argtypes = [c.c_void_p, u8p]
        lib.tetris_board.argtypes = [c.c_void_p, u8p]
        lib.tetris_piece_state.argtypes = [c.c_void_p, i32p, i32p]
        lib.tetris_valid_action_count.restype = c.c_int
        lib.tetris_valid_action_count.argtypes = [c.c_void_p]
        lib.tetris_info.argtypes = [c.c_void_p, i32p, i32p]
        lib.tetris_drive.argtypes = [c.c_void_p, i32p, c.c_int, c.c_int,
                                     u8p, f32p, u8p, i32p, i32p]
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        # boards is optional (c_void_p so that None maps to NULL, not a
        # 0-size-but-valid ndarray pointer the C side would write through)
        lib.tetris_drive_many.argtypes = [i32p, u64p, c.c_int, i32p, c.c_int,
                                          c.c_int, i32p, c.c_void_p, f32p,
                                          u8p, i32p, i32p, i32p, i32p]
        lib.tetris_step_vec.restype = c.c_int    # -1 = mixed board geometries
        lib.tetris_step_vec.argtypes = [u64p, c.c_int, i32p, c.c_int, c.c_int,
                                        u8p, f32p, u8p, i32p, i32p]
        lib.tetris_clear_vec.restype = c.c_int
        lib.tetris_clear_vec.argtypes = [u64p, c.c_int, i32p, u8p]
        lib.tetris_info_vec.argtypes = [u64p, c.c_int, i32p, i32p]
        lib.tetris_raster_vec.argtypes = [u8p, c.c_int, c.c_int, u8p, i32p,
                                          c.c_int, c.c_int, c.c_int, c.c_int,
                                          u8p]
        lib.tetris_state_size.restype = c.c_int
        lib.tetris_state_size.argtypes = [c.c_void_p]
        lib.tetris_save.argtypes = [c.c_void_p, u8p]
        lib.tetris_load.restype = c.c_int
        lib.tetris_load.argtypes = [c.c_void_p, u8p, c.c_int]
        _lib = lib
        return lib


PIECE_NAMES = ("T", "J", "L", "Z", "S", "I", "O")

_CFG_KEYS = ("width", "height", "lock_delay", "step_reset", "reward_step",
             "penalise_height", "penalise_height_increase", "advanced_clears",
             "high_scoring", "penalise_holes", "penalise_holes_increase")


def drive_many(actions: np.ndarray, seeds, threads: int = 0, *,
               with_boards: bool = True, **flags):
    """Run ``n`` independent games of ``T`` steps each in parallel C++ threads.

    actions: int[n, T]; seeds: int[n] (one splitmix64 stream per game);
    flags: the 11 reference engine kwargs (width=10, height=20, ...).

    Returns a dict: r0 i32[n] (the clear() spawn draws), boards
    u8[n, T, W, H] (or None), rewards f32[n, T], dones u8[n, T],
    r_step/r_clear i32[n, T] (per-step draw streams for parity replay),
    deaths i32[n], counts i32[n, 7] (final cross-episode carry-over state).
    """
    lib = load_library()
    actions = np.ascontiguousarray(actions, np.int32)
    n, t = actions.shape
    seeds = np.ascontiguousarray(seeds, np.uint64)
    assert seeds.shape == (n,), (seeds.shape, n)
    unknown = set(flags) - set(_CFG_KEYS)
    if unknown:
        raise TypeError(f"unknown engine flags: {sorted(unknown)}")
    merged = {"width": 10, "height": 20, **flags}
    cfg11 = np.array([int(merged.get(k, 0)) for k in _CFG_KEYS], np.int32)
    w, h = int(cfg11[0]), int(cfg11[1])
    threads = threads or (os.cpu_count() or 1)
    out = {
        "r0": np.empty(n, np.int32),
        "boards": np.empty((n, t, w, h), np.uint8) if with_boards else None,
        "rewards": np.empty((n, t), np.float32),
        "dones": np.empty((n, t), np.uint8),
        "r_step": np.empty((n, t), np.int32),
        "r_clear": np.empty((n, t), np.int32),
        "deaths": np.empty(n, np.int32),
        "counts": np.empty((n, 7), np.int32),
    }
    boards_ptr = (out["boards"].ctypes.data_as(ctypes.c_void_p)
                  if with_boards else None)
    lib.tetris_drive_many(
        cfg11, seeds, n, actions, t, threads, out["r0"], boards_ptr,
        out["rewards"], out["dones"], out["r_step"], out["r_clear"],
        out["deaths"], out["counts"])
    return out


class NativeTetrisEngine:
    """Single-env handle over the C++ engine; mirrors the reference
    ``TetrisEngine`` surface (plus draw-stream recording for parity replay).

    Boards are returned in the reference orientation ``(width, height)`` with
    ``board[x, y]`` and y=0 at the top.
    """

    def __init__(self, width=10, height=20, lock_delay=0, step_reset=False,
                 reward_step=False, penalise_height=False,
                 penalise_height_increase=False, advanced_clears=False,
                 high_scoring=False, penalise_holes=False,
                 penalise_holes_increase=False, seed=0):
        self._lib = load_library()
        self.width, self.height = width, height
        self._h = ctypes.c_void_p(self._lib.tetris_new(
            width, height, lock_delay, int(step_reset), int(reward_step),
            int(penalise_height), int(penalise_height_increase),
            int(advanced_clears), int(high_scoring), int(penalise_holes),
            int(penalise_holes_increase), seed))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.tetris_free(h)
            self._h = None

    def _board_buf(self) -> np.ndarray:
        return np.empty((self.width, self.height), dtype=np.uint8)

    def clear(self, r: int = 0):
        """Returns (board, r_used): r<=0 draws from the internal RNG."""
        board = self._board_buf()
        r_used = self._lib.tetris_clear(self._h, int(r), board)
        return board, r_used

    def step(self, action: int, r: int = 0):
        """Returns ((board, reward, done), r_used)."""
        board = self._board_buf()
        rew = ctypes.c_double()
        done = ctypes.c_int()
        r_used = self._lib.tetris_step(self._h, int(action), int(r), board,
                                       ctypes.byref(rew), ctypes.byref(done))
        return (board, rew.value, bool(done.value)), r_used

    def render(self) -> np.ndarray:
        board = self._board_buf()
        self._lib.tetris_render(self._h, board)
        return board

    @property
    def board(self) -> np.ndarray:
        """Persistent (piece-erased) board, like the reference's engine.board."""
        board = self._board_buf()
        self._lib.tetris_board(self._h, board)
        return board

    def piece_state(self):
        """Returns (anchor (x, y), piece_id, lock_counter, shape offsets)."""
        out = np.empty(4, np.int32)
        shape = np.empty(8, np.int32)
        self._lib.tetris_piece_state(self._h, out, shape)
        return ((int(out[0]), int(out[1])), int(out[2]), int(out[3]),
                [(int(shape[2 * k]), int(shape[2 * k + 1])) for k in range(4)])

    def valid_action_count(self) -> int:
        return int(self._lib.tetris_valid_action_count(self._h))

    def info(self) -> dict:
        out = np.empty(6, np.int32)
        counts = np.empty(7, np.int32)
        self._lib.tetris_info(self._h, out, counts)
        return {
            "time": int(out[0]),
            "current_piece": PIECE_NAMES[int(out[1])],
            "score": int(out[2]),
            "lines_cleared": int(out[3]),
            "holes": int(out[4]),
            "deaths": int(out[5]),
            "statistics": {n: int(c) for n, c in zip(PIECE_NAMES, counts)},
        }

    # -- reference TetrisEngine attribute names (tetris_env.py:125-181), for
    # user code that pokes ``env.engine`` directly --------------------------------
    @property
    def anchor(self):
        return self.piece_state()[0]

    @property
    def shape_name(self) -> str:
        return PIECE_NAMES[self.piece_state()[1]]

    @property
    def shape(self):
        return self.piece_state()[3]

    @property
    def shape_counts(self) -> dict:
        return self.info()["statistics"]

    @property
    def time(self) -> int:
        return self.info()["time"]

    @property
    def score(self) -> int:
        return self.info()["score"]

    @property
    def holes(self) -> int:
        return self.info()["holes"]

    @property
    def lines_cleared(self) -> int:
        return self.info()["lines_cleared"]

    @property
    def n_deaths(self) -> int:
        return self.info()["deaths"]

    def get_info(self) -> dict:
        return self.info()

    # -- checkpoint/resume (bit-identical; geometry/flags must match) -----------
    def save_state(self) -> np.ndarray:
        buf = np.empty(self._lib.tetris_state_size(self._h), np.uint8)
        self._lib.tetris_save(self._h, buf)
        return buf

    def load_state(self, buf: np.ndarray) -> None:
        buf = np.ascontiguousarray(buf, np.uint8)
        rc = self._lib.tetris_load(self._h, buf, buf.size)
        if rc == -1:
            raise ValueError(
                f"state size {buf.size} does not match this engine's geometry "
                f"(expected {self._lib.tetris_state_size(self._h)})")
        if rc == -2:
            raise ValueError(
                "snapshot header mismatch: width/height/flags of the saved "
                "engine differ from this engine's configuration")

    def drive(self, actions: np.ndarray, auto_clear: bool = True):
        """Run T steps with the internal RNG at native speed.

        Returns (boards u8[T, W, H], rewards f32[T], dones u8[T],
        r_step i32[T], r_clear i32[T]) — the r streams are the draws a parity
        harness must replay into the JAX engine (0 = no draw that step).
        """
        actions = np.ascontiguousarray(actions, dtype=np.int32)
        t = actions.shape[0]
        boards = np.empty((t, self.width, self.height), np.uint8)
        rewards = np.empty(t, np.float32)
        dones = np.empty(t, np.uint8)
        r_step = np.empty(t, np.int32)
        r_clear = np.empty(t, np.int32)
        self._lib.tetris_drive(self._h, actions, t, int(auto_clear),
                               boards, rewards, dones, r_step, r_clear)
        return boards, rewards, dones, r_step, r_clear
