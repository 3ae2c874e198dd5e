"""The engine transition: CUDA step kernel (``csrc/step.cu``) or plain PyTorch.

``step`` takes the state, the actions, this step's spawn draws and the
advanced key (``core.engine.spawn_draw`` makes both outside the kernel, so
injected and threefry draws go through one kernel). A CPU state goes to
``core.engine.transition_plain``; a CUDA state launches the kernel, which
replaces the Pallas TPU kernel ``gym_simpletetris_tpu/ops/pallas_step.py``;
any other device raises. The counter ``kernel.step.launches``
(``utils/profiling.py``) counts kernel launches. Rows are
[H, B] for single-word boards and [H, NW, B] for wide ones.

The kernel has three instances, all hand-written: a warp per env over a
shared-memory tile of envs (boards up to ``WARP_MAX_H`` rows), a thread per
env over its board staged in shared memory, and a thread per env reading
global memory (every board). ``launch_plan`` picks the instance and its
launch shape from (H, NW, B); the kernel launches what it is given.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from ..core.config import EnvConfig
from ..core.engine import StepOut, transition_plain
from ..core.state import EnvState, SCALAR_FIELDS, rows_shape
from ..utils.profiling import count, span
from . import _build

_FLAGS = ("reward_step", "penalise_height", "penalise_height_increase",
          "advanced_clears", "high_scoring", "penalise_holes",
          "penalise_holes_increase", "step_reset")

WARP_MAX_H = 32            # the warp instance holds a board row per lane
SMEM_MAX = 232448          # dynamic shared memory a block may use (H100)
STAGED_SMEM_MAX = 48 * 1024   # the staged thread instance's tile
H100_SMS = 132
_REC_WORDS = 37            # an env's record in the tile (csrc/step.cu kRec)
_THREADS = 128             # a block of the global thread-per-env instance
_STAGED_THREADS = 64       # and of the staged one, where its tile fits
# The batch from which the staged thread instance beats the warp one, for
# rows of 1, 2, and 3 or more words. The warp instance's time grows with B
# (1.0-1.9 us per 1000 envs on the H100, more for wider rows), the staged
# thread one's stays flat to about B = 16384 (11, 25 and 27 us). Read at
# 10x20, 32x20 and 100x20 (PERF.md, PR 5), interpolated between B = 8192
# and 16384; at 10x32 it lies near 11400. Where the staged tile does not
# fit, the warp instance wins at every timed B (115 against 608 us at
# 1024x20, B = 16384), so it keeps every H <= WARP_MAX_H there.
THREAD_FROM_B = (9000, 16000, 13000)
_I32 = torch.int32


def config_flags(cfg: EnvConfig) -> int:
    """The EnvConfig flags as the kernel's bit set (csrc/step.cu)."""
    return sum(1 << i for i, f in enumerate(_FLAGS) if getattr(cfg, f))


def check_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


class StepPlan(NamedTuple):
    """How ``tetris_step_launch`` runs one step."""
    instance: str    # one of INSTANCES
    log_e: int       # warp: log2 of E, the envs of a block's tile
    threads: int     # a block's threads (32 * E for the warp instance)
    blocks: int
    smem: int        # dynamic shared memory bytes of a block


# "warp": a warp per env over a tile of envs; "thread": a thread per env
# over its board staged in shared memory; "thread_global": a thread per env
# reading its board in global memory (boards whose tile does not fit).
INSTANCES = ("warp", "thread", "thread_global")
_CODES = {"thread_global": 0, "warp": 1, "thread": 2}   # csrc/step.cu


def _staged_threads(H: int, NW: int) -> int | None:
    """A block's threads for the staged thread instance: 64, halved to 32
    where the tile (4 * threads * H * NW bytes) would pass STAGED_SMEM_MAX;
    None where it never fits."""
    for t in (_STAGED_THREADS, 32):
        if 4 * t * H * NW <= STAGED_SMEM_MAX:
            return t
    return None


def instances_for(H: int, NW: int) -> tuple:
    """The instances that can run a board of H rows of NW words."""
    return tuple(i for i, ok in zip(INSTANCES, (
        H <= WARP_MAX_H, _staged_threads(H, NW) is not None, True))
        if ok)


def launch_plan(H: int, NW: int, B: int, sms: int = H100_SMS,
                instance: str | None = None) -> StepPlan:
    """The launch of one step at (H, NW, B) on a card with ``sms`` SMs.
    ``instance`` forces one of INSTANCES ("warp" needs H <= WARP_MAX_H,
    "thread" a tile that fits); by default the warp instance takes every
    H <= WARP_MAX_H below the ``THREAD_FROM_B`` of its NW, and at any B
    where the staged tile does not fit; the staged thread instance the rest
    where its tile fits, and the global one what remains.

    Warp instance: one warp per env, a tile of E = 32 envs a block once
    the batch gives each SM 16 envs, else E = 8 (a 32-byte sector per row
    word; below that, more blocks beat fewer); the tile holds E records of
    ``_REC_WORDS`` words and E boards of H * NW words at an odd stride.
    Thread instances: 128 envs a block on global memory; 64 staged (32
    where the tile would pass STAGED_SMEM_MAX), 2-3% faster than 32, 128
    or 256 at B = 512-65536 on the H100 (PERF.md, PR 5)."""
    if instance is None:
        staged = _staged_threads(H, NW) is not None
        if H <= WARP_MAX_H and (B < THREAD_FROM_B[min(NW, 3) - 1]
                                or not staged):
            instance = "warp"
        else:
            instance = "thread" if staged else "thread_global"
    if instance == "thread_global":
        return StepPlan("thread_global", 0, _THREADS, -(-B // _THREADS), 0)
    if instance == "thread":
        t = _staged_threads(H, NW)
        if t is None:
            raise ValueError(f"the staged thread instance's tile does not "
                             f"fit at H = {H}, NW = {NW}")
        return StepPlan("thread", 0, t, -(-B // t), 4 * t * H * NW)
    if instance != "warp":
        raise ValueError(f"no step kernel instance {instance!r}")
    if not 1 <= H <= WARP_MAX_H:
        raise ValueError(f"the warp instance takes H <= {WARP_MAX_H}, got {H}")
    log_e = 5 if B >= 16 * sms else 3
    smem = 4 * (1 << log_e) * (_REC_WORDS + (H * NW | 1))
    return StepPlan("warp", log_e, 32 << log_e, -(-B // (1 << log_e)), smem)


def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def out_sizes(H: int, NW: int, B: int) -> tuple:
    """The kernel's two int32 output buffers: (rows of the boards buffer
    [rows, B]: rows_out and emitted, H * NW each, then the 7 counts; words
    of the small buffer: the 11 scalars, the reward's float32 bits, and
    done as B bools in whole words)."""
    return ((H * NW, H * NW, 7),
            (B,) * len(SCALAR_FIELDS) + (B, -(-B // 4)))


@span("kernel.step")
def step(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
         r_draw: torch.Tensor, key: torch.Tensor) -> StepOut:
    """One transition with draws ``r_draw`` int32[B]; ``key`` becomes the
    new state's key."""
    if state.rows.is_cuda:
        return _launch(cfg, state, action, r_draw, key)
    dev = state.rows.device
    if dev.type == "cpu":
        return transition_plain(cfg, state, action, r_draw, key)
    raise ValueError(f"no step implementation for device {dev}")

# The launch's arguments in one record (csrc/step.cu LaunchArgs): the 15
# input pointers, the two output buffers, the stream; H, NW, B, width,
# lock_mod, spawn_x, flags, the plan (instance, log_e, threads, blocks,
# smem), the device and a pad word.
_ARGS = struct.Struct("<18Q14i")
_IN_NAMES = ("rows",) + SCALAR_FIELDS + ("shape_counts", "action", "r_draw")


class _Call(NamedTuple):
    """What a launch at (cfg, B, device) needs besides the tensors."""
    cfg: EnvConfig
    in_shapes: tuple     # the 15 inputs' torch.Size, in the kernel's order
    board_rows: tuple    # out_sizes
    small_sizes: tuple
    boards_shape: tuple  # the boards buffer [rows, B]
    small_total: int
    ints: tuple          # the record's 14 int32 words
    rows_shape: torch.Size | None   # where the [H * NW, B] piece needs a view


_calls: dict = {}


def _call(cfg: EnvConfig, B: int, index: int, instance) -> _Call:
    """The launch constants, cached by the config's identity (a frozen
    dataclass hashes all its fields, which costs more than the lookup)."""
    k = (id(cfg), B, index, instance)
    hit = _calls.get(k)
    if hit is not None and hit.cfg is cfg:
        return hit
    H, NW = cfg.height, cfg.num_words
    plan = launch_plan(H, NW, B, _sm_count(index), instance)
    board_rows, small_sizes = out_sizes(H, NW, B)
    shape = torch.Size(rows_shape(cfg, B))
    one = torch.Size((B,))
    hit = _Call(cfg, (shape,) + (one,) * len(SCALAR_FIELDS)
                + (torch.Size((7, B)), one, one), board_rows, small_sizes,
                (sum(board_rows), B), sum(small_sizes),
                (H, NW, B, cfg.width, cfg.lock_modulus, cfg.spawn_x,
                 config_flags(cfg), _CODES[plan.instance], plan.log_e,
                 plan.threads, plan.blocks, plan.smem, index, 0),
                shape if NW > 1 else None)
    if len(_calls) > 256:
        _calls.clear()
    _calls[k] = hit
    return hit


def _stream(index: int) -> int:
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
            r_draw: torch.Tensor, key: torch.Tensor,
            instance: str | None = None) -> StepOut:
    """The kernel on ``state``'s card; ``instance`` forces the plan's
    (``launch_plan``), to time and check each instance. The outputs are views of two
    buffers, cut so that at NW = 1 none but reward and done needs a view
    of its own (a Python-side view costs about as much as a launch)."""
    rows = state.rows
    index = rows.get_device()
    B = rows.shape[-1]
    call = _call(cfg, B, index, instance)
    ins = (rows, state.piece, state.rot, state.ax, state.ay, state.lock,
           state.time, state.score, state.holes, state.lines_cleared,
           state.piece_height, state.deaths, state.shape_counts, action,
           r_draw)
    for t, shape in zip(ins, call.in_shapes):
        if not (t.dtype is _I32 and t.get_device() == index
                and t.shape == shape and t.is_contiguous()):
            for name, u, shp in zip(_IN_NAMES, ins, call.in_shapes):
                check_tensor(name, u, shp, _I32, rows.device)
    boards = torch.empty(call.boards_shape, dtype=_I32, device=rows.device)
    small = torch.empty(call.small_total, dtype=_I32, device=rows.device)
    err = _build.load_library().tetris_step_launch(_ARGS.pack(
        *[t.data_ptr() for t in ins], boards.data_ptr(), small.data_ptr(),
        _stream(index), *call.ints))
    if err != 0:
        raise RuntimeError(f"step kernel launch failed: CUDA error {err}")
    count("kernel.step.launches")
    rows_out, emitted, counts = boards.split_with_sizes(call.board_rows)
    if call.rows_shape is not None:
        rows_out = rows_out.view(call.rows_shape)
        emitted = emitted.view(call.rows_shape)
    *scalars, reward, done = small.split_with_sizes(call.small_sizes)
    done = done.view(torch.bool)
    return StepOut(EnvState(rows_out, *scalars, counts, key,
                            env_offset=state.env_offset), emitted,
                   reward.view(torch.float32), done[:B] if B % 4 else done)
