"""The episode reset on the card: CUDA reset kernel (``csrc/reset.cu``).

``reset`` takes the state the reset applies to, the clear's spawn draws
``r`` and its carry key (``core.engine.spawn_draw`` makes both, so injected
and threefry draws go through one kernel), and with a mask the emitted rows
and the state the selected envs are cleared from; it returns (state,
emitted rows) from one launch, bitwise what ``api.env.apply_reset_mask_plain``
gives with a mask and ``core.engine.clear_plain`` without one (every env
resets). ``api.env.apply_reset_mask`` and ``core.engine.engine_clear`` call
it for a CUDA state; a CPU state takes the plain body. The counter
``kernel.reset.launches`` (``utils/profiling.py``) counts its launches.

The kernel replaces no Pallas kernel: the JAX package resets with
``jnp.where``, which XLA fuses. The outputs are views of two new buffers:
the state's (rows, counts and the 11 scalars in one, cut as
``ops/cuda_step._launch`` cuts kernel A's) and the emitted rows', a buffer
of their own so that the state a caller keeps holds no emitted board (it
is freed with the observation, as the plain reset's is). No input is
written, so a caller may still read the state it passed (the stepped
``lines_cleared`` that ``step_fn``'s ``lines_delta`` reads, the states the
vector core and the soak tool hold).
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import torch

from ..core.config import EnvConfig
from ..core.state import EnvState, SCALAR_FIELDS, rows_shape
from ..utils.profiling import count, span
from . import _build
from .cuda_step import _stream, check_tensor

_I32 = torch.int32

# The launch's arguments in one record (csrc/reset.cu ResetArgs): the 19
# input pointers (the applied-to state's rows, 11 scalars and counts; the
# cleared-from state's lock, deaths and counts; emitted rows, mask, r), the
# two output buffers, the stream; H, NW, B, spawn_x, the device and a pad
# word.
_ARGS = struct.Struct("<22Q6i")
# the int32 inputs in the record's order, the mask left out
_IN_NAMES = ("rows",) + SCALAR_FIELDS + (
    "shape_counts", "cleared_from.lock", "cleared_from.deaths",
    "cleared_from.shape_counts", "emitted", "r")
_CLEAR_NAMES = _IN_NAMES[13:16] + ("r",)
_NO_STATE = (0,) * 13    # a reset of every env reads none of the state


class _Call(NamedTuple):
    """What a reset at (cfg, B, device) needs besides the tensors."""
    cfg: EnvConfig
    in_shapes: tuple      # the int32 inputs' torch.Size (_IN_NAMES)
    clear_shapes: tuple   # and those a reset of every env reads
    one: torch.Size       # [B]
    state_sizes: tuple    # the state buffer cut into rows, counts, scalars
    state_total: int
    rows_shape: torch.Size   # the rows' and the emitted rows' shape
    counts_shape: torch.Size
    ints: tuple           # the record's 6 int32 words


_calls: dict = {}


def _call(cfg: EnvConfig, B: int, index: int) -> _Call:
    """The launch constants, cached by the config's identity (as
    ``cuda_step._call``)."""
    k = (id(cfg), B, index)
    hit = _calls.get(k)
    if hit is not None and hit.cfg is cfg:
        return hit
    H, NW = cfg.height, cfg.num_words
    shape = torch.Size(rows_shape(cfg, B))
    one = torch.Size((B,))
    counts = torch.Size((7, B))
    clear = (one, one, counts, one)
    sizes = (H * NW * B, 7 * B) + (B,) * len(SCALAR_FIELDS)
    hit = _Call(cfg, (shape,) + (one,) * len(SCALAR_FIELDS) + (counts,)
                + clear[:3] + (shape, one), clear, one, sizes, sum(sizes),
                shape, counts, (H, NW, B, cfg.spawn_x, index, 0))
    if len(_calls) > 256:
        _calls.clear()
    _calls[k] = hit
    return hit


@span("kernel.reset")
def reset(cfg: EnvConfig, state: EnvState, r: torch.Tensor, key: torch.Tensor,
          emitted: Optional[torch.Tensor] = None,
          mask: Optional[torch.Tensor] = None,
          cleared_from: Optional[EnvState] = None):
    """(state, emitted rows) of the reset on ``state``'s card: the envs of
    ``mask`` (bool[B]; None: every env) cleared from ``cleared_from``
    (default ``state``) with the draws ``r`` (int32[B]), the others keeping
    ``state`` and ``emitted``; ``key`` becomes the new state's key. Without
    a mask neither ``state``'s per-env fields nor ``emitted`` are read."""
    src = state if cleared_from is None else cleared_from
    index = src.rows.get_device()
    call = _call(cfg, src.rows.shape[-1], index)
    if mask is None:
        ins, shapes, names = ((src.lock, src.deaths, src.shape_counts, r),
                              call.clear_shapes, _CLEAR_NAMES)
    else:
        s = state
        ins, shapes, names = ((
            s.rows, s.piece, s.rot, s.ax, s.ay, s.lock, s.time, s.score,
            s.holes, s.lines_cleared, s.piece_height, s.deaths,
            s.shape_counts, src.lock, src.deaths, src.shape_counts, emitted,
            r), call.in_shapes, _IN_NAMES)
    dev = src.rows.device
    for t, shape in zip(ins, shapes):
        if not (t.dtype is _I32 and t.get_device() == index
                and t.shape == shape and t.is_contiguous()):
            for name, u, shp in zip(names, ins, shapes):
                check_tensor(name, u, shp, _I32, dev)
    if mask is None:
        ptrs = _NO_STATE + tuple(t.data_ptr() for t in ins[:3]) + (0, 0)
    else:
        if not (mask.dtype is torch.bool and mask.get_device() == index
                and mask.shape == call.one and mask.is_contiguous()):
            check_tensor("mask", mask, call.one, torch.bool, dev)
        ptrs = tuple(t.data_ptr() for t in ins[:17]) + (mask.data_ptr(),)
    buf = torch.empty(call.state_total, dtype=_I32, device=dev)
    emitted_out = torch.empty(call.rows_shape, dtype=_I32, device=dev)
    err = _build.load_library().tetris_reset_launch(_ARGS.pack(
        *ptrs, r.data_ptr(), buf.data_ptr(), emitted_out.data_ptr(),
        _stream(index), *call.ints))
    if err != 0:
        raise RuntimeError(f"reset kernel launch failed: CUDA error {err}")
    count("kernel.reset.launches")
    rows_out, counts, *scalars = buf.split_with_sizes(call.state_sizes)
    return EnvState(rows_out.view(call.rows_shape), *scalars,
                    counts.view(call.counts_shape), key,
                    env_offset=state.env_offset), emitted_out
