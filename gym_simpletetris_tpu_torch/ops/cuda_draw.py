"""The engine's spawn draw on the card: CUDA draw kernel (``csrc/draw.cu``).

``draw`` takes the state's key, its ``shape_counts`` and its ``env_offset``
and returns (carry key int32[2], r int32[B]) from one launch, bitwise what
``core.engine.spawn_draw_plain`` (``threefry.split`` and
``threefry.draw_spawn_r``) gives; with ``injected_r`` the kernel writes the
carry key alone and ``r`` is the injected one. ``core.engine.spawn_draw``
calls it for a CUDA state; a CPU state takes the plain draw. The counter
``kernel.draw.launches`` (``utils/profiling.py``) counts its launches.

The kernel replaces no Pallas kernel: the JAX package draws with
``jax.random``, which XLA fuses. At two draws a rollout step this wrapper's
Python is the draw's whole host cost, so it does the least a call: one
output buffer cut into r and the key, launch constants cached by batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.profiling import count
from . import _build
from .cuda_step import _stream, check_tensor

_I32 = torch.int32
_KEY = torch.Size((2,))


class _Call(NamedTuple):
    """What a draw at (B, device) needs besides the tensors."""
    counts_shape: torch.Size   # [7, B]
    sizes: tuple               # the output buffer cut into (r, key)
    total: int


_calls: dict = {}


def _call(B: int, index: int) -> _Call:
    k = (B, index)
    hit = _calls.get(k)
    if hit is None:
        if len(_calls) > 256:
            _calls.clear()
        hit = _calls[k] = _Call(torch.Size((7, B)), (B, 2), B + 2)
    return hit


def draw(key: torch.Tensor, counts: torch.Tensor, env_offset: int = 0,
         injected_r: Optional[torch.Tensor] = None):
    """(carry key int32[2], r int32[B]) of one spawn draw on ``key``'s card
    for the envs [env_offset, env_offset + B) of the global batch, B =
    ``counts.shape[1]``. ``injected_r`` replaces the threefry draws."""
    index = key.get_device()
    B = counts.shape[-1]
    call = _call(B, index)
    if not (key.dtype is _I32 and key.shape == _KEY and key.is_contiguous()
            and counts.dtype is _I32 and counts.get_device() == index
            and counts.shape == call.counts_shape and counts.is_contiguous()):
        check_tensor("key", key, _KEY, _I32, key.device)
        check_tensor("shape_counts", counts, call.counts_shape, _I32,
                     key.device)
    if injected_r is None:
        r, key_out = torch.empty(call.total, dtype=_I32,
                                 device=key.device).split_with_sizes(call.sizes)
        counts_ptr, r_ptr = counts.data_ptr(), r.data_ptr()
    else:
        r = torch.as_tensor(injected_r, device=key.device).to(_I32).contiguous()
        key_out = torch.empty(2, dtype=_I32, device=key.device)
        counts_ptr = r_ptr = None
    err = _build.load_library().tetris_draw_launch(
        key.data_ptr(), counts_ptr, r_ptr, key_out.data_ptr(), B, env_offset,
        index, _stream(index))
    if err != 0:
        raise RuntimeError(f"draw kernel launch failed: CUDA error {err}")
    count("kernel.draw.launches")
    return key_out, r
