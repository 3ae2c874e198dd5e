"""The observation raster: CUDA raster kernel (``csrc/raster.cu``) or plain
PyTorch.

Two wrappers over one kernel:

- ``rasterize_rows`` replaces the Pallas TPU kernel ``_build_kernel`` of
  ``gym_simpletetris_tpu/ops/pallas_raster.py`` (``rasterize_rows_pallas``):
  packed rows -> a new uint8 image;
- ``raster_accumulate`` replaces ``_build_acc_kernel`` (``raster_accumulate``):
  ``acc += image`` with uint8 wraparound, in place (the TPU kernel aliased
  ``acc`` to its output instead).

A CPU tensor goes to the plain versions in ``ops/raster.py``, a CUDA tensor
to the kernel, anything else raises. Rows are [H, B] for single-word boards
and [H, NW, B] for wide ones, at every width the geometry admits. Each
wrapper's ``launches`` counts its kernel launches.

The kernel's work items are bands of an image's pixel rows, each holding
whole cell rows (``raster_bands``); a block builds the pixel pattern of each
cell row of its band once and copies it to every pixel row of that cell.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import EnvConfig
from ..core.state import rows_shape
from .cuda_step import check_tensor
from .raster import (device_axis_maps, raster_geometry, rasterize_rows_plain,
                     raster_accumulate_plain)

_MAX_SIZE = 4096   # the per-column tables and two bands fit in shared memory
_BAND_BYTES = 32768   # about the image bytes of one work item


@functools.lru_cache(maxsize=64)
def raster_bands(d0: int, d1: int, size: int):
    """The kernel's work split of an image of a (d0, d1) board: (R, starts).
    Band k holds cell rows [k * R, min((k + 1) * R, d0)) and pixel rows
    [starts[k], starts[k + 1]): the first band starts at the image's top,
    each later one at the gap above its first cell row, and the last ends at
    the image's bottom. R keeps a band's image near ``_BAND_BYTES`` (so its
    cell-row patterns, R * size bytes, fit in shared memory) and is the
    whole board at 84 and 160 px."""
    gap, block, _, _, pad0, _ = raster_geometry(d0, d1, size)
    pitch = block + gap
    R = max(1, min(d0, _BAND_BYTES // size // pitch))
    n = -(-d0 // R)
    starts = [0] + [pad0 + k * R * pitch for k in range(1, n)] + [size]
    return R, np.asarray(starts, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def _device_bands(d0: int, d1: int, size: int, device: torch.device):
    R, starts = raster_bands(d0, d1, size)
    return R, torch.as_tensor(starts, device=device)


def rasterize_rows(cfg: EnvConfig, rows: torch.Tensor,
                   size: int = 84) -> torch.Tensor:
    """Packed rows int32[H, B] or [H, NW, B] -> uint8[B, size, size]."""
    if rows.device.type == "cpu":
        return rasterize_rows_plain(cfg, rows, size)
    if rows.device.type != "cuda":
        raise ValueError(f"no raster implementation for device {rows.device}")
    out = torch.empty((rows.shape[-1], size, size), dtype=torch.uint8,
                      device=rows.device)
    _launch(cfg, rows, out, size, accumulate=False)
    rasterize_rows.launches += 1
    return out


rasterize_rows.launches = 0


def raster_accumulate(cfg: EnvConfig, rows: torch.Tensor, acc: torch.Tensor,
                      size: int = 84) -> torch.Tensor:
    """``acc += raster(rows)`` in place (uint8 wraparound); returns ``acc``."""
    if rows.device.type == "cpu":
        return raster_accumulate_plain(cfg, rows, acc, size)
    if rows.device.type != "cuda":
        raise ValueError(f"no raster implementation for device {rows.device}")
    _launch(cfg, rows, acc, size, accumulate=True)
    raster_accumulate.launches += 1
    return acc


raster_accumulate.launches = 0


def _launch(cfg: EnvConfig, rows: torch.Tensor, out: torch.Tensor, size: int,
            accumulate: bool) -> None:
    from ._build import load_library
    dev = rows.device
    H, NW, B = cfg.height, cfg.num_words, rows.shape[-1]
    if not 0 < size <= _MAX_SIZE:
        raise ValueError(f"size={size} outside (0, {_MAX_SIZE}]")
    check_tensor("rows", rows, rows_shape(cfg, B), torch.int32, dev)
    check_tensor("acc" if accumulate else "out", out, (B, size, size),
                 torch.uint8, dev)
    if out.data_ptr() % 4:
        raise ValueError("the image tensor must be 4-byte aligned")
    a0, a1 = device_axis_maps(H, cfg.width, size, dev)
    R, bands = _device_bands(H, cfg.width, size, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load_library().tetris_raster_launch(
        rows.data_ptr(), H, NW, B, a0.data_ptr(), a1.data_ptr(),
        bands.data_ptr(), bands.numel() - 1, R, size, out.data_ptr(),
        int(accumulate),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {err}")
