"""Observation raster: packed board rows -> size x size uint8 images (port of
``gym_simpletetris_tpu.ops.raster``).

The geometry (``raster_geometry``, ``_axis_cells``, ``build_raster_maps``) is
the JAX package's host-side numpy, copied. Pixel semantics are the
reference's ``convert_grayscale``: border 0, background and gaps 128, an
occupied cell's block 190. The image of a (d0, d1) array is separable: pixel
(p, q) reads cell (a0[p], a1[q]) of the per-axis pixel -> cell maps, where
-1 is a gap and -2 the border.

``rasterize_rows_plain`` / ``raster_accumulate_plain`` are the plain PyTorch
versions: the CPU path of the port and the oracle of the CUDA raster kernel
(``csrc/raster.cu``, wrapped in ``ops/cuda_raster.py``). The JAX package's
matmul / gather / bcast / sep / sepb variants were a TPU formulation sweep of
this one function and are not ported.

Images are [B, H-axis, W-axis]: the board's rows run down the image, as
``rasterize(unpack_rows(rows), H, W, size)`` gives in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import EnvConfig
from .bitops import unpack_rows

BORDER_SHADE = 0
BACKGROUND_SHADE = 128
PIECE_SHADE = 190


def raster_geometry(d0: int, d1: int, size: int):
    """Static geometry for an image of a (d0, d1) array at ``size`` pixels.
    Returns (gap, block, inner0, inner1, pad0, pad1)."""
    limiting = max(d0, d1)
    gap = (size // 100) + 1
    block = ((size - 2 * gap) // limiting) - gap
    if block < 1:
        raise ValueError(
            f"board {d0}x{d1} too large to rasterize at {size}px "
            f"(block={block}); the reference would crash in np.repeat too")
    inner0 = gap + (block + gap) * d0
    inner1 = gap + (block + gap) * d1
    pad0 = (size - inner0) // 2
    pad1 = (size - inner1) // 2
    if pad0 < 0 or pad1 < 0:
        raise ValueError(f"board {d0}x{d1} does not fit at {size}px")
    return gap, block, inner0, inner1, pad0, pad1


def _axis_cells(d: int, size: int, gap: int, block: int, inner: int, pad: int):
    """Per-pixel classification along one axis: cell index or -1 (gap), -2 (border)."""
    idx = np.full(size, -2, dtype=np.int32)
    for p in range(pad, pad + inner):
        t = (p - pad) - gap
        if t < 0:
            idx[p] = -1
            continue
        i, rem = divmod(t, block + gap)
        idx[p] = i if rem < block else -1
    return idx


@functools.lru_cache(maxsize=64)
def axis_maps(d0: int, d1: int, size: int):
    """(a0 int32[size], a1 int32[size]): the per-axis pixel -> cell maps."""
    gap, block, inner0, inner1, pad0, pad1 = raster_geometry(d0, d1, size)
    return (_axis_cells(d0, size, gap, block, inner0, pad0),
            _axis_cells(d1, size, gap, block, inner1, pad1))


@functools.lru_cache(maxsize=64)
def build_raster_maps(d0: int, d1: int, size: int):
    """Host-side static maps: (base uint8[size,size], cell int32[size,size]).

    ``base`` is the image of an all-empty board; ``cell[p0,p1]`` is the flat cell
    index ``i0*d1 + i1`` whose occupancy bumps that pixel from 128 to 190, or -1
    for pixels that never depend on the board (border and gaps).
    """
    a0, a1 = axis_maps(d0, d1, size)
    border = (a0 == -2)[:, None] | (a1 == -2)[None, :]
    base = np.where(border, BORDER_SHADE, BACKGROUND_SHADE).astype(np.uint8)
    is_cell = (a0[:, None] >= 0) & (a1[None, :] >= 0)
    cell = np.where(is_cell, a0[:, None] * d1 + np.maximum(a1, 0)[None, :], -1)
    return base, cell.astype(np.int32)


def rasterize_host(cells: np.ndarray, d0: int, d1: int, size: int) -> np.ndarray:
    """Pure-numpy host raster: (..., d0, d1) 0/1 cells -> uint8
    (..., size, size)."""
    base, cell = build_raster_maps(d0, d1, size)
    cells = np.asarray(cells, dtype=np.uint8)
    lead = cells.shape[:-2]
    flat = np.concatenate([cells.reshape(lead + (d0 * d1,)),
                           np.zeros(lead + (1,), np.uint8)], axis=-1)
    idx = np.where(cell < 0, d0 * d1, cell)
    return base + np.uint8(PIECE_SHADE - BACKGROUND_SHADE) * flat[..., idx]


@functools.lru_cache(maxsize=64)
def device_axis_maps(d0: int, d1: int, size: int, device: torch.device):
    """``axis_maps`` as int32 tensors on ``device`` (the kernel's operands)."""
    return tuple(torch.as_tensor(a, device=device) for a in axis_maps(d0, d1, size))


def rasterize_rows_plain(cfg: EnvConfig, rows: torch.Tensor,
                         size: int = 84) -> torch.Tensor:
    """Packed rows int32[H, B] or [H, NW, B] -> uint8[B, size, size], plain
    PyTorch. Raises ValueError where ``raster_geometry`` does (at 84 px,
    boards wider or taller than 41 cells)."""
    a0, a1 = device_axis_maps(cfg.height, cfg.width, size, rows.device)
    cells = unpack_rows(cfg, rows, dtype=torch.uint8)         # [B, H, W]
    hit = cells[:, a0.clamp(min=0).long()][:, :, a1.clamp(min=0).long()]
    is_cell = (a0 >= 0)[:, None] & (a1 >= 0)[None, :]
    border = (a0 == -2)[:, None] | (a1 == -2)[None, :]
    base = torch.where(border, BORDER_SHADE, BACKGROUND_SHADE).to(torch.uint8)
    delta = PIECE_SHADE - BACKGROUND_SHADE
    return base + delta * (hit * is_cell.to(torch.uint8))


def raster_accumulate_plain(cfg: EnvConfig, rows: torch.Tensor,
                            acc: torch.Tensor, size: int = 84) -> torch.Tensor:
    """``acc += raster(rows)`` in place, with uint8 wraparound; returns acc."""
    acc += rasterize_rows_plain(cfg, rows, size)
    return acc


def grayscale_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """HxW -> HxWx3 channel triple (``convert_grayscale_rgb``), as an
    ``expand`` view: the three channels are the same values."""
    return img[..., None].expand(img.shape + (3,))
