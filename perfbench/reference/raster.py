"""The reference's observations in plain NumPy.

``convert_grayscale(board, size)`` of gym-simpletetris
(``tetris_env.py:76-114``; SURVEY.md §2.4): the (W, H) board is transposed,
so image rows run along y; the image is ``size`` x ``size`` with
``gap = size // 100 + 1`` and ``block = (size - 2 * gap) // max(W, H) -
gap``; the grid of blocks and gaps (``gap + (block + gap) * cells`` pixels
along each axis) sits centred, its offset the floor of half the spare
pixels; padding is 0, gaps and empty blocks 128, filled blocks 190.

``image`` fills each cell's block with the cell's value. It takes integer
cell values, not only 0 / 1, so that a sum of boards renders to the sum of
their images (the shade of a block is ``128 + 62 * value`` where the grid
lies), which is how a rollout's accumulated image is checked. Imports
nothing but NumPy.
"""

from __future__ import annotations

import functools

import numpy as np

BACKGROUND, PIECE = 128, 190


@functools.lru_cache(maxsize=16)
def _maps(d0: int, d1: int, size: int):
    """(base int64 [size, size], cell int64 [size, size]): the image of an
    empty board, and the flat cell index i0 * d1 + i1 that each pixel of a
    block shows (-1 elsewhere), drawn block by block."""
    gap = size // 100 + 1
    block = (size - 2 * gap) // max(d0, d1) - gap
    if block < 1:
        raise ValueError(f"a {d0} x {d1} board does not fit in {size} px")
    inner = [gap + (block + gap) * d for d in (d0, d1)]
    pad = [(size - i) // 2 for i in inner]
    base = np.zeros((size, size), np.int64)
    base[pad[0]:pad[0] + inner[0], pad[1]:pad[1] + inner[1]] = BACKGROUND
    cell = np.full((size, size), -1, np.int64)
    for i0 in range(d0):
        p0 = pad[0] + gap + i0 * (block + gap)
        for i1 in range(d1):
            p1 = pad[1] + gap + i1 * (block + gap)
            cell[p0:p0 + block, p1:p1 + block] = i0 * d1 + i1
    return base, cell


def image(cells: np.ndarray, size: int = 84, images: int = 1) -> np.ndarray:
    """Cells [..., d0, d1] (integers) -> int64 [..., size, size]:
    ``images * base + (PIECE - BACKGROUND) * value`` on every pixel, the
    value 0 off the blocks: the sum of ``images`` images whose cells sum to
    ``cells``."""
    d0, d1 = cells.shape[-2:]
    base, cell = _maps(d0, d1, size)
    lead = cells.shape[:-2]
    flat = np.concatenate([cells.reshape(lead + (d0 * d1,)).astype(np.int64),
                           np.zeros(lead + (1,), np.int64)], axis=-1)
    idx = np.where(cell < 0, d0 * d1, cell)
    return images * base + (PIECE - BACKGROUND) * flat[..., idx]


def grayscale(boards: np.ndarray, size: int = 84) -> np.ndarray:
    """Boards [..., W, H] (0 / 1) -> the grayscale observation, float32
    [..., size, size], image rows along y."""
    return image(np.swapaxes(boards, -1, -2), size).astype(np.float32)
