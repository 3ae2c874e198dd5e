"""Tetromino piece tables as numpy constants (no JAX).

Each of the 7 tetrominoes is 4 ``(dx, dy)`` offsets around an anchor cell
(negative ``dy`` points up; board row 0 is the top). Rotation is an integer
``rot in [0, 4)`` counting clockwise steps ``(i, j) -> (-j, i)``, and every
``(piece, rot)`` pair is expanded once into per-relative-row bitmasks:

- ``OFFSETS[piece, rot, cell, 2]``: the raw (dx, dy) offsets.
- ``ROWMASKS[piece, rot, NROWS]``: row ``k`` covers ``dy = k - DY_OFF``; bit
  ``dx + DX_OFF`` is set for each cell in that row. The engine shifts these
  left by the anchor x to get board-row masks.

The same table is compiled into ``csrc/step.cu`` as a ``__constant__`` array;
``tests/test_torch_tables.py`` holds both copies against the JAX package.
"""

from __future__ import annotations

import numpy as np

# Order matches the reference's shape_names: the count-balanced sampler walks
# pieces in this order.
PIECE_NAMES = ("T", "J", "L", "Z", "S", "I", "O")

_BASE_OFFSETS = {
    "T": ((0, 0), (-1, 0), (1, 0), (0, -1)),
    "J": ((0, 0), (-1, 0), (0, -1), (0, -2)),
    "L": ((0, 0), (1, 0), (0, -1), (0, -2)),
    "Z": ((0, 0), (-1, 0), (0, -1), (1, -1)),
    "S": ((0, 0), (-1, -1), (0, -1), (1, 0)),
    "I": ((0, 0), (0, -1), (0, -2), (0, -3)),
    "O": ((0, 0), (0, -1), (-1, 0), (-1, -1)),
}

NUM_PIECES = 7
NUM_ROTS = 4
NUM_CELLS = 4

DX_OFF = 3  # stored bit for a cell = dx + DX_OFF, in [0, 6]
DY_OFF = 3  # relative row k covers dy = k - DY_OFF, k in [0, 6]
NROWS = 7   # relative rows spanned by any piece: dy in [-3, 3]


def rotate_cw(cells):
    """One clockwise rotation step: (i, j) -> (-j, i)."""
    return tuple((-j, i) for (i, j) in cells)


def _build_offsets() -> np.ndarray:
    out = np.zeros((NUM_PIECES, NUM_ROTS, NUM_CELLS, 2), dtype=np.int8)
    for p, name in enumerate(PIECE_NAMES):
        cells = _BASE_OFFSETS[name]
        for r in range(NUM_ROTS):
            for c, (dx, dy) in enumerate(cells):
                out[p, r, c, 0] = dx
                out[p, r, c, 1] = dy
            cells = rotate_cw(cells)
    return out


def _build_rowmasks(offsets: np.ndarray) -> np.ndarray:
    masks = np.zeros((NUM_PIECES, NUM_ROTS, NROWS), dtype=np.uint32)
    for p in range(NUM_PIECES):
        for r in range(NUM_ROTS):
            for c in range(NUM_CELLS):
                dx = int(offsets[p, r, c, 0])
                dy = int(offsets[p, r, c, 1])
                masks[p, r, dy + DY_OFF] |= np.uint32(1) << np.uint32(dx + DX_OFF)
    return masks


OFFSETS = _build_offsets()
OFFSETS.setflags(write=False)

ROWMASKS = _build_rowmasks(OFFSETS)
ROWMASKS.setflags(write=False)

# Flat [NUM_PIECES * NUM_ROTS, NROWS] view, indexed by piece*4 + rot.
ROWMASKS_FLAT = np.ascontiguousarray(ROWMASKS.reshape(NUM_PIECES * NUM_ROTS, NROWS))
ROWMASKS_FLAT.setflags(write=False)
