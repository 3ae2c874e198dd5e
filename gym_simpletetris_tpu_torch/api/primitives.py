"""Host-side single-piece movement primitives (reference function surface;
port of ``gym_simpletetris_tpu.api.primitives``, pure numpy and unchanged).

The reference exposes its movement primitives as module-level functions
``f(shape, anchor, board) -> (shape, anchor)`` and wires them into
``TetrisEnv.value_action_map`` as *function objects* (tetris_env.py:39-73,
:152-161) — user code may look functions up by id, call them directly, or
invert the map. This module provides the same seven callables with identical
semantics, re-implemented from the behavioral spec (SURVEY.md §2.2; verified
against the reference by tests/test_env_parity.py::test_primitive_functions):

- ``shape`` is a sequence of (dx, dy) anchor-relative offsets (dy < 0 = up);
- ``anchor`` is (x, y); ``board`` is the (W, H) array indexed board[x, y];
- failed moves return the inputs unchanged;
- collision (``is_occupied``): cells with y < 0 skip *all* checks including
  x bounds (tetris_env.py:29-36); otherwise collide on x out of board,
  y >= height, or an occupied cell;
- ``rotated(cclk=True)`` maps (i, j) -> (-j, i) (clockwise, used by
  rotate_right); ``cclk=False`` maps (i, j) -> (j, -i) (rotate_left);
- ``hard_drop`` iterates soft_drop to its fixpoint.

These are the scalar spec of what the batched engine computes branchlessly on
device (core/engine.py, csrc/step.cu); they exist for API parity and
host-side tooling, not for throughput.
"""

from __future__ import annotations

import numpy as np


def rotated(shape, cclk: bool = False):
    """90-degree rotation of an offset list about the anchor
    (tetris_env.py:22-26): cclk=True -> (-j, i); cclk=False -> (j, -i)."""
    if cclk:
        return [(-j, i) for (i, j) in shape]
    return [(j, -i) for (i, j) in shape]


def is_occupied(shape, anchor, board) -> bool:
    """Cell-wise collision with the y<0 skip quirk (tetris_env.py:29-36)."""
    board = np.asarray(board)
    w, h = board.shape
    ax, ay = anchor
    for (dx, dy) in shape:
        x, y = int(ax + dx), int(ay + dy)
        if y < 0:
            continue                      # above-board cells skip ALL checks
        if x < 0 or x >= w or y >= h or board[x, y]:
            return True
    return False


def left(shape, anchor, board):
    new = (anchor[0] - 1, anchor[1])
    return (shape, anchor) if is_occupied(shape, new, board) else (shape, new)


def right(shape, anchor, board):
    new = (anchor[0] + 1, anchor[1])
    return (shape, anchor) if is_occupied(shape, new, board) else (shape, new)


def soft_drop(shape, anchor, board):
    new = (anchor[0], anchor[1] + 1)
    return (shape, anchor) if is_occupied(shape, new, board) else (shape, new)


def hard_drop(shape, anchor, board):
    while True:
        _, new = soft_drop(shape, anchor, board)
        if new == anchor:
            return shape, new
        anchor = new


def rotate_left(shape, anchor, board):
    new = rotated(shape, cclk=False)
    return (shape, anchor) if is_occupied(new, anchor, board) else (new, anchor)


def rotate_right(shape, anchor, board):
    new = rotated(shape, cclk=True)
    return (shape, anchor) if is_occupied(new, anchor, board) else (new, anchor)


def idle(shape, anchor, board):
    return shape, anchor


VALUE_ACTION_MAP = {
    0: left, 1: right, 2: hard_drop, 3: soft_drop,
    4: rotate_left, 5: rotate_right, 6: idle,
}
