"""Pack/unpack between bit-packed batch-minor rows and dense boards (port of
``gym_simpletetris_tpu.ops.bitops``).

Packed rows are int32 tensors carrying uint32 bits: ``[H, B]`` for
single-word boards, column x at bit ``x + XSHIFT``; ``[H, NW, B]`` for wide
boards, global bit ``x + XSHIFT`` in word ``(x + XSHIFT) // 32``. Every
function takes both layouts. The reference indexes its board ``board[x, y]``.
Every ``>>`` is masked with ``& 1``: an int32 right shift copies bit 31 down.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import EnvConfig, XSHIFT


def _word_of(x: int) -> int:
    return (x + XSHIFT) // 32


def _bit_of(x: int) -> int:
    return (x + XSHIFT) % 32


def _word_ranges(cfg: EnvConfig):
    """Per word w holding columns: (w, in-word shift of each of its columns as
    a list). The columns of word w follow those of word w - 1."""
    out = []
    for w in range(cfg.num_words):
        xs = [x for x in range(cfg.width) if _word_of(x) == w]
        if xs:
            out.append((w, [_bit_of(x) for x in xs]))
    return out


def _unpack(cfg: EnvConfig, rows: torch.Tensor, perm, dtype) -> torch.Tensor:
    """Packed rows -> cells. ``perm`` orders the (H, NW, B) axes of the word
    form; the word axis becomes the column axis W, its word w holding the
    columns that follow word w - 1's."""
    rows_w = (rows[:, None, :] if rows.dim() == 2 else rows).permute(*perm)
    axis = perm.index(1)
    shape = [1] * rows_w.dim()
    parts = []
    for w, sh in _word_ranges(cfg):
        shape[axis] = len(sh)
        shifts = torch.tensor(sh, dtype=torch.int32, device=rows.device)
        parts.append((rows_w.narrow(axis, w, 1) >> shifts.view(shape)) & 1)
    return torch.cat(parts, dim=axis).to(dtype)


def unpack_cells(cfg: EnvConfig, rows: torch.Tensor,
                 dtype=torch.uint8) -> torch.Tensor:
    """Packed rows -> dense [H, W, B] (still batch-minor)."""
    return _unpack(cfg, rows, (0, 1, 2), dtype)


def unpack_rows(cfg: EnvConfig, rows: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """Packed rows -> dense [B, H, W] (batch-major, image orientation)."""
    return _unpack(cfg, rows, (2, 0, 1), dtype)


def unpack_board(cfg: EnvConfig, rows: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Packed rows -> dense [B, W, H] in the reference's board[x, y] order."""
    return _unpack(cfg, rows, (2, 1, 0), dtype)


def pack_board(cfg: EnvConfig, board: np.ndarray) -> np.ndarray:
    """Dense (W, H) or (B, W, H) board[x, y] -> packed rows (host, numpy):
    uint32 [H] / [H, B] for single-word boards, [H, NW] / [H, NW, B] for
    wide ones."""
    board = np.asarray(board)
    single = board.ndim == 2
    if single:
        board = board[None]
    b, w, h = board.shape
    if (w, h) != (cfg.width, cfg.height):
        raise ValueError(f"board shape {board.shape} does not match "
                         f"width={cfg.width}, height={cfg.height}")
    nw = cfg.num_words
    rows = np.zeros((h, nw, b), dtype=np.uint32)
    for x in range(w):
        rows[:, _word_of(x), :] |= \
            (board[:, x, :] != 0).astype(np.uint32).T << np.uint32(_bit_of(x))
    if nw == 1:
        rows = rows[:, 0]
    return rows[..., 0] if single else rows
