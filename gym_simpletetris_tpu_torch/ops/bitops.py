"""Pack/unpack between bit-packed batch-minor rows and dense boards (port of
``gym_simpletetris_tpu.ops.bitops``, single-word rows).

Packed rows are int32[H, B] carrying uint32 bits, column x at bit
``x + XSHIFT``. The reference indexes its board ``board[x, y]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import EnvConfig, XSHIFT


def _shifts(cfg: EnvConfig, device) -> torch.Tensor:
    return torch.arange(cfg.width, dtype=torch.int32, device=device) + XSHIFT


def unpack_cells(cfg: EnvConfig, rows: torch.Tensor,
                 dtype=torch.uint8) -> torch.Tensor:
    """Packed rows -> dense [H, W, B] (still batch-minor)."""
    sh = _shifts(cfg, rows.device)[None, :, None]
    return ((rows[:, None, :] >> sh) & 1).to(dtype)


def unpack_rows(cfg: EnvConfig, rows: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """Packed rows -> dense [B, H, W] (batch-major, image orientation)."""
    sh = _shifts(cfg, rows.device)[None, None, :]
    return ((rows.T[:, :, None] >> sh) & 1).to(dtype)


def unpack_board(cfg: EnvConfig, rows: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Packed rows -> dense [B, W, H] in the reference's board[x, y] order."""
    sh = _shifts(cfg, rows.device)[None, :, None]
    return ((rows.T[:, None, :] >> sh) & 1).to(dtype)


def pack_board(cfg: EnvConfig, board: np.ndarray) -> np.ndarray:
    """Dense (W, H) or (B, W, H) board[x, y] -> packed rows (host, numpy):
    uint32 [H] or [H, B]."""
    board = np.asarray(board)
    single = board.ndim == 2
    if single:
        board = board[None]
    b, w, h = board.shape
    if (w, h) != (cfg.width, cfg.height):
        raise ValueError(f"board shape {board.shape} does not match "
                         f"width={cfg.width}, height={cfg.height}")
    rows = np.zeros((h, b), dtype=np.uint32)
    for x in range(w):
        rows |= (board[:, x, :] != 0).astype(np.uint32).T << np.uint32(x + XSHIFT)
    return rows[:, 0] if single else rows
