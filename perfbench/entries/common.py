"""What the entries' modules share: the card's synchronisation, the envs compared,
the program's packed board rows read back as boards, and mismatch counts."""

from __future__ import annotations

import numpy as np


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sample_envs(batch: int, n: int, seed: int) -> np.ndarray:
    """``n`` of ``batch`` env indices, drawn from ``seed``, sorted, always
    holding the first and the last env."""
    if n >= batch:
        return np.arange(batch)
    rng = np.random.default_rng(seed)
    pick = rng.choice(np.arange(1, batch - 1), size=n - 2, replace=False)
    return np.sort(np.concatenate([[0, batch - 1], pick]))


def boards_of_rows(rows: np.ndarray, width: int) -> np.ndarray:
    """The program's packed rows (uint32 bits; [H, B], or [H, NW, B] for wide
    boards: column x at global bit x + 4, word (x + 4) // 32) -> uint8
    boards [B, W, H], board[x, y]."""
    rows = np.asarray(rows).view(np.uint32)
    if rows.ndim == 2:
        rows = rows[:, None, :]
    x = np.arange(width) + 4
    words = rows[:, x // 32, :]                           # [H, W, B]
    bits = (words >> (x % 32).astype(np.uint32)[None, :, None]) & 1
    return np.transpose(bits, (2, 1, 0)).astype(np.uint8)


def mismatches(got, want) -> int:
    """Elements of ``got`` that differ from ``want``; every element when the
    shapes differ. Floats compare by value (a NaN never matches)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return max(got.size, want.size, 1)
    return int(np.count_nonzero(got != want))


def checks(counts: dict) -> dict:
    """Mismatch counts as the result's ``checks``: each limit is 0, since
    the comparison is exact."""
    return {k: {"value": int(v), "limit": 0} for k, v in counts.items()}
