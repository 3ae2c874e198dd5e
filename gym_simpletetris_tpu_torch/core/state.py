"""Batched environment state: a dataclass of tensors (PyTorch port).

The same 14 fields and the same batch-minor layout as the JAX package's
``EnvState``: board rows ``[H, B]`` with column x at bit ``x + XSHIFT``
(``[H, NW, B]`` for wide boards, bit ``x + XSHIFT`` of the row in word
``(x + XSHIFT) // 32``), one
entry per env for the scalars, ``[7, B]`` shape counts, and the engine's
threefry key as 2 words. The uint32 words of the JAX state (rows, key) are
held as int32 tensors with the same bits: torch's uint32 lacks shifts and
arithmetic, and the bits are what the kernels read.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .config import EnvConfig

FIELDS = ("rows", "piece", "rot", "ax", "ay", "lock", "time", "score",
          "holes", "lines_cleared", "piece_height", "deaths", "shape_counts",
          "key")
# Per-env int32[B] fields, in the order the step kernel reads and writes them.
SCALAR_FIELDS = FIELDS[1:12]
_UINT32_FIELDS = ("rows", "key")


@dataclasses.dataclass
class EnvState:
    rows: torch.Tensor          # int32[H, B] or [H, NW, B] (uint32 bits)
    piece: torch.Tensor         # int32[B] in [0, 7)
    rot: torch.Tensor           # int32[B] in [0, 4)
    ax: torch.Tensor            # int32[B]
    ay: torch.Tensor            # int32[B]
    lock: torch.Tensor          # int32[B]
    time: torch.Tensor          # int32[B]
    score: torch.Tensor         # int32[B]
    holes: torch.Tensor         # int32[B], recomputed only at lock
    lines_cleared: torch.Tensor # int32[B]
    piece_height: torch.Tensor  # int32[B]
    deaths: torch.Tensor        # int32[B]
    shape_counts: torch.Tensor  # int32[7, B]
    key: torch.Tensor           # int32[2] threefry key data (uint32 bits)

    @property
    def batch_size(self) -> int:
        return self.rows.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


def key_data(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` for a 32-bit seed:
    uint32[2] = (0, seed mod 2**32)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} out of the int32 range")
    return np.array([0, seed & 0xFFFFFFFF], dtype=np.uint32)


def _key_tensor(key, device) -> torch.Tensor:
    """An int seed or 2 words of key data -> int32[2] on ``device``."""
    if isinstance(key, (int, np.integer)):
        key = key_data(key)
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    words = np.asarray(key)
    if words.shape != (2,):
        raise ValueError(f"key must be a seed or 2 words, got shape {words.shape}")
    words = (words.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def rows_shape(config: EnvConfig, batch_size: int) -> tuple:
    """Shape of the board rows: [H, B] for single-word boards, [H, NW, B]
    for wide ones (the JAX state's layout)."""
    nw = config.num_words
    return (config.height,) + ((nw,) if nw > 1 else ()) + (batch_size,)


def init_state(config: EnvConfig, batch_size: int, key,
               device="cuda") -> EnvState:
    """Fresh-engine state (TetrisEngine.__init__): time and score start at -1,
    everything else zero, no piece spawned yet. On the card unless
    ``device="cpu"``; without a card torch raises."""
    b = batch_size
    device = torch.device(device)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    m1 = lambda: torch.full((b,), -1, dtype=torch.int32, device=device)
    return EnvState(
        rows=z(*rows_shape(config, b)), piece=z(b), rot=z(b), ax=z(b), ay=z(b),
        lock=z(b), time=m1(), score=m1(), holes=z(b), lines_cleared=z(b),
        piece_height=z(b), deaths=z(b), shape_counts=z(7, b),
        key=_key_tensor(key, device))


def state_from_numpy(d: Mapping[str, np.ndarray], device="cpu") -> EnvState:
    """Build the port's state from the JAX ``EnvState`` fields as numpy arrays
    (uint32 rows and key are taken bit for bit as int32)."""
    out = {}
    for name in FIELDS:
        a = np.ascontiguousarray(d[name])
        if name in _UINT32_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        out[name] = torch.from_numpy(a.astype(np.int32)).to(device)
    return EnvState(**out)


def state_to_numpy(s: EnvState) -> dict:
    """Inverse of ``state_from_numpy``: numpy arrays in the JAX state's dtypes
    (uint32 rows and key, int32 everything else)."""
    out = {}
    for name in FIELDS:
        a = getattr(s, name).detach().cpu().numpy().astype(np.int32)
        out[name] = a.view(np.uint32) if name in _UINT32_FIELDS else a
    return out
