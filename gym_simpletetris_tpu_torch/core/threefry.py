"""threefry2x32 in plain PyTorch: the engine's spawn-draw stream.

Bit-for-bit the stream of ``jax.random`` with threefry keys and
``jax_threefry_partitionable`` on (the default of JAX 0.9):

- ``split(key)`` is ``jax.random.split(key)``: key i is
  ``threefry2x32(key, (0, i))`` for i = 0, 1;
- ``random_bits(key, n)`` is ``jax.random.bits(key, (n,), uint32)``: element b
  is ``x0 ^ x1`` of ``threefry2x32(key, (0, b))``.

Words are held in int64 tensors with values in [0, 2**32) and masked after
every add and shift, so no signed 32-bit overflow or sign-extending right
shift is ever involved. Keys are int32[2] tensors carrying the uint32 bits.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1) under key
    (k0, k1). All operands int64 in [0, 2**32); returns (y0, y1) likewise."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _key_words(key: torch.Tensor):
    k = key.to(torch.int64) & _M32
    return k[0], k[1]


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 with the same bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def split(key: torch.Tensor):
    """``jax.random.split(key)`` on key data: returns (key_0, key_1), each
    int32[2] on the key's device."""
    k0, k1 = _key_words(key)
    ctr = torch.arange(2, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    out = _to_i32(torch.stack([y0, y1], dim=1))               # [2 keys, 2 words]
    return out[0], out[1]


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 values in [0, 2**32)."""
    k0, k1 = _key_words(key)
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return y0 ^ y1


def draw_spawn_r(draw_key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Spawn draws ``r = 1 + bits mod sum(m)`` (unsigned modulo), int32[B]:
    the port of the JAX engine's ``draw_spawn_r``."""
    from .engine import piece_weight_sum
    s = piece_weight_sum(counts).to(torch.int64)
    bits = random_bits(draw_key, s.shape[0])
    return (1 + bits % s).to(torch.int32)
