"""Threefry-2x32 in plain NumPy: the spawn-draw stream the port promises.

The port's engine key is two uint32 words. Its stream is that of
``jax.random`` with threefry keys and partitionable counters:

- ``split(key)`` gives two keys, key i being the hash of the counter pair
  ``(0, i)`` under ``key``;
- ``fold_in(key, n)`` is the hash of ``(0, n)``;
- the random bits of element i of a draw are ``y0 ^ y1`` of the hash of
  ``(0, i)`` under the draw key.

The hash is the 20-round Threefry-2x32 of Salmon et al. (SC'11), with the key
schedule word ``k0 ^ k1 ^ 0x1BD11BDA``. Written here from that description;
it shares no code with the program.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def hash2x32(k0, k1, x0, x1):
    """Threefry-2x32 of counter words (x0, x1) under key (k0, k1). Works on
    Python ints or uint64 arrays (broadcast) holding values below 2**32;
    returns (y0, y1) of the same kind."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key_from_seed(seed: int) -> tuple:
    """The key of an int32 seed: words (0, seed mod 2**32)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return (0, seed & _M32)


def split(key) -> tuple:
    """(key 0, key 1) of a two-way split, each a pair of Python ints."""
    return (hash2x32(key[0], key[1], 0, 0), hash2x32(key[0], key[1], 0, 1))


def fold_in(key, n: int) -> tuple:
    return hash2x32(key[0], key[1], 0, n & _M32)


def bits(keys, counters) -> np.ndarray:
    """uint32 random bits: ``keys`` [T, 2] (one draw key per row), the
    elements ``counters`` [S] of each draw: an array [T, S]."""
    keys = np.asarray(keys, dtype=np.uint64).reshape(-1, 2) & np.uint64(_M32)
    ctr = np.asarray(counters, dtype=np.uint64)[None, :] & np.uint64(_M32)
    y0, y1 = hash2x32(keys[:, :1], keys[:, 1:], np.zeros_like(ctr), ctr)
    return (y0 ^ y1).astype(np.uint32)
