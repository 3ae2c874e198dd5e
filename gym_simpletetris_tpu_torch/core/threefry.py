"""threefry2x32 in plain PyTorch: the engine's spawn-draw stream and the
draws of the PPO trainer.

Bit-for-bit the stream of ``jax.random`` with threefry keys and
``jax_threefry_partitionable`` on (the default of JAX 0.9):

- ``split(key, n)`` is ``jax.random.split(key, n)``: key i is
  ``threefry2x32(key, (0, i))``;
- ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``;
- ``random_bits(key, shape)`` is ``jax.random.bits(key, shape, uint32)``:
  the element at flat index i is ``x0 ^ x1`` of ``threefry2x32(key, (0, i))``;
- ``uniform``, ``gumbel`` (mode "low"), ``categorical`` and ``permutation``
  follow ``jax/_src/random.py`` on top of those bits.

Words are held in int64 tensors with values in [0, 2**32) and masked after
every add and shift, so no signed 32-bit overflow or sign-extending right
shift is ever involved. Keys are int32[2] tensors carrying the uint32 bits.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_F32_TINY = torch.finfo(torch.float32).tiny
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


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` on key data: int32[n, 2] on the key's
    device (``a, b = split(key)`` unpacks the two keys of the default)."""
    k0, k1 = _key_words(key)
    ctr = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return _to_i32(torch.stack([y0, y1], dim=1))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter
    ``threefry_seed(data) = (0, data mod 2**32)`` under the key, int32[2]."""
    k0, k1 = _key_words(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return _to_i32(torch.stack([y0, y1]))


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2**32); an int ``shape`` means ``(shape,)``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    k0, k1 = _key_words(key)
    ctr = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return (y0 ^ y1).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled, then ``max(minval, .)``."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the product of two float32 is
    exact in float64, so only the sum rounds before the cast."""
    d = lambda v: (v.double() if isinstance(v, torch.Tensor)
                   else float(torch.tensor(v, dtype=torch.float32)))
    return (d(a) * d(b) + d(c)).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU backend computes it, which is what
    ``jnp.log`` gives where the JAX package's tests run: the Cephes
    polynomial (Eigen's ``plog``) with its multiply-adds fused. ``torch.log``
    is within an ulp of it but differs in about 1 value of 7; this keeps
    ``gumbel`` bitwise equal to ``jax.random.gumbel``. For positive normal
    float32 inputs, all that ``gumbel`` passes it."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF).float() - 126.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < 0.707106781186547524
    m = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * -2.12194440e-4)
    return ((m - x2 * 0.5) + y) + e * 0.693359375


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low" (the default):
    ``-log(-log(u))`` for u uniform in [tiny, 1)."""
    return -log_f32(-log_f32(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis (float32
    logits): the Gumbel-max trick, first index on ties. int64."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``ceil(3 ln n / ln(2**32 - 1))``
    rounds, each a stable sort of the current order by 32 fresh random bits
    from a split of the key. int64[n]."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, n), stable=True).indices
        x = x[order]
    return x


def draw_spawn_r(draw_key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Spawn draws ``r = 1 + bits mod sum(m)`` (unsigned modulo), int32[B]:
    the port of the JAX engine's ``draw_spawn_r``."""
    from .engine import piece_weight_sum
    s = piece_weight_sum(counts).to(torch.int64)
    bits = random_bits(draw_key, s.shape[0])
    return (1 + bits % s).to(torch.int32)
