"""threefry2x32 in plain PyTorch: the engine's spawn-draw stream and the
draws of the PPO and DQN trainers.

Bit-for-bit the stream of ``jax.random`` with threefry keys and
``jax_threefry_partitionable`` on (the default of JAX 0.9):

- ``split(key, n)`` is ``jax.random.split(key, n)``: key i is
  ``threefry2x32(key, (0, i))``;
- ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``;
- ``random_bits(key, shape)`` is ``jax.random.bits(key, shape, uint32)``:
  the element at flat index i is ``x0 ^ x1`` of ``threefry2x32(key, (0, i))``;
- ``uniform``, ``gumbel`` (mode "low"), ``categorical``, ``permutation``,
  ``normal`` and ``randint`` follow ``jax/_src/random.py`` on top of those
  bits, the float functions under them (``log_f32``, ``log1p_f32``,
  ``erf_inv_f32``, ``sqrt_f32``) as XLA's CPU backend computes them;
- ``flax_rng(key, *path, counter)`` is the key flax's ``make_rng`` derives
  for a module, ``fold_in`` of ``flax_fold(*path, counter)``.

Block draws: ``random_bits`` and every draw built on it take an optional
``block=(axis, start, stop)`` of the global ``shape`` and return exactly that
slice of the global draw, its counters the flat row-major indices of the
global shape (JAX's partitionable threefry), at a cost in the block's size
alone. A rank of a data-parallel mesh draws its own envs' share of a global
draw so: a ``[B]`` or batch-major ``[B, k]`` block is contiguous in the
counters, a batch-minor ``[k, B]`` one strided.

Words are held in int64 tensors with values in [0, 2**32) and masked after
every add and shift, so no signed 32-bit overflow or sign-extending right
shift is ever involved. Keys are int32[2] tensors carrying the uint32 bits.
"""

from __future__ import annotations

import hashlib
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


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def block_shape(shape, block=None) -> tuple:
    """The shape of ``block=(axis, start, stop)`` of the global ``shape``
    (the global shape itself without a block)."""
    shape = _shape(shape)
    if block is None:
        return shape
    axis, start, stop = block
    axis %= len(shape)
    if not 0 <= start <= stop <= shape[axis]:
        raise ValueError(f"block {block} outside the shape {shape}")
    return shape[:axis] + (stop - start,) + shape[axis + 1:]


def _counters(shape: tuple, block, device) -> torch.Tensor:
    """int64 flat row-major indices into the global ``shape`` of the
    elements of ``block`` (all of them without one), in the block's
    row-major order."""
    if block is None:
        return torch.arange(math.prod(shape), dtype=torch.int64,
                            device=device)
    axis, start, stop = block
    local = block_shape(shape, block)
    if len(shape) == 1:
        return torch.arange(start, stop, dtype=torch.int64, device=device)
    ctr = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        idx = torch.arange(local[d], dtype=torch.int64, device=device)
        if d == axis % len(shape):
            idx = idx + start
        ctr = ctr + (idx * stride).reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= shape[d]
    return ctr.reshape(-1)


def random_bits(key: torch.Tensor, shape, block=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2**32); an int ``shape`` means ``(shape,)``. With ``block=(axis,
    start, stop)``, only that slice of the global draw."""
    shape = _shape(shape)
    k0, k1 = _key_words(key)
    ctr = _counters(shape, block, key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return (y0 ^ y1).reshape(block_shape(shape, block))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, block=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled, then ``max(minval, .)``."""
    bits = random_bits(key, shape, block)
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


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root correctly rounded, as XLA computes it.
    ``torch.sqrt`` on a CPU with AVX-512 is not (about 6 values in 1000
    differ by an ulp); the float64 root rounded to float32 is, since 53 >=
    2 * 24 + 2."""
    return torch.sqrt(x.double()).float()


_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _poly_fma(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner's rule from the highest coefficient, each step one fused
    multiply-add, with the coefficients rounded to float32."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, c)
    return p


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log(1 + x)`` as XLA's CPU backend computes it (its elemental
    ``log-plus-one``): the Cephes rational approximation, fused, where
    ``|x| < sqrt(2) - 1``, else ``log_f32(x + 1)``; -inf at -1. For
    x >= -1 with x + 1 zero or a normal float32."""
    x2 = x * x
    small = _poly_fma(x, _LOG1P_NUM) / _poly_fma(x, _LOG1P_DEN)
    small = x + _fma(-0.5, x2, (x * x2) * small)
    is_small = x.abs() < 0.41421356237309504880
    big = log_f32(torch.where(is_small | (x == -1.0), torch.ones_like(x),
                              x + 1.0))
    big = torch.where(x == -1.0, float("-inf"), big)
    return torch.where(is_small, small, big)


# Giles' single-precision erfinv coefficients, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``lax.erf_inv`` as XLA's CPU backend computes it: Giles'
    polynomial in ``w = -log1p(-x**2)`` with its multiply-adds fused, and
    +-inf at +-1. ``torch.erfinv`` differs from it in more than half the
    values, by up to 82 ulp."""
    w = -log1p_f32(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)
    f32 = lambda c: torch.tensor(c, dtype=torch.float32, device=x.device)
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, f32(lo), f32(hi)))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_F32_ABOVE_M1 = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))


def normal(key: torch.Tensor, shape, block=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` for u
    uniform in (-1, 1)."""
    u = uniform(key, shape, _F32_ABOVE_M1, 1.0, block)
    return float(torch.tensor(math.sqrt(2), dtype=torch.float32)) \
        * erf_inv_f32(u)


def randint(key: torch.Tensor, shape, minval, maxval,
            block=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32: two
    32-bit draws from a split of the key folded into the span
    ``maxval - minval`` (1 where maxval <= minval) in uint32 arithmetic.
    ``minval`` / ``maxval`` may be ints or int tensors that broadcast to
    ``shape`` (to the block's shape with a ``block``). int32."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape, block), random_bits(k2, shape, block)
    dev = key.device
    mn = torch.as_tensor(minval, device=dev).to(torch.int64)
    mx = torch.as_tensor(maxval, device=dev).to(torch.int64)
    span = torch.where(mx <= mn, torch.ones_like(mx), (mx - mn) & _M32)
    mult = torch.full_like(span, 2 ** 16) % span
    # wraps as jax's uint32 product does: 0 for spans above 2**16
    mult = ((mult * mult) & _M32) % span
    off = (_mul32(hi % span, mult) + lo % span) & _M32
    return (mn + off % span).to(torch.int32)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for a, b in [0, 2**32) without int64 overflow:
    a in 16-bit halves."""
    return ((((a >> 16) * b) & _M32) << 16) + (a & 0xFFFF) * b & _M32


def flax_fold(*path) -> int:
    """The data ``flax_rng`` folds into the key for ``path``: the first 4
    bytes (big-endian) of the SHA-1 of the module path's names and the rng
    counter, in that order, with no separator (flax's default,
    ``flax_fix_rng_separator`` off)."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return int.from_bytes(m.digest()[:4], "big")


def flax_rng(key: torch.Tensor, *path) -> torch.Tensor:
    """The key flax's ``Scope.make_rng`` gives a module: ``fold_in`` of
    ``flax_fold(*path)``. ``flax_rng(k, "dense0", 1)`` is the first
    ``make_rng("noise")`` of the module ``dense0`` under ``apply(...,
    rngs={"noise": k})``."""
    return fold_in(key, flax_fold(*path))


def gumbel(key: torch.Tensor, shape, block=None) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low" (the default):
    ``-log(-log(u))`` for u uniform in [tiny, 1)."""
    return -log_f32(-log_f32(uniform(key, shape, _F32_TINY, 1.0, block)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                block=None) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis (float32
    logits): the Gumbel-max trick, first index on ties. int64. With
    ``block=(0, start, stop)``, ``logits`` are rows [start, stop) of the
    global batch and the draw is theirs (the leading axis's global size does
    not enter the counters)."""
    shape = tuple(logits.shape)
    if block is not None:
        if block[0] != 0:
            raise ValueError("categorical blocks run along the batch axis 0")
        shape = (block[2],) + shape[1:]
    return torch.argmax(gumbel(key, shape, block) + logits, dim=-1)


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


def draw_spawn_r(draw_key: torch.Tensor, counts: torch.Tensor,
                 offset: int = 0) -> torch.Tensor:
    """Spawn draws ``r = 1 + bits mod sum(m)`` (unsigned modulo), int32[B]:
    the port of the JAX engine's ``draw_spawn_r``, for the envs [offset,
    offset + B) of the global batch (``counts`` are theirs)."""
    from .engine import piece_weight_sum
    s = piece_weight_sum(counts).to(torch.int64)
    b = s.shape[0]
    bits = random_bits(draw_key, offset + b,
                       (0, offset, offset + b) if offset else None)
    return (1 + bits % s).to(torch.int32)
