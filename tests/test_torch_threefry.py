"""The port's plain-PyTorch threefry2x32 stream equals jax.random bit for bit
(threefry keys, jax_threefry_partitionable on): split, fold_in, bits,
uniform, gumbel, categorical, permutation and the engine's spawn draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu.core import engine as jax_engine
from gym_simpletetris_tpu_torch.core import threefry
from gym_simpletetris_tpu_torch.core.state import _key_tensor
import port_harness  # noqa: F401 (torch on one CPU thread)


def _keys(n, seed=0):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    edge = np.array([[0, 0], [0, 1], [0xFFFFFFFF, 0xFFFFFFFF],
                     [0x80000000, 0x7FFFFFFF]], np.uint32)
    return np.concatenate([edge, words])


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def _jax_key(words):
    return jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32),
                                    impl="threefry2x32")


def test_partitionable_threefry_is_on():
    """The port reproduces the partitionable stream, JAX 0.9's default."""
    assert jax.config.jax_threefry_partitionable


def test_split_matches_jax():
    for words in _keys(40):
        k1, k2 = jax.random.split(_jax_key(words))
        t1, t2 = threefry.split(_key_tensor(words, "cpu"))
        np.testing.assert_array_equal(_u32(t1), np.asarray(jax.random.key_data(k1)))
        np.testing.assert_array_equal(_u32(t2), np.asarray(jax.random.key_data(k2)))


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_random_bits_match_jax(n):
    for words in _keys(6, seed=n):
        want = np.asarray(jax.random.bits(_jax_key(words), (n,), jnp.uint32))
        got = threefry.random_bits(_key_tensor(words, "cpu"), n)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_key_chain_matches_jax():
    """Fifty advances of the engine key, as fifty env steps make."""
    jk = jax.random.key_data(jax.random.PRNGKey(7))
    tk = _key_tensor(7, "cpu")
    for _ in range(50):
        jk, _ = jax_engine._advance_key(jk)
        tk, _ = threefry.split(tk)
        np.testing.assert_array_equal(_u32(tk), np.asarray(jk))


@pytest.mark.parametrize("n", [1, 3, 7, 64])
def test_split_n_matches_jax(n):
    for words in _keys(12, seed=n):
        want = np.asarray(jax.random.key_data(jax.random.split(_jax_key(words), n)))
        got = threefry.split(_key_tensor(words, "cpu"), n)
        assert got.shape == (n, 2) and got.dtype == torch.int32
        np.testing.assert_array_equal(_u32(got), want)


def test_fold_in_matches_jax():
    for words in _keys(12, seed=11):
        for data in (0, 1, 7, 7777, 123456, 2 ** 31 - 1):
            want = np.asarray(jax.random.key_data(
                jax.random.fold_in(_jax_key(words), data)))
            got = threefry.fold_in(_key_tensor(words, "cpu"), data)
            np.testing.assert_array_equal(_u32(got), want)
            # the trainer folds in a device scalar (its update counter)
            got_t = threefry.fold_in(_key_tensor(words, "cpu"),
                                     torch.tensor(data, dtype=torch.int32))
            np.testing.assert_array_equal(_u32(got_t), want)


@pytest.mark.parametrize("shape", [(5,), (3, 7), (512, 7)])
def test_bits_uniform_gumbel_match_jax(shape):
    """Multi-axis bits count the flat index; uniform and gumbel (float32)
    are compared bit for bit, the gumbel log included."""
    for words in _keys(8, seed=len(shape)):
        k, t = _jax_key(words), _key_tensor(words, "cpu")
        np.testing.assert_array_equal(
            threefry.random_bits(t, shape).numpy(),
            np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64))
        for got, want in ((threefry.uniform(t, shape),
                           jax.random.uniform(k, shape)),
                          (threefry.gumbel(t, shape),
                           jax.random.gumbel(k, shape))):
            assert got.dtype == torch.float32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          np.asarray(want).view(np.int32))


def test_log_f32_matches_jnp_log():
    """The log under gumbel, bitwise against jnp.log on the CPU over both
    of gumbel's ranges ([tiny, 1) and (1e-7, 88]) and their ends."""
    rng = np.random.RandomState(1)
    x = np.concatenate([
        rng.uniform(0, 1, 100000), rng.uniform(0, 100, 50000),
        rng.uniform(1e-37, 1e-3, 20000),
        [1.1754944e-38, 1.1920929e-07, 0.99999994, 1.0, 87.33655]]) \
        .astype(np.float32)
    x = x[x > 0]
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = threefry.log_f32(torch.from_numpy(x)).numpy()
    same = got.view(np.int32) == want.view(np.int32)
    assert same.all(), x[~same][:5]


def test_categorical_matches_jax():
    rng = np.random.RandomState(4)
    for words in _keys(8, seed=21):
        logits = (rng.randn(2048, 7) * 3).astype(np.float32)
        want = np.asarray(jax.random.categorical(_jax_key(words),
                                                 jnp.asarray(logits)))
        got = threefry.categorical(_key_tensor(words, "cpu"),
                                   torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 7, 64, 4096])
def test_permutation_matches_jax(n):
    """n = 4096 takes two sort rounds, the others one (n = 1: none)."""
    for words in _keys(6, seed=n + 1):
        want = np.asarray(jax.random.permutation(_jax_key(words), n))
        got = threefry.permutation(_key_tensor(words, "cpu"), n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_draw_spawn_r_matches_jax():
    rng = np.random.RandomState(3)
    for words in _keys(8, seed=5):
        counts = rng.randint(0, 400, (7, 33)).astype(np.int32)
        _, jdraw = jax_engine._advance_key(jnp.asarray(words, jnp.uint32))
        want = np.asarray(jax_engine.draw_spawn_r(jdraw, jnp.asarray(counts)))
        _, tdraw = threefry.split(_key_tensor(words, "cpu"))
        got = threefry.draw_spawn_r(tdraw, torch.from_numpy(counts))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# -- the DQN trainer's draws and XLA-ordered sums --------------------------

@pytest.mark.parametrize("shape", [(100000,), (37, 5), (1, 512), (3136, 1)])
def test_normal_matches_jax(shape):
    """``normal`` bitwise against ``jax.random.normal``: 100,000 draws, and
    the NoisyDense noise shapes (in, 1) / (1, out)."""
    for words in _keys(1 if shape[0] == 100000 else 6, seed=shape[0]):
        want = np.asarray(jax.random.normal(_jax_key(words), shape))
        got = threefry.normal(_key_tensor(words, "cpu"), shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_erf_inv_and_log1p_match_xla():
    """The pieces under ``normal`` over their whole range and its ends:
    torch.erfinv and torch.log1p differ from XLA's in many values."""
    from jax import lax
    rng = np.random.RandomState(2)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.concatenate([rng.uniform(-1, 1, 100000),
                        rng.uniform(-1e-3, 1e-3, 10000),
                        1 - rng.uniform(0, 1e-3, 10000),
                        [lo, 0.0, 0.5, -0.5, 0.99999994, 1e-30]]) \
        .astype(np.float32)
    x = torch.from_numpy(u)
    for got, want in ((threefry.erf_inv_f32(x), lax.erf_inv(jnp.asarray(u))),
                      (threefry.log1p_f32(-x * x), jnp.log1p(-jnp.asarray(u) ** 2)),
                      (threefry.sqrt_f32(x.abs()), jnp.sqrt(jnp.abs(jnp.asarray(u))))):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


@pytest.mark.parametrize("span", [1, 7, 1000, 2 ** 31 - 1])
def test_randint_matches_jax(span):
    """Static and tensor ``maxval`` (the replay passes the filled slot
    count as a device scalar), spans past 2**16 included, where jax's
    uint32 multiplier wraps to 0."""
    for words in _keys(6, seed=span % 1000):
        k, t = _jax_key(words), _key_tensor(words, "cpu")
        want = np.asarray(jax.random.randint(k, (999,), 0, span))
        got = threefry.randint(t, (999,), 0, span)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jax.random.randint(
            k, (3, 7), 0, jnp.maximum(jnp.int32(span), 1)))
        got = threefry.randint(t, (3, 7), 0, torch.tensor(span,
                                                          dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), want)
    # maxval <= minval gives minval
    np.testing.assert_array_equal(
        threefry.randint(_key_tensor(1, "cpu"), 5, 3, 3).numpy(),
        np.asarray(jax.random.randint(jax.random.PRNGKey(1), (5,), 3, 3)))


def test_flax_rng_matches_make_rng():
    """The noise key of every NoisyDense path: ``flax_rng`` bitwise against
    the key ``make_rng("noise")`` returns inside flax's apply."""
    from gym_simpletetris_tpu.models import dqn as jax_dqn
    seen = {}
    orig = jax_dqn.NoisyDense.make_rng

    def spy(self, name="params"):
        key = orig(self, name)
        seen[self.scope.path] = np.asarray(jax.random.key_data(key)
                                           if key.dtype != jnp.uint32 else key)
        return key

    jax_dqn.NoisyDense.make_rng = spy
    try:
        for dueling, atoms in ((False, 0), (True, 0), (False, 51), (True, 51)):
            net = jax_dqn.RamDQN(hidden=(8, 4), dueling=dueling,
                                 num_atoms=atoms, noisy=True)
            x = jnp.zeros((1, 6, 8))
            params = net.init(jax.random.PRNGKey(0), x)
            net.apply(params, x, rngs={"noise": jax.random.PRNGKey(9)})
    finally:
        jax_dqn.NoisyDense.make_rng = orig
    paths = {p[-2:] if len(p) > 1 and p[-2] != "dense0" else p for p in seen}
    assert ("dense0",) in seen and ("C51Head_0", "advantage") in seen
    assert ("DuelingHead_0", "value") in seen and ("q",) in seen, paths
    for path, want in seen.items():
        got = threefry.flax_rng(_key_tensor(9, "cpu"), *path, 1)
        np.testing.assert_array_equal(_u32(got), want.astype(np.uint32),
                                      err_msg=str(path))


@pytest.mark.parametrize("n", [7, 16, 17, 100, 255, 257, 1000, 4096, 4097,
                               12345, 100000])
def test_cumsum_f32_matches_jnp_cumsum(n):
    """The PER sampler's cumulative sums, bitwise against ``jnp.cumsum``
    (XLA's blocked scan); torch.cumsum is 1e-4 off at n = 4096."""
    from gym_simpletetris_tpu_torch.train.replay import _cumsum_f32
    x = np.random.RandomState(n).rand(n).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    got = _cumsum_f32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_cumsum_f32_along_axis_1_matches_jnp_cumsum():
    from gym_simpletetris_tpu_torch.train.replay import _cumsum_f32
    x = np.random.RandomState(0).rand(64, 1024).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(jnp.asarray(x)))
    got = _cumsum_f32(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


# Block draws: a rank of a data-parallel mesh draws its envs' share of a
# global draw. 1-D [B], batch-major [B, 7], batch-minor [k, B] (strided) and
# a 3-D draw, at blocks at the start, the middle and the end.
BLOCKS = [((40,), (0, 0, 10)), ((40,), (0, 10, 30)), ((40,), (0, 35, 40)),
          ((24, 7), (0, 0, 6)), ((24, 7), (0, 12, 18)),
          ((3, 32), (1, 0, 8)), ((3, 32), (1, 8, 16)), ((3, 32), (1, 24, 32)),
          ((2, 5, 16), (2, 4, 12)), ((4, 6, 3), (1, 2, 4))]


def _slice(a, block):
    axis, start, stop = block
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(start, stop)
    return a[tuple(idx)]


@pytest.mark.parametrize("shape,block", BLOCKS)
def test_block_draws_are_slices_of_the_global_draw(shape, block):
    """bits / uniform / normal / randint / gumbel of a block are bitwise the
    same slice of the global draw, the port's and jax.random's."""
    words = _keys(1, seed=7)[-1]
    k, jk = _key_tensor(words, "cpu"), _jax_key(words)
    draws = (
        (lambda b: threefry.random_bits(k, shape, b),
         np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)),
        (lambda b: threefry.uniform(k, shape, block=b),
         np.asarray(jax.random.uniform(jk, shape))),
        (lambda b: threefry.normal(k, shape, block=b),
         np.asarray(jax.random.normal(jk, shape))),
        (lambda b: threefry.randint(k, shape, 0, 7, b),
         np.asarray(jax.random.randint(jk, shape, 0, 7))),
        (lambda b: threefry.gumbel(k, shape, block=b),
         np.asarray(jax.random.gumbel(jk, shape))),
    )
    for draw, want in draws:
        whole, part = draw(None).numpy(), draw(block).numpy()
        assert part.shape == threefry.block_shape(shape, block)
        np.testing.assert_array_equal(part, _slice(whole, block))
        np.testing.assert_array_equal(part, _slice(want, block))


@pytest.mark.parametrize("start,stop", [(0, 5), (5, 13), (13, 24)])
def test_categorical_block_matches_jax(start, stop):
    """A batch-major [B, 7] categorical: rows [start, stop) of the global
    draw, contiguous at start * 7."""
    words = _keys(1, seed=8)[-1]
    logits = np.random.RandomState(start).randn(24, 7).astype(np.float32)
    want = np.asarray(jax.random.categorical(_jax_key(words),
                                             jnp.asarray(logits)))
    got = threefry.categorical(_key_tensor(words, "cpu"),
                               torch.from_numpy(logits[start:stop]),
                               (0, start, stop))
    np.testing.assert_array_equal(got.numpy(), want[start:stop])


def test_spawn_draw_block_matches_the_global_draw():
    """draw_spawn_r at an offset: the same envs' draws of the global batch."""
    words = _keys(1, seed=9)[-1]
    counts = torch.from_numpy(
        np.random.RandomState(1).randint(0, 9, (7, 32)).astype(np.int32))
    k = _key_tensor(words, "cpu")
    whole = threefry.draw_spawn_r(k, counts)
    for off, b in ((0, 8), (8, 16), (24, 8)):
        part = threefry.draw_spawn_r(k, counts[:, off:off + b], off)
        np.testing.assert_array_equal(part.numpy(), whole[off:off + b].numpy())


def test_spawn_draw_on_the_cpu_is_the_plain_draw_and_matches_jax():
    """A CPU state's spawn draw launches no kernel (the draw kernel is for
    CUDA states) and gives JAX's carry key and draws, at a sharded env
    offset too."""
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.core.config import EnvConfig
    from gym_simpletetris_tpu_torch.core.state import init_state
    from gym_simpletetris_tpu_torch.utils.profiling import counters
    rng = np.random.RandomState(17)
    for words in _keys(6, seed=17):
        counts = rng.randint(0, 400, (7, 40)).astype(np.int32)
        jcarry, jdraw = jax_engine._advance_key(jnp.asarray(words, jnp.uint32))
        want = np.asarray(jax_engine.draw_spawn_r(jdraw, jnp.asarray(counts)))
        for off, b in ((0, 40), (24, 16)):
            s = init_state(EnvConfig(), b, words, device="cpu",
                           env_offset=off).replace(shape_counts=torch.from_numpy(
                               counts[:, off:off + b].copy()))
            n = counters()
            key, r = E.spawn_draw(s)
            m = counters()
            assert m["kernel.draw.launches"] == n["kernel.draw.launches"]
            assert m["engine.draws"] == n["engine.draws"] + 1
            np.testing.assert_array_equal(_u32(key), np.asarray(jcarry))
            assert r.dtype == torch.int32
            np.testing.assert_array_equal(r.numpy(), want[off:off + b])
