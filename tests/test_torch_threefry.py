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
