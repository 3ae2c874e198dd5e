"""The port's plain-PyTorch threefry2x32 stream equals jax.random bit for bit
(threefry keys, jax_threefry_partitionable on): split, bits and the engine's
spawn draws."""

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
