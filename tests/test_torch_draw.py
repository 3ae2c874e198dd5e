"""The spawn-draw kernel (``csrc/draw.cu``, ``ops/cuda_draw.py``) against the
plain draw (``threefry.split`` and ``threefry.draw_spawn_r``), on the card.

These need a CUDA device and nvcc; without them every test skips. On a
machine with a card (``--noconftest``: tests/conftest.py sets up JAX, which
the port and this file do not use):

    python -m pytest --noconftest tests/test_torch_draw.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.core import engine as E
from gym_simpletetris_tpu_torch.core import threefry
from gym_simpletetris_tpu_torch.core.state import _key_tensor, init_state
from gym_simpletetris_tpu_torch.ops import cuda_draw
from gym_simpletetris_tpu_torch.utils.profiling import counters
import port_harness  # noqa: F401 (torch on one CPU thread)

pytestmark = pytest.mark.cuda

# the edge keys of tests/test_torch_threefry.py, then random ones
EDGE_KEYS = ((0, 0), (0, 1), (0xFFFFFFFF, 0xFFFFFFFF),
             (0x80000000, 0x7FFFFFFF))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _keys(rng, n=8):
    words = rng.randint(0, 2 ** 32, (n, 2), dtype=np.uint64)
    return [np.asarray(k, np.uint32) for k in EDGE_KEYS] + [
        w.astype(np.uint32) for w in words]


def _counts(kind, B, rng):
    if kind == "random":
        c = rng.randint(0, 400, (7, B))
    elif kind == "skewed":   # one piece far ahead, so sum(m) is large
        c = rng.randint(0, 3, (7, B))
        c[rng.randint(0, 7, B), np.arange(B)] += rng.randint(0, 10 ** 6, B)
    else:
        c = np.zeros((7, B))
    return c.astype(np.int32)


def _plain(key, counts, offset):
    carry, draw_key = threefry.split(key)
    return carry, threefry.draw_spawn_r(draw_key, counts, offset)


@pytest.mark.parametrize("kind", ["random", "skewed", "zero"])
@pytest.mark.parametrize("offset", [0, 2048])
@pytest.mark.parametrize("B", [1, 31, 33, 4096])
def test_draw_kernel_matches_plain(dev, B, offset, kind):
    rng = np.random.RandomState(B + offset)
    counts = torch.as_tensor(_counts(kind, B, rng), device=dev)
    for words in _keys(rng):
        key = _key_tensor(words, dev)
        got_key, got_r = cuda_draw.draw(key, counts, offset)
        want_key, want_r = _plain(key, counts, offset)
        assert got_r.dtype == torch.int32 and got_r.shape == (B,)
        assert torch.equal(got_key, want_key), words
        assert torch.equal(got_r, want_r), words


def test_draw_kernel_key_chain(dev):
    """50 draws, each on the carry key of the last, against the plain chain
    (counts from a real game: the spawns of each step added)."""
    B = 4096
    rng = np.random.RandomState(5)
    counts = torch.as_tensor(_counts("random", B, rng), device=dev)
    k_kernel = k_plain = _key_tensor(np.array([7, 11], np.uint32), dev)
    for t in range(50):
        k_kernel, r_kernel = cuda_draw.draw(k_kernel, counts)
        k_plain, r_plain = _plain(k_plain, counts, 0)
        assert torch.equal(k_kernel, k_plain), t
        assert torch.equal(r_kernel, r_plain), t
        piece = E.sample_piece(counts, r_kernel)
        counts = counts + (torch.arange(7, device=dev)[:, None]
                           == piece[None, :]).to(torch.int32)


def test_draw_kernel_with_injected_r_writes_the_key_alone(dev):
    rng = np.random.RandomState(9)
    for B in (1, 33, 4096):
        counts = torch.as_tensor(_counts("random", B, rng), device=dev)
        injected = rng.randint(1, 36, B)
        for words in _keys(rng, 2):
            key = _key_tensor(words, dev)
            got_key, got_r = cuda_draw.draw(key, counts, 0, injected)
            assert torch.equal(got_key, threefry.split(key)[0])
            assert got_r.dtype == torch.int32 and got_r.is_contiguous()
            np.testing.assert_array_equal(got_r.cpu().numpy(), injected)


def test_spawn_draw_on_the_card_goes_through_the_kernel(dev):
    """A CUDA state's draw is one kernel launch, equal to the plain draw, at
    a sharded env offset too; the injected path likewise."""
    cfg = EnvConfig()
    for offset in (0, 2048):
        s = init_state(cfg, 333, 3, device=dev, env_offset=offset)
        s = s.replace(shape_counts=torch.as_tensor(
            _counts("random", 333, np.random.RandomState(offset)), device=dev))
        for injected in (None, torch.arange(1, 334, device=dev)):
            n = counters()
            got = E.spawn_draw(s, injected)
            m = counters()
            assert m["kernel.draw.launches"] - n["kernel.draw.launches"] == 1
            assert m["engine.draws"] - n["engine.draws"] == 1
            want = E.spawn_draw_plain(s, injected)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert counters()["kernel.draw.launches"] == \
                m["kernel.draw.launches"]      # the plain draw launches none


@pytest.mark.parametrize("obs_type", ["ram", "grayscale"])
def test_draw_launches_equal_draws_over_a_rollout(dev, obs_type):
    """Every draw of the main path goes through the kernel: over a reset, a
    step and an auto-reset rollout, ``kernel.draw.launches`` equals
    ``engine.draws``; the rollout equals the same steps on the plain draw."""
    cfg = EnvConfig(obs_type=obs_type, auto_reset=True)
    B, T = 512, 64
    env = TetrisVectorEnv(cfg, B, device=dev)
    rng = np.random.RandomState(1)
    acts = torch.as_tensor(rng.randint(0, 7, (T, B)), device=dev)
    n = counters()
    _, s = env.reset(4)
    _, s, _, _, _ = env.step(s, acts[0])
    final, acc, rew, done = env.rollout(s, acts)
    m = counters()
    draws = m["engine.draws"] - n["engine.draws"]
    assert draws == 1 + 2 + 2 * T
    assert m["kernel.draw.launches"] - n["kernel.draw.launches"] == draws
    assert int(done.sum()) > 0

    saved = E.spawn_draw
    E.spawn_draw = E.spawn_draw_plain
    try:
        final_p, acc_p, rew_p, done_p = env.rollout(s, acts)
    finally:
        E.spawn_draw = saved
    assert counters()["kernel.draw.launches"] == m["kernel.draw.launches"]
    assert torch.equal(final.key, final_p.key)
    assert torch.equal(final.rows, final_p.rows)
    assert torch.equal(acc, acc_p)
    assert torch.equal(rew, rew_p) and torch.equal(done, done_p)
