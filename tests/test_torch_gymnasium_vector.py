"""The port's gymnasium vector adapter (``api/gymnasium_vector.py``) against
the JAX package's, bitwise for the same seeds: next-step autoreset over
several episodes, reset keys folded from the reset count, on the torch
engine (CPU) and on the host C++ engine."""

import numpy as np
import pytest

from gym_simpletetris_tpu.api.registry import (
    make_gymnasium_vector_env as jax_make)
from gym_simpletetris_tpu_torch.api.gymnasium_vector import _TorchVectorCore
from gym_simpletetris_tpu_torch.api.registry import make_gymnasium_vector_env
from gym_simpletetris_tpu_torch.native import native_available
import port_harness  # noqa: F401 (torch on one CPU thread)


gymnasium = pytest.importorskip("gymnasium")

CASES = [("cpu", "tpu", dict(obs_type="ram", reward_step=True), 8, 200),
         ("cpu", "tpu", dict(obs_type="grayscale", penalise_holes=True,
                             lock_delay=1), 4, 60)]
if native_available():
    CASES.append(("native", "native", dict(obs_type="rgb", reward_step=True),
                  4, 120))


def _same(got, want, msg):
    assert set(got) == set(want), msg
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (msg, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} {k}")


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{c[2]['obs_type']}" for c in CASES])
def test_adapter_against_jax(case):
    backend, jax_backend, kw, n, steps = CASES[case]
    p = make_gymnasium_vector_env(n, backend=backend, seed=3, **kw)
    j = jax_make(n, backend=jax_backend, seed=3, **kw)
    assert isinstance(p, gymnasium.vector.VectorEnv)
    assert p.observation_space == j.observation_space
    assert p.metadata == j.metadata
    rng = np.random.RandomState(0)
    for r in range(2):       # the second reset folds in a new reset count
        op, ip = p.reset()
        oj, ij = j.reset()
        _same(dict(obs=op, **ip), dict(obs=oj, **ij), f"reset {r}")
        terms = 0
        for t in range(steps // 2 if r else steps):
            a = rng.choice([0, 1, 2, 2, 2, 3, 4, 5, 6], n)  # hard-drop heavy
            got, want = p.step(a), j.step(a)
            _same(dict(zip("orxy", got[:4]), **got[4]),
                  dict(zip("orxy", want[:4]), **want[4]), f"{r} step {t}")
            terms += int(got[2].sum())
        assert terms > 0 or r
    op, _ = p.reset(seed=9)
    oj, _ = j.reset(seed=9)
    np.testing.assert_array_equal(op, oj)
    p.close()


def test_record_episode_statistics_accepts_it():
    from gymnasium.wrappers.vector import RecordEpisodeStatistics
    env = RecordEpisodeStatistics(make_gymnasium_vector_env(
        4, backend="cpu", obs_type="ram", reward_step=True, seed=4))
    env.reset()
    rng = np.random.RandomState(0)
    finished = 0
    for _ in range(150):
        obs, rew, term, trunc, info = env.step(rng.randint(0, 7, 4))
        if "episode" in info:
            finished += int(np.asarray(info["_episode"]).sum())
    assert finished > 0


def test_reset_without_seed_gives_fresh_episodes():
    env = make_gymnasium_vector_env(4, backend="cpu", obs_type="ram", seed=1)
    env.reset()
    tr1 = [env.step(np.full(4, 2))[0].copy() for _ in range(8)]
    env.reset()
    tr2 = [env.step(np.full(4, 2))[0].copy() for _ in range(8)]
    assert any(not np.array_equal(a, b) for a, b in zip(tr1, tr2))


def test_core_rejects_auto_reset_and_unknown_backends():
    with pytest.raises(ValueError, match="auto_reset"):
        _TorchVectorCore(2, 0, device="cpu", auto_reset=True)
    with pytest.raises(ValueError, match="'cuda', 'cpu' or 'native'"):
        make_gymnasium_vector_env(2, backend="tpu")
