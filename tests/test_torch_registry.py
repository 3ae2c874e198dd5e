"""The port's registry (``api/registry.py``): ``make`` on every backend, the
gymnasium env against the JAX package's, registration under a test-only id
(gymnasium's registry is global to the process: the JAX package's tests in
the same worker keep their ``SimpleTetris-v0`` entry), and ``register_gym``
without gym."""

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu.api.registry import make_gymnasium_env as jax_make_env
from gym_simpletetris_tpu_torch import (
    NativeTetrisEnv, NativeVectorEnv, TetrisEnv, TetrisVectorEnv, make,
    register_gym, register_gymnasium)
from gym_simpletetris_tpu_torch.api.registry import make_gymnasium_env
from gym_simpletetris_tpu_torch.native import native_available
import port_harness  # noqa: F401 (torch on one CPU thread)


gymnasium = pytest.importorskip("gymnasium")


def test_make_every_backend():
    env = make("SimpleTetris-v0", backend="cpu", obs_type="grayscale", seed=3)
    assert isinstance(env, TetrisEnv) and env.device.type == "cpu"
    assert env.reset().shape == (84, 84)
    venv = make(batch_size=4, backend="cpu", obs_type="ram", seed=3)
    assert isinstance(venv, TetrisVectorEnv) and venv.batch_size == 4
    obs, _ = venv.reset(0)
    assert tuple(obs.shape) == (4, 10, 20)
    if native_available():
        nat = make(backend="native", obs_type="ram", seed=3)
        assert isinstance(nat, NativeTetrisEnv)
        assert isinstance(make(batch_size=3, backend="native"),
                          NativeVectorEnv)
    for bad in ("tpu", "gpu", "jax"):
        with pytest.raises(ValueError, match="'cuda', 'cpu', 'native'"):
            make(backend=bad)
    with pytest.raises(KeyError):
        make("Tetris-v9", backend="cpu")
    if not torch.cuda.is_available():
        # the default backend is the card: without one it raises
        for kw in (dict(), dict(batch_size=2)):
            with pytest.raises(RuntimeError, match="cuda"):
                make("SimpleTetris-v0", **kw)


def test_gymnasium_env_passes_check_env():
    """ram only: the image Boxes keep the reference's declared (0, 1) range
    while the pixels are {0, 128, 190}, which ``check_env`` rejects (the JAX
    package's env likewise)."""
    from gymnasium.utils.env_checker import check_env
    env = make_gymnasium_env(device="cpu", obs_type="ram", reward_step=True)
    assert isinstance(env, gymnasium.Env)
    check_env(env, skip_render_check=True)
    env.close()


@pytest.mark.parametrize("obs_type", ["ram", "rgb"])
def test_gymnasium_env_against_jax(obs_type):
    kw = dict(obs_type=obs_type, reward_step=True)
    p = make_gymnasium_env(device="cpu", **kw)
    j = jax_make_env(**kw)
    assert p.observation_space == j.observation_space
    assert p.action_space == j.action_space
    rng = np.random.RandomState(0)
    for seed in (5, None):
        op, ip = p.reset(seed=seed)
        oj, ij = j.reset(seed=seed)
        np.testing.assert_array_equal(op, oj)
        assert ip == ij
        for t in range(40):
            a = int(rng.randint(0, 7))
            rp, rj = p.step(a), j.step(a)
            np.testing.assert_array_equal(rp[0], rj[0])
            assert rp[1:] == rj[1:], t
            if rp[2]:
                break
    np.testing.assert_array_equal(p.render(), j.render())
    p.close()


def test_register_gymnasium_under_a_test_id():
    env_id = "PortSimpleTetrisTest-v0"
    register_gymnasium(env_id)
    try:
        spec = gymnasium.spec(env_id)
        assert spec.entry_point == \
            "gym_simpletetris_tpu_torch.api.registry:make_gymnasium_env"
        env = gymnasium.make(env_id, device="cpu", obs_type="ram")
        obs, info = env.reset(seed=2)
        assert obs.shape == (10, 20) and info["time"] == 0
        env.step(2)
        env.close()
    finally:
        del gymnasium.registry[env_id]
    assert "SimpleTetris-v0" not in gymnasium.registry or \
        gymnasium.spec("SimpleTetris-v0").entry_point.startswith(
            "gym_simpletetris_tpu.")


def test_register_gym_without_gym():
    try:
        import gym  # noqa: F401
        pytest.skip("legacy gym is installed here")
    except ImportError:
        pass
    assert register_gym() is False
