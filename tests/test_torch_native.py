"""The port's host C++ backend (``native/``, ``api/native_env.py``): its
``oracle.cc`` is byte-identical to the JAX package's, its library builds
into the port's ``_build/``, and its envs agree with the port's torch
engine on the CPU, bitwise, on the same spawn draws."""

import filecmp
import os

import numpy as np
import pytest

from gym_simpletetris_tpu_torch import EnvConfig, TetrisEnv, TetrisVectorEnv
from gym_simpletetris_tpu_torch import native
from gym_simpletetris_tpu_torch.native import (NativeBuildError,
                                               native_available)
import port_harness  # noqa: F401 (torch on one CPU thread)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_gxx = pytest.mark.skipif(not native_available(),
                               reason="g++ toolchain unavailable")


def test_oracle_source_is_the_jax_packages():
    port = os.path.join(REPO, "gym_simpletetris_tpu_torch", "native",
                        "oracle.cc")
    jax = os.path.join(REPO, "gym_simpletetris_tpu", "native", "oracle.cc")
    assert filecmp.cmp(port, jax, shallow=False)


@needs_gxx
def test_library_lands_in_build():
    native.load_library()
    build = os.path.join(REPO, "gym_simpletetris_tpu_torch", "_build")
    assert os.path.dirname(native._LIB) == build
    assert os.path.isfile(native._LIB)


def test_missing_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", str(tmp_path / "_oracle.so"))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    with pytest.raises(NativeBuildError):
        native._build()


def _draw(info, rng):
    c = np.array(list(info["statistics"].values()))
    return int(rng.randint(1, int((5 + c.max() - c).sum()) + 1))


@needs_gxx
@pytest.mark.parametrize("kw", [
    dict(obs_type="ram", reward_step=True, penalise_holes_increase=True),
    dict(obs_type="grayscale", extend_dims=True, advanced_clears=True,
         lock_delay=2, step_reset=True),
    dict(obs_type="rgb", width=7, height=11, high_scoring=True,
         penalise_height=True),
], ids=["ram", "grayscale", "rgb"])
def test_native_env_against_torch(kw):
    from gym_simpletetris_tpu_torch.api.native_env import NativeTetrisEnv
    nat = NativeTetrisEnv(**kw)
    env = TetrisEnv(device="cpu", **kw)
    rng = np.random.RandomState(5)
    r = _draw({"statistics": {n: 0 for n in "TJLZSIO"}}, rng)
    on, inf_n = nat.reset(return_info=True, injected_r=r)
    ot, inf_t = env.reset(return_info=True, injected_r=r)
    np.testing.assert_array_equal(on, ot)
    assert on.dtype == ot.dtype and inf_n == inf_t
    dones = 0
    for t in range(150):
        a = int(rng.randint(0, 7))
        r = _draw(inf_t, rng)
        on, rn, dn, inf_n = nat.step(a, injected_r=r)
        ot, rt, dt, inf_t = env.step(a, injected_r=r)
        np.testing.assert_array_equal(on, ot, err_msg=f"step {t}")
        assert (rn, dn, inf_n) == (rt, dt, inf_t), t
        if dn:
            dones += 1
            r = _draw(inf_t, rng)
            on, inf_n = nat.reset(return_info=True, injected_r=r)
            ot, inf_t = env.reset(return_info=True, injected_r=r)
            np.testing.assert_array_equal(on, ot)
            assert inf_n == inf_t
    assert dones > 0
    assert nat.valid_action_count() == env.valid_action_count()
    np.testing.assert_array_equal(nat.render("rgb_array"),
                                  env.render("rgb_array"))
    assert repr(nat) == repr(env)


@needs_gxx
@pytest.mark.parametrize("obs_type", ["ram", "grayscale"])
def test_native_vector_env_against_torch(obs_type):
    """Each native game's draws, read from a twin engine on the same seed
    and actions, injected into the torch vector env; both step past done
    (the death-erase quirk) without resets."""
    from gym_simpletetris_tpu_torch import NativeTetrisEngine, NativeVectorEnv
    B, T, flags = 4, 100, dict(reward_step=True, penalise_height=True)
    rng = np.random.RandomState(8)
    acts = rng.randint(0, 7, (T, B)).astype(np.int32)
    r0, r_step = [], []
    for i in range(B):
        twin = NativeTetrisEngine(seed=5 + i, **flags)
        r0.append(twin.clear(0)[1])
        r_step.append(twin.drive(acts[:, i], auto_clear=False)[3])
    r_step = np.stack(r_step, axis=1)
    venv = NativeVectorEnv(B, obs_type=obs_type, auto_reset=False, seed=5,
                           with_info=True, **flags)
    tenv = TetrisVectorEnv(EnvConfig(obs_type=obs_type, **flags), B,
                           device="cpu")
    on = venv.reset()
    ot, s = tenv.reset(0, injected_r=np.array(r0))
    np.testing.assert_array_equal(on, ot.numpy())
    done_any = False
    for t in range(T):
        on, rn, dn, inf_n = venv.step(acts[t])
        ot, s, rt, dt, inf_t = tenv.step(s, acts[t], injected_r=r_step[t])
        np.testing.assert_array_equal(on, ot.numpy(), err_msg=f"step {t}")
        np.testing.assert_array_equal(rn, rt.numpy())
        np.testing.assert_array_equal(dn, dt.numpy())
        for k, v in inf_n.items():
            np.testing.assert_array_equal(v, inf_t[k].numpy(), err_msg=k)
        done_any |= bool(dn.any())
    assert done_any
