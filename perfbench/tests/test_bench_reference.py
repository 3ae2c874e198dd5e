"""The benchmark's plain NumPy reference (``perfbench/reference/``) held to
the JAX package and to the port's CPU plain path at small sizes, across
both configurations, a configuration with every other flag, and the action
mixes the cells use (uniform random) and a hard-drop mix (every step
locks, deaths come often).

    python -m pytest perfbench/tests -q
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from gym_simpletetris_tpu.api import env as jax_env  # noqa: E402
from gym_simpletetris_tpu.api import engine as jax_engine  # noqa: E402
from gym_simpletetris_tpu.api.gym_compat import TetrisEnv as JaxShim  # noqa: E402
from gym_simpletetris_tpu.api.gymnasium_vector import _JaxVectorCore  # noqa: E402
from gym_simpletetris_tpu.core.config import EnvConfig as JaxConfig  # noqa: E402

from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv  # noqa: E402
from gym_simpletetris_tpu_torch.api.gym_compat import TetrisEnv  # noqa: E402
from gym_simpletetris_tpu_torch.api.gymnasium_vector import (  # noqa: E402
    _TorchVectorCore)
from gym_simpletetris_tpu_torch.core.state import state_to_numpy  # noqa: E402

from perfbench.entries import common  # noqa: E402
from perfbench.harness import ROOT  # noqa: E402
from perfbench.reference import raster, surfaces, threefry  # noqa: E402

import json  # noqa: E402

CONFIGS = {
    name: json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                     .read_text())["env"]
    for name in ("v0_ram", "flagship_gray")}
CONFIGS["flags"] = dict(width=7, height=9, lock_delay=2, step_reset=True,
                        advanced_clears=True, penalise_holes_increase=True,
                        penalise_height_increase=True)
CONFIGS["high"] = dict(width=12, height=16, obs_type="rgb", high_scoring=True,
                       penalise_holes=True, lock_delay=1)
SEED = 2 ** 31 - 77


def _actions(mix, shape, seed=0):
    rng = np.random.default_rng(seed)
    if mix == "hard":
        return np.where(rng.random(shape) < 0.8, 2, rng.integers(0, 7, shape))
    return rng.integers(0, 7, shape)


def _check_rollout(got_calls, want_calls, width):
    """got: per call (acc, reward, done, state dict in the JAX state's numpy
    form), all envs; want: the reference's replay of the same envs."""
    for (acc, reward, done, st), w in zip(got_calls, want_calls):
        np.testing.assert_array_equal(reward, w["reward"])
        np.testing.assert_array_equal(done, w["done"])
        np.testing.assert_array_equal(acc, w["acc"])
        s = w["state"]
        np.testing.assert_array_equal(
            common.boards_of_rows(st["rows"], width), s["board"])
        np.testing.assert_array_equal(st["shape_counts"].T, s["shape_counts"])
        np.testing.assert_array_equal(st["key"].astype(np.int64), s["key"])
        for f in ("piece", "rot", "ax", "ay", "lock", "time", "score",
                  "holes", "lines_cleared", "piece_height", "deaths"):
            np.testing.assert_array_equal(st[f], s[f], err_msg=f)


def test_threefry_matches_jax():
    for seed in (0, 1, -5, 2 ** 31 - 1, -2 ** 31):
        key = jax.random.PRNGKey(seed)
        ref = threefry.key_from_seed(seed)
        assert tuple(np.asarray(key).tolist()) == ref
        a, b = jax.random.split(key)
        ra, rb = threefry.split(ref)
        assert tuple(np.asarray(a).tolist()) == ra
        assert tuple(np.asarray(b).tolist()) == rb
        assert tuple(np.asarray(jax.random.fold_in(key, 7)).tolist()) == \
            threefry.fold_in(ref, 7)
        bits = np.asarray(jax.random.bits(b, (300,), np.uint32))
        np.testing.assert_array_equal(
            threefry.bits([rb], np.arange(300))[0], bits)
        np.testing.assert_array_equal(
            threefry.bits([rb, ra], [3, 299]),
            np.stack([bits[[3, 299]], np.asarray(
                jax.random.bits(a, (300,), np.uint32))[[3, 299]]]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_raster_matches_jax_convert_grayscale(name):
    kw = CONFIGS[name]
    w, h = kw.get("width", 10), kw.get("height", 20)
    rng = np.random.default_rng(3)
    boards = (rng.random((5, w, h)) < 0.4).astype(np.uint8)
    want = np.stack([jax_engine.convert_grayscale(b, 84) for b in boards])
    np.testing.assert_array_equal(raster.grayscale(boards), want)
    counts = rng.integers(0, 40, (w, h))
    summed = sum(jax_engine.convert_grayscale((counts > k).astype(np.uint8),
                                              84).astype(np.int64)
                 for k in range(40))
    np.testing.assert_array_equal(raster.image(counts.T, 84, 40), summed)


@pytest.mark.parametrize("mix", ["uniform", "hard"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rollout_matches_the_port_and_jax(name, mix):
    kw = CONFIGS[name]
    B, T = 12, 40
    calls = [_actions(mix, (T, B), k) for k in range(3)]
    sample = np.array([0, 2, 5, 11])
    want = surfaces.rollout(kw, sample, SEED, [c[:, sample] for c in calls])
    width = kw.get("width", 10)

    env = TetrisVectorEnv(EnvConfig(**kw, auto_reset=True), B, device="cpu")
    _, st = env.reset(SEED)
    port = []
    for c in calls:
        st, acc, rew, done = env.rollout(st, torch.as_tensor(c,
                                                             dtype=torch.int32))
        s = state_to_numpy(st)
        port.append((acc.numpy()[sample], rew.numpy()[:, sample],
                     done.numpy()[:, sample],
                     {k: v[..., sample] for k, v in s.items() if k != "key"}
                     | {"key": s["key"]}))
    _check_rollout(port, want, width)

    jenv = jax_env.TetrisVectorEnv(JaxConfig(**kw, auto_reset=True), B)
    _, js = jenv.reset(jax.random.PRNGKey(SEED))
    ours = []
    for c in calls:
        js, acc, rew, done = jenv.rollout(js, np.asarray(c, np.int32))
        s = {f: np.asarray(getattr(js, f)) for f in (
            "rows", "piece", "rot", "ax", "ay", "lock", "time", "score",
            "holes", "lines_cleared", "piece_height", "deaths",
            "shape_counts")}
        ours.append((np.asarray(acc)[sample], np.asarray(rew)[:, sample],
                     np.asarray(done)[:, sample],
                     {k: v[..., sample] for k, v in s.items()}
                     | {"key": np.asarray(js.key)}))
    _check_rollout(ours, want, width)
    assert sum(w["done"].sum() for w in want) > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gym_shim_matches_the_port_and_jax(name):
    kw = CONFIGS[name]
    acts = _actions("uniform", 400, 9)
    port, jx = TetrisEnv(seed=SEED, device="cpu", **kw), JaxShim(seed=SEED, **kw)
    calls, got, got_j = [("reset",)], [port.reset()], [jx.reset()]
    for a in acts:
        calls.append(("step", int(a)))
        got.append(port.step(int(a)))
        got_j.append(jx.step(int(a)))
        if got[-1][2]:
            calls.append(("reset",))
            got.append(port.reset())
            got_j.append(jx.reset())
    want = surfaces.gym(kw, SEED, calls)
    assert sum(c[0] == "reset" for c in calls) > 2
    for g, gj, w in zip(got, got_j, want):
        for out in (g, gj):
            if "reward" not in w:
                np.testing.assert_array_equal(out, w["obs"])
                continue
            obs, reward, done, info = out
            np.testing.assert_array_equal(obs, w["obs"])
            assert np.asarray(obs).dtype == w["obs"].dtype
            assert (reward, done, info) == (w["reward"], w["done"], w["info"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_vector_core_matches_the_port_and_jax(name):
    kw = CONFIGS[name]
    n, steps = 10, 120
    calls = [_actions("uniform", n, k) for k in range(steps)]
    obs_envs = np.array([1, 4, 9])
    first, want = surfaces.vector(kw, n, SEED, calls, obs_envs)
    for core in (_TorchVectorCore(n, SEED, device="cpu", **kw),
                 _JaxVectorCore(n, SEED, **kw)):
        obs, info = core.reset()
        np.testing.assert_array_equal(obs[obs_envs], first["obs"])
        for k, v in first["info"].items():
            np.testing.assert_array_equal(info[k], v, err_msg=k)
        for a, w in zip(calls, want):
            obs, reward, term, info = core.step(a)
            np.testing.assert_array_equal(obs[obs_envs], w["obs"])
            np.testing.assert_array_equal(reward, w["reward"])
            np.testing.assert_array_equal(term, w["terminated"])
            for k, v in w["info"].items():
                np.testing.assert_array_equal(info[k], v, err_msg=k)
        np.testing.assert_array_equal(obs, want[-1]["obs_all"])
    assert sum(w["terminated"].sum() for w in want) > 0
