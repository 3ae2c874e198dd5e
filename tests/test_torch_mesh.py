"""The port's data-parallel env layer (``parallel/mesh.py``) in real process
worlds of 2 and 4 ranks over gloo on the CPU, against the JAX package's
``ShardedTetrisEnv``, ``shard_map_step`` and ``global_metrics`` on a fake
CPU mesh of the same size, bitwise: reset, 32 steps and a 16-step rollout
with auto_reset (ram and grayscale on 10 x 20, ram on 32 x 20), their
observations, rewards, dones, infos, states and the rollout's accumulator;
then 30 ``shard_map_step`` steps. Each rank writes its block; the blocks
are concatenated here. The world of 2 also runs ``collective_bench`` and
``scaling_bench``. One world per size, each with its own timeout."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu.core import engine as JE
from gym_simpletetris_tpu.core.state import init_state as jax_init_state
from gym_simpletetris_tpu.parallel import mesh as JM
from gym_simpletetris_tpu_torch.core.state import FIELDS
from torch_dist_harness import (ENV_B, ENV_CASES, ENV_STEPS, ENV_T,
                                run_world)
import port_harness  # noqa: F401 (torch on one CPU thread)

WORLDS = (2, 4)


_WORLDS = {}


def _world(n, tmp_path_factory):
    """The world of n ranks, started once for the module."""
    if n not in _WORLDS:
        _WORLDS[n] = run_world(n, "env_job",
                               tmp_path_factory.mktemp(f"mesh{n}"),
                               bench=(n == 2))
    return n, _WORLDS[n]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request, tmp_path_factory):
    return _world(request.param, tmp_path_factory)


def _cat(outs, key, want):
    """The ranks' blocks of ``key`` joined along the axis where the JAX
    array is n times larger (replicated outputs: equal on every rank)."""
    parts = [o[key] for o in outs]
    want = np.asarray(want)
    if parts[0].shape == want.shape:
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0], err_msg=key)
        return parts[0]
    n = len(parts)
    axis = [d for d in range(want.ndim)
            if parts[0].shape[d] * n == want.shape[d]]
    assert len(axis) == 1, (key, parts[0].shape, want.shape)
    return np.concatenate(parts, axis=axis[0])


def _assert_bitwise(outs, key, want):
    want = np.asarray(want)
    got = _cat(outs, key, want)
    if want.dtype == np.uint32:
        got = got.astype(np.uint32)
    assert got.shape == want.shape, (key, got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=key)


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), (JM.DATA_AXIS,))


def _jax_env_run(n, kw):
    """JAX's ShardedTetrisEnv on an n-device mesh through the same inputs
    as ``torch_dist_harness.env_job``."""
    B = ENV_B * n
    cfg = JaxConfig(auto_reset=True, reward_step=True, **kw)
    mesh = _jax_mesh(n)
    env = JM.ShardedTetrisEnv(cfg, B, mesh)
    rng = np.random.RandomState(0)
    obs, s = env.reset(jax.random.PRNGKey(3))
    out = {"reset_obs": np.asarray(obs)}
    rec = {"obs": [], "reward": [], "done": []}
    infos = {}
    for _ in range(ENV_STEPS):
        obs, s, r, d, info = env.step(s, jnp.asarray(rng.randint(0, 7, B)))
        for k, v in (("obs", obs), ("reward", r), ("done", d)):
            rec[k].append(np.asarray(v))
        for k, v in info.items():
            infos.setdefault(k, []).append(np.asarray(v))
    for k, v in list(rec.items()) + [(f"info.{k}", v)
                                     for k, v in infos.items()]:
        out[k] = np.stack(v)
    for f in FIELDS:
        out[f"state.{f}"] = np.asarray(getattr(s, f))
    acts = jnp.asarray(rng.randint(0, 7, (ENV_T, B)), jnp.int32)
    final, acc, rew, don = env.rollout(s, acts)
    out.update(acc=np.asarray(acc), roll_reward=np.asarray(rew),
               roll_done=np.asarray(don))
    for f in FIELDS:
        out[f"final.{f}"] = np.asarray(getattr(final, f))
    for k, v in JM.global_metrics(final, mesh).items():
        out[f"metric.{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", [c[0] for c in ENV_CASES])
def test_sharded_env_matches_jax(world, case):
    n, outs = world
    want = _jax_env_run(n, dict(ENV_CASES)[case])
    keys = [k for k in outs[0] if k.startswith(case + "/")]
    assert {k.split("/", 1)[1] for k in keys} == set(want), case
    for k in keys:
        _assert_bitwise(outs, k, want[k.split("/", 1)[1]])


def test_global_metrics_are_global(world):
    """The metrics are the same on every rank and are JAX's (held within
    test_sharded_env_matches_jax); here: sums over the global batch."""
    n, outs = world
    for case, _ in ENV_CASES:
        steps = sum(int(o[f"{case}/final.time"].sum()) for o in outs)
        for o in outs:
            assert int(o[f"{case}/metric.env_steps"]) == steps


def test_shard_map_step_matches_jax(world):
    """Each shard folds its index into the key: bitwise JAX's shard_map_step
    on a mesh of the same size, the finished count and the carried key."""
    n, outs = world
    B = ENV_B * n
    cfg = JaxConfig(auto_reset=True, width=4, height=5)
    mesh = _jax_mesh(n)
    st = jax_init_state(cfg, B, jax.random.PRNGKey(4))
    st, _ = JE.engine_clear(cfg, st)
    st = jax.tree.map(jax.device_put, st, JM.state_sharding(mesh, cfg))
    step = jax.jit(JM.shard_map_step(cfg, mesh))
    rec = {"obs": [], "reward": [], "done": [], "finished": [], "piece": []}
    for _ in range(30):
        obs, st, r, d, fin = step(st, jnp.full((B,), 2, jnp.int32))
        for k, v in zip(rec, (obs, r, d, fin, st.piece)):
            rec[k].append(np.asarray(v))
    for k, v in rec.items():
        _assert_bitwise(outs, f"smap/{k}", np.stack(v))
    for f in FIELDS:
        _assert_bitwise(outs, f"smap/state.{f}", np.asarray(getattr(st, f)))
    np.testing.assert_array_equal(outs[0]["smap/gathered_rows"],
                                  np.asarray(st.rows))
    # the shards decorrelate: their first envs' piece streams differ
    h = np.concatenate([o["smap/piece"] for o in outs], axis=1)
    assert not all(np.array_equal(h[:, 0], h[:, i * ENV_B])
                   for i in range(1, n))


def test_indivisible_global_batch_raises(world):
    """A global batch the world does not divide raises, as in JAX."""
    _, outs = world
    assert all(bool(o["indivisible_refused"]) for o in outs)


def test_benches_run_and_keep_the_jax_keys(tmp_path_factory):
    """collective_bench (0.5 MB, 2 iters) and scaling_bench (tiny, env and
    actor-learner) at world 2 return the JAX scripts' keys."""
    _, outs = _world(2, tmp_path_factory)
    cb = json.loads(str(outs[0]["collective"]))
    assert cb["devices"] == 2 and cb["mb_per_device"] == 0.5
    assert {r["op"] for r in cb["results"]} == {"psum", "all_gather_sum",
                                                "ppermute"}
    for r in cb["results"]:
        assert r["seconds"] > 0 and r["algo_GBps_per_device"] > 0
    for key, extra in (("scaling", set()),
                       ("train", {"mode", "learn_steps"})):
        res = json.loads(str(outs[0][key]))
        assert [r["devices"] for r in res] == [1, 2]
        for r in res:
            assert {"devices", "global_batch", "env_steps_per_sec",
                    "per_device_steps_per_sec", "wall_s"} | extra == set(r)
            assert r["global_batch"] == 8 * r["devices"]
            assert r["env_steps_per_sec"] > 0


def test_init_distributed_is_a_noop_at_one_process(monkeypatch):
    import torch.distributed as dist
    from gym_simpletetris_tpu_torch.parallel.mesh import init_distributed
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    was = dist.is_initialized()
    init_distributed()
    assert dist.is_initialized() == was
