"""The trainers' data-parallel branches (``make_train``, ``make_ppo``,
``make_es`` with ``mesh=``) in a world of 4 processes over gloo on the CPU,
against the port's unsharded trainers and the JAX package's, on the JAX
tests' own tiny configurations (``tests/test_sharding.py``,
``tests/test_es.py``), from the same flax parameters:

- DQN, 40 steps: env rows and replay dones bitwise, learner steps equal
  and above 0; the first learner step's loss, mean_q and td_abs_err and the
  parameters after it within rtol 2e-4, atol 2e-6 of both unsharded runs;
- PPO, 5 updates: env rows bitwise; the first update's loss metrics within
  2e-4 / 2e-6 of both unsharded runs;
- PPO with a shuffle block of every env of a step (each block straddles
  the ranks), 2 updates: env rows bitwise with the port's unsharded run;
- the parameters after every run within 2e-4 / 2e-6 of the port's
  unsharded run. The learner sums the ranks' float32 gradient shares and
  rounds once, as the unsharded learner rounds its gradient, so the two
  differ only where a sum in another order lands on the other side of a
  bf16 rounding boundary. Against JAX's runs the port's unsharded learner
  itself drifts by more than 2e-4 / 2e-6 over a run (torch's and XLA's
  float32 sums round a few gradients the other way, and Adam's early
  steps amplify them; ``tests/test_torch_ppo.py`` holds no bf16 PPO
  parameters to JAX), so JAX is held at the first update;
- ES, 1 generation: theta bitwise with the port's unsharded run and within
  1e-6 of JAX's.

A mesh with a model axis is ``test_torch_tensor_parallel.py``'s.
"""

import jax
import numpy as np
import pytest

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu.train import dqn as jax_dqn
from gym_simpletetris_tpu.train import es as jax_es
from gym_simpletetris_tpu.train import ppo as jax_ppo
from port_harness import flax_to_state_dict
import torch_dist_harness as H

WORLD = 4
TOL = dict(rtol=2e-4, atol=2e-6)
_EKW = dict(obs_type="ram", auto_reset=True, reward_step=True, width=6,
            height=8)


def _save_sd(path, params) -> str:
    np.savez(path, **{k: v.numpy() for k, v in
                      flax_to_state_dict(params).items()})
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's unsharded runs, the port's unsharded runs and the world of 4,
    from the same parameters."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    return _runs(tmp)


def _runs(tmp):
    jcfg = jax_dqn.DQNConfig(env=JaxConfig(**_EKW), **H.DQN_KW)
    init, step, _, _ = jax_dqn.make_train(jcfg)
    js = init(jax.random.PRNGKey(7))
    dqn_sd = _save_sd(tmp / "dqn.npz", js.params)
    step = jax.jit(step)
    jloss, jfirst = [], None
    for _ in range(H.DQN_STEPS):
        js, jm = step(js)
        jloss.append({k: float(v) for k, v in jm.items()})
        if jfirst is None and int(js.learn_steps) == 1:
            jfirst = js.params

    pcfg = jax_ppo.PPOConfig(env=JaxConfig(**_EKW), **H.PPO_KW)
    init, update, _ = jax_ppo.make_ppo(pcfg)
    jp = init(jax.random.PRNGKey(9))
    ppo_sd = _save_sd(tmp / "ppo.npz", jp.params)
    update = jax.jit(update)
    jp_first = None
    for _ in range(H.PPO_UPDATES):
        jp, jm = update(jp)
        jp_first = jp_first or ({k: float(v) for k, v in jm.items()},
                                jp.params)

    ecfg = jax_es.ESConfig(env=JaxConfig(**_EKW), **H.ES_KW)
    init, gen, _ = jax_es.make_es(ecfg)
    je = init(jax.random.PRNGKey(5))
    theta = str(tmp / "theta.npy")
    np.save(theta, np.asarray(je.theta))
    je, _ = jax.jit(gen)(je)

    world = H.run_world(WORLD, "train_job", tmp, dqn_params=dqn_sd,
                        ppo_params=ppo_sd, es_theta=theta)
    port = {"dqn": H.dqn_run(None, dqn_sd), "ppo": H.ppo_run(None, ppo_sd),
            "ppo_block": H.ppo_run(None, None, H.PPO_BLOCK_KW,
                                   H.PPO_BLOCK_UPDATES),
            "es": H.es_run(None, theta)}
    jax_side = {"dqn": (js, jloss, jfirst), "ppo": (jp, jp_first), "es": je}
    return world, port, jax_side


def _cat(world, key, axis):
    return np.concatenate([o[key] for o in world], axis=axis)


def _replicated(world, key):
    for o in world[1:]:
        np.testing.assert_array_equal(o[key], world[0][key], err_msg=key)
    return world[0][key]


def _close_params(world, key, port_params, jax_params=None):
    """The replicated parameters ``key`` within TOL of the port's unsharded
    ``port_params`` (and of JAX's, when given)."""
    want = [("port", {k: v.numpy() for k, v in port_params.items()})]
    if jax_params is not None:
        want.append(("jax", {k: v.numpy() for k, v in
                             flax_to_state_dict(jax_params).items()}))
    for k in port_params:
        got = _replicated(world, f"{key}.{k}")
        for what, sd in want:
            np.testing.assert_allclose(got, sd[k], **TOL,
                                       err_msg=f"{key} {k} vs {what}")


def test_dqn_mesh_matches_unsharded(runs):
    world, port, jax_side = runs
    (ts, tm, tfirst), (js, jloss, jfirst) = port["dqn"], jax_side["dqn"]
    rows = _cat(world, "dqn/env_state.rows", 1)
    np.testing.assert_array_equal(rows, ts.env_state.rows.numpy())
    np.testing.assert_array_equal(rows.view(np.uint32),
                                  np.asarray(js.env_state.rows))
    done = _cat(world, "dqn/replay.done", 1)
    np.testing.assert_array_equal(done, ts.replay.done.numpy())
    np.testing.assert_array_equal(done, np.asarray(js.replay.done))
    learn = int(_replicated(world, "dqn/learn_steps"))
    assert learn == int(ts.learn_steps) == int(js.learn_steps) > 0
    loss = _replicated(world, "dqn/metric.loss")
    t = int(np.nonzero(loss)[0][0])             # the first learner step
    for k in ("loss", "mean_q", "td_abs_err"):
        got = _replicated(world, f"dqn/metric.{k}")[t]
        np.testing.assert_allclose(got, tm[k][t], **TOL, err_msg=k)
        np.testing.assert_allclose(got, jloss[t][k], **TOL, err_msg=k)
    _close_params(world, "dqn/first", tfirst, jfirst)
    _close_params(world, "dqn/params", ts.params)


def test_ppo_mesh_matches_unsharded(runs):
    world, port, jax_side = runs
    (ts, tm, _), (jp, (jm, _)) = port["ppo"], jax_side["ppo"]
    rows = _cat(world, "ppo/env_state.rows", 1)
    np.testing.assert_array_equal(rows, ts.env_state.rows.numpy())
    np.testing.assert_array_equal(rows.view(np.uint32),
                                  np.asarray(jp.env_state.rows))
    assert int(_replicated(world, "ppo/update")) == H.PPO_UPDATES
    for k in ("pg_loss", "v_loss", "entropy", "clip_frac"):
        got = _replicated(world, f"ppo/metric.{k}")[0]
        np.testing.assert_allclose(got, tm[k][0], **TOL, err_msg=k)
        np.testing.assert_allclose(got, jm[k], **TOL, err_msg=k)
    _close_params(world, "ppo/params", ts.params)


def test_ppo_mesh_shuffle_block_straddles_ranks(runs):
    world, port, _ = runs
    ts, tm, _ = port["ppo_block"]
    np.testing.assert_array_equal(_cat(world, "ppo_block/env_state.rows", 1),
                                  ts.env_state.rows.numpy())
    for k in ("episodes_done", "lines_cleared"):
        np.testing.assert_array_equal(
            _replicated(world, f"ppo_block/metric.{k}"), tm[k], err_msg=k)
    _close_params(world, "ppo_block/params", ts.params)


def test_es_mesh_theta_bitwise(runs):
    world, port, jax_side = runs
    (ts, _), je = port["es"], jax_side["es"]
    theta = _replicated(world, "es/theta")
    np.testing.assert_array_equal(theta.view(np.int32),
                                  ts.theta.numpy().view(np.int32))
    np.testing.assert_allclose(theta, np.asarray(je.theta), rtol=0,
                               atol=1e-6)
