"""The port's DQN trainer (``train/dqn.py``) against the JAX package's, from
the same init state with the flax parameters carried across: the actor's
trajectory up to the first learner step. ``test_torch_dqn_learner.py``
holds the learner, ``test_torch_run_dqn.py`` the CLI and the policy.

Four configurations on 6 x 8 ram boards and 84 px images: (a) the ram
default; (b) ram with PER, 3-step returns and dueling; (c) ram with C51,
noisy nets and double DQN, its selection on the loss's noise draw
(``noisy_shared_selection``); (d) grayscale with ``frame_stack`` 4, the
full Rainbow and ``learn_every`` 4.

- bf16 (the defaults): the init state, the prefill and every actor step up
  to the first learner step bitwise (env state, observation stack, key,
  n-step window, every replay field), the actor metrics equal, the first
  learner step's loss, mean_q and td_abs_err within 1e-4.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu.train import dqn as jax_dqn
from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.train import dqn
from port_harness import (assert_bitwise, assert_state_equal,
                          flax_to_state_dict)

CONFIGS = {
    "a_ram_default": dict(),
    "b_per_nstep_dueling": dict(prioritized=True, n_step=3, dueling=True),
    "c_c51_noisy_double": dict(distributional=True, noisy=True,
                               double_dqn=True, noisy_shared_selection=True),
    "d_gray_rainbow": dict(frame_stack=4, n_step=3, prioritized=True,
                           distributional=True, dueling=True, noisy=True,
                           learn_every=4),
}
REPLAY = ("obs", "next_obs", "action", "reward", "discount", "done",
          "priority", "ptr", "filled_slots", "max_p")
REPLAY_FRAME = ("frame", "action", "reward", "done", "priority", "ptr",
                "filled_slots", "max_p")


def _pair(name, **over):
    kw = dict(CONFIGS[name], **over)
    gray = name.startswith("d")
    ekw = dict(obs_type="grayscale" if gray else "ram", auto_reset=True,
               reward_step=True, penalise_holes=True, width=6, height=8)
    b = 4 if gray else 8
    common = dict(dict(num_envs=b, buffer_capacity=b * 8, learn_batch=16,
                       learn_starts=b * 5, target_update_period=2,
                       eps_decay_steps=20), **kw)
    return (jax_dqn.DQNConfig(env=JaxConfig(**ekw), **common),
            dqn.DQNConfig(env=EnvConfig(**ekw), **common))


def _init_pair(jcfg, tcfg, seed=3):
    """Both trainers' init states; the port takes the flax parameters."""
    jfns = jax_dqn.make_train(jcfg)
    tfns = dqn.make_train(tcfg, "cpu")
    js, ts = jfns[0](jax.random.PRNGKey(seed)), tfns[0](seed)
    sd = flax_to_state_dict(js.params)
    zeros = lambda: {k: torch.zeros_like(v) for k, v in sd.items()}
    ts = ts.replace(params=sd, target_params=dict(sd),
                    opt_state=dict(ts.opt_state, mu=zeros(), nu=zeros()))
    return jfns, js, tfns, ts


def _assert_actor_state_equal(js, ts, msg):
    assert_state_equal(js.env_state, ts.env_state, msg)
    assert_bitwise(ts.obs, np.asarray(js.obs), f"{msg} obs")
    assert_bitwise(ts.key, np.asarray(js.key).view(np.int32), f"{msg} key")
    assert int(ts.step) == int(js.step), msg
    for f in _ring_fields(js)[0]:
        assert_bitwise(getattr(ts.replay, f), np.asarray(getattr(js.replay, f)),
                       f"{msg} replay.{f}")
    if js.window is not None:
        for f in js.window:
            assert_bitwise(ts.window[f], np.asarray(js.window[f]),
                           f"{msg} window.{f}")


def _ring_fields(js):
    """(the fields the actor writes, the priority and counter fields) of
    the JAX state's replay ring, legacy or frame ring."""
    if hasattr(js.replay, "frame"):
        return REPLAY_FRAME[:4], REPLAY_FRAME[4:]
    return REPLAY[:6], REPLAY[6:]


def _assert_ring_equal(js, ts, msg):
    _assert_actor_state_equal(js, ts, msg)
    for f in _ring_fields(js)[1]:
        assert_bitwise(getattr(ts.replay, f), np.asarray(getattr(js.replay, f)),
                       f"{msg} replay.{f}")


def _run_to_first_learn(name, **over):
    """Step both trainers one chunk of ``learn_every`` actor steps at a
    time up to and including the first learner step, holding everything
    before it bitwise. Returns (JAX state, its metrics, port state, its
    metrics) after that chunk."""
    jcfg, tcfg = _pair(name, **over)
    jfns, js, tfns, ts = _init_pair(jcfg, tcfg)
    _assert_ring_equal(js, ts, "init")
    le = jcfg.learn_every
    jchunk = jax.jit(partial(jfns[2], n=le))
    for c in range(100):
        js, jm = jchunk(js)
        ts, tm = tfns[2](ts, le)
        assert list(tm) == sorted(jm)
        _assert_actor_state_equal(js, ts, f"chunk {c}")
        for k in ("mean_reward", "episodes_done", "lines_cleared", "epsilon"):
            assert float(tm[k]) == float(jm[k]), (k, c)
        if int(js.learn_steps):
            assert int(ts.learn_steps) == 1
            return jcfg, js, jm, ts, tm
        _assert_ring_equal(js, ts, f"chunk {c}")
        assert float(tm["loss"]) == float(jm["loss"]) == 0.0
    raise AssertionError("no learner step")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trajectory_bitwise_to_the_first_learner_step(name):
    jcfg, js, jm, ts, tm = _run_to_first_learn(name)
    # the learner's step counts on the learner slots of the chunk
    for k in ("loss", "mean_q", "td_abs_err"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    assert float(jm["loss"]) > 0 and np.isfinite(float(tm["loss"]))
    assert int(ts.opt_state["count"]) == 1
