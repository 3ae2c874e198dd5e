"""The port's DQN learner against the JAX package's (see
``test_torch_dqn.py`` for the configurations and the trajectory checks):
the first learner step in float32 networks, the target sync, the
``learn_every`` slots, slot-row sampling and ``DQNConfig``'s validation.

float32 networks (both trainers' networks swapped for float32 ones, as the
PPO tests do): after the first learner step every parameter within 1e-4
(measured up to 3e-5: torch sums in another order than XLA, and Adam's
first step divides by |g|).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu.train import dqn as jax_dqn
from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.train import dqn
from port_harness import flax_to_state_dict
from test_torch_dqn import _pair, _run_to_first_learn
from port_harness import torch_one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.mark.parametrize("name", ["a_ram_default", "d_gray_rainbow"])
def test_first_learner_step_f32_params_within_1e_4(monkeypatch, name):
    jb, tb = jax_dqn.build_q_network, dqn.build_q_network
    monkeypatch.setattr(jax_dqn, "build_q_network",
                        lambda *a, **k: jb(*a, **k).clone(dtype=jnp.float32))
    monkeypatch.setattr(dqn, "build_q_network",
                        functools.partial(tb, dtype=torch.float32))
    jcfg, js, jm, ts, tm = _run_to_first_learn(name)
    for k in ("loss", "mean_q", "td_abs_err"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    jp = flax_to_state_dict(js.params)
    assert set(jp) == set(ts.params)
    for k, v in jp.items():
        np.testing.assert_allclose(ts.params[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
        assert not torch.equal(ts.params[k], ts.target_params[k]) or \
            (int(ts.learn_steps) % jcfg.target_update_period == 0), k


def test_target_syncs_every_period():
    """target_update_period = 2: the target stays at the init params after
    the first learner step and equals the params after the second."""
    _, tcfg = _pair("a_ram_default")
    init_fn, step_fn, _, _ = dqn.make_train(tcfg, "cpu")
    s = init_fn(0)
    p0 = s.params
    seen = []
    for _ in range(12):
        s, m = step_fn(s)
        n = int(s.learn_steps)
        same = all(torch.equal(s.target_params[k], s.params[k]) for k in p0)
        orig = all(torch.equal(s.target_params[k], p0[k]) for k in p0)
        seen.append((n, same, orig))
    assert (1, False, True) in seen and (2, True, False) in seen
    assert (3, False, False) in seen and (4, True, False) in seen


def test_learn_every_flags():
    """learn_every = 4: learner steps only on every fourth actor step of a
    chunk once warm, and the learner metrics average over those slots."""
    _, tcfg = _pair("a_ram_default", learn_every=4, learn_starts=8)
    init_fn, _, chunk_fn, _ = dqn.make_train(tcfg, "cpu")
    s = init_fn(1)
    s, m = chunk_fn(s, 8)
    assert int(s.step) == 8 and int(s.learn_steps) == 2
    assert float(m["loss"]) > 0
    s, m = chunk_fn(s, 12)
    assert int(s.learn_steps) == 5
    with pytest.raises(ValueError, match="multiple of learn_every"):
        chunk_fn(s, 6)


def test_config_validation_and_frame_ring():
    with pytest.raises(ValueError, match="multiple of num_envs"):
        dqn.DQNConfig(num_envs=10, buffer_capacity=25)
    with pytest.raises(ValueError, match="learn_every"):
        dqn.DQNConfig(learn_every=0)
    with pytest.raises(ValueError, match="ring_stacks"):
        dqn.DQNConfig(ring_stacks=True)
    with pytest.raises(ValueError, match="whole slot rows"):
        dqn.DQNConfig(sample_slots=True, num_envs=16, buffer_capacity=64,
                      learn_batch=24)
    with pytest.raises(ValueError, match="ring_stacks=True or frame_stack"):
        dqn.DQNConfig(sample_slots=True, frame_ring=True, frame_stack=4,
                      num_envs=16, buffer_capacity=64, learn_batch=32)
    with pytest.raises(ValueError, match="auto_reset"):
        dqn.make_train(dqn.DQNConfig(env=EnvConfig()), "cpu")
    # the frame ring and the obs ring build (ROADMAP item 11d), and run_dqn
    # runs on each layout
    from gym_simpletetris_tpu_torch.train.replay import FrameRingState
    from gym_simpletetris_tpu_torch.train.run_dqn import main
    for stacks in (False, True):
        init_fn = dqn.make_train(dqn.DQNConfig(
            num_envs=4, buffer_capacity=32, frame_ring=True,
            ring_stacks=stacks), "cpu")[0]
        assert isinstance(init_fn(0).replay, FrameRingState)
    for layout in ("frame-ring", "obs-ring"):
        state = main(["--replay-layout", layout, "--device", "cpu",
                      "--num-envs", "4", "--buffer", "32", "--chunk", "2",
                      "--total-steps", "2", "--width", "6", "--height", "8"])
        assert state.replay.stacked == (layout == "obs-ring")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dqn.make_train(dqn.DQNConfig(), "cuda")


def test_sample_slots_trains():
    """Slot-row sampling, uniform and prioritized, runs and learns."""
    for per in (False, True):
        _, tcfg = _pair("a_ram_default", sample_slots=True, prioritized=per)
        init_fn, _, chunk_fn, _ = dqn.make_train(tcfg, "cpu")
        s, m = chunk_fn(init_fn(2), 8)
        assert int(s.learn_steps) == 4 and np.isfinite(float(m["loss"]))
