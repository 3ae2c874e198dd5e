"""The port's DQN learner on the frame ring and the obs ring against the JAX
package's (``test_torch_frame_ring.py`` holds the rings and the actor): the
full grayscale Rainbow of ``test_torch_dqn.py`` (NatureDQN with C51,
dueling, noisy nets, 4 stacked frames, 3-step returns, ``learn_every`` 4),
every actor step bitwise up to the first learner step, whose loss, mean_q
and td_abs_err agree within 1e-4 (measured: within 3e-6; the learner's
float sums run in torch's order).
"""

import numpy as np
import pytest

import port_harness  # noqa: F401 (torch on one CPU thread)
from test_torch_dqn import _run_to_first_learn


@pytest.mark.parametrize("name,over", [
    ("d_gray_rainbow", dict(frame_ring=True, ring_stacks=True,
                            sample_slots=True)),
    ("d_gray_rainbow", dict(frame_ring=True, prioritized=False))],
    ids=["obs_ring_slot_per", "frame_ring_uniform"])
def test_first_learner_step_within_1e_4(name, over):
    """The full grayscale Rainbow (C51, dueling, noisy, 4 frames, 3-step,
    learn_every 4) on a frame ring: every actor step bitwise to the first
    learner step, its metrics within 1e-4."""
    jcfg, js, jm, ts, tm = _run_to_first_learn(name, **over)
    for k in ("loss", "mean_q", "td_abs_err"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    assert float(jm["loss"]) > 0 and int(ts.opt_state["count"]) == 1
