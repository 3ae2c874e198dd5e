"""The port's entry points in ``graft_entry.py``: ``entry()`` gives
the dueling NatureDQN forward on 8 grayscale 84 x 84 observations, and
``dryrun_multichip(2)`` completes over gloo on the CPU: both trainer
families on a world of 2 processes, their metrics held to the unsharded
run (the DQN chunk's bitwise here)."""

import numpy as np

from gym_simpletetris_tpu_torch import graft_entry


def test_entry_forward_on_the_cpu():
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    assert tuple(args[0].shape) == (8, 84, 84, 1)
    assert tuple(out.shape) == (8, 7) and bool(out.isfinite().all())


def test_dryrun_multichip_2_on_gloo(capsys):
    metrics = graft_entry.dryrun_multichip(2, "cpu")
    said = capsys.readouterr().out
    assert "DQN mesh (2, 1) ok" in said and "PPO mesh (2, 1) ok" in said
    assert "15b" in said
    assert {k.split(".")[0] for k in metrics} == {"dqn", "ppo"}
    assert float(metrics["dqn.loss"]) != 0.0       # the learner ran
    assert all(np.isfinite(v).all() for v in metrics.values())
