"""The port's entry points in ``graft_entry.py``: ``entry()`` gives
the dueling NatureDQN forward on 8 grayscale 84 x 84 observations, and
``dryrun_multichip(2)`` completes over gloo on the CPU: both trainer
families on a world of 2 processes at the (data, model) shapes (2, 1) and
(1, 2), their metrics held to the unsharded run."""

import numpy as np

from gym_simpletetris_tpu_torch import graft_entry
import port_harness  # noqa: F401 (torch on one CPU thread)


def test_entry_forward_on_the_cpu():
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    assert tuple(args[0].shape) == (8, 84, 84, 1)
    assert tuple(out.shape) == (8, 7) and bool(out.isfinite().all())


def test_dryrun_multichip_2_on_gloo(capsys):
    metrics = graft_entry.dryrun_multichip(2, "cpu")
    said = capsys.readouterr().out
    for shape in ("(2, 1)", "(1, 2)"):
        for family in ("DQN", "PPO"):
            assert f"{family} mesh {shape} ok" in said
    assert {k.split(".")[0] for k in metrics} == {
        f"{shape}/{family}" for shape in ("2x1", "1x2")
        for family in ("dqn", "ppo")}
    for shape in ("2x1", "1x2"):                  # the learner ran
        assert float(metrics[f"{shape}/dqn.loss"]) != 0.0
    assert all(np.isfinite(v).all() for v in metrics.values())
