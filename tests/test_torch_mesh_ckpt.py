"""The obs-ring Rainbow's data-parallel branch and checkpoints across
world sizes, in a world of 2 processes over gloo on the CPU.

- The obs-ring Rainbow on ``tests/test_frame_ring.py``'s mesh
  configuration (grayscale 6 x 8, 16 envs, 4 stacked frames, 2-step, noisy
  dueling): env rows, the ring's frames and dones bitwise with the port's
  unsharded run, learner steps equal and above 0, parameters within
  rtol 2e-4, atol 2e-6 of it (the ranks' float32 gradient shares are
  summed and rounded once, as the unsharded learner rounds its gradient;
  see test_torch_mesh_train.py).
- Checkpoints (``tests/test_checkpoint_topology.py``'s configuration: PER,
  2-step, dueling, noisy): the init state saved at world 2 is the unsharded
  run's file byte for byte; a state saved at world 2 after 24 steps and
  restored at world 2 continues 5 steps exactly as the run that was never
  saved; restored at world 1 it continues with env rows and ring dones
  bitwise and the learner within the tolerance above.
"""

import filecmp
import os

import numpy as np
import pytest

import torch_dist_harness as H
from gym_simpletetris_tpu_torch.train import dqn
from gym_simpletetris_tpu_torch.utils.checkpoint import restore_checkpoint
import port_harness  # noqa: F401 (torch on one CPU thread)

WORLD = 2
TOL = dict(rtol=2e-4, atol=2e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    for d in ("world2", "unsharded"):
        os.makedirs(tmp / d)
    world = H.run_world(WORLD, "ring_ckpt_job", tmp,
                        path=str(tmp / "world2" / "dqn.pt"),
                        path0=str(tmp / "world2" / "init.pt"))
    ring = H.ring_run(None)
    cont, _ = H.ckpt_run(None, str(tmp / "unsharded" / "dqn.pt"),
                         str(tmp / "unsharded" / "init.pt"))
    # the world-2 file restored at world 1
    cfg = dqn.DQNConfig(env=H.env_cfg(), **H.CKPT_KW)
    _, step_fn, _, _ = dqn.make_train(cfg, "cpu")
    one = H.continue_run(step_fn, restore_checkpoint(
        str(tmp / "world2" / "dqn.pt"), "cpu"))
    return tmp, world, ring, cont, one


def _cat(world, key, axis):
    return np.concatenate([o[key] for o in world], axis=axis)


def _replicated(world, key):
    for o in world[1:]:
        np.testing.assert_array_equal(o[key], world[0][key], err_msg=key)
    return world[0][key]


def test_obs_ring_mesh_matches_unsharded(runs):
    _, world, (ts, _), _, _ = runs
    for key, want in (("env_state.rows", ts.env_state.rows),
                      ("replay.frame", ts.replay.frame),
                      ("replay.done", ts.replay.done)):
        np.testing.assert_array_equal(
            _cat(world, f"ring/{key}", 1 if key != "env_state.rows" else -1),
            want.numpy(), err_msg=key)
    assert int(_replicated(world, "ring/learn_steps")) == \
        int(ts.learn_steps) > 0
    for k, v in ts.params.items():
        np.testing.assert_allclose(_replicated(world, f"ring/params.{k}"),
                                   v.numpy(), **TOL, err_msg=k)


def test_checkpoint_at_world_2_is_the_unsharded_file(runs):
    tmp = runs[0]
    assert filecmp.cmp(tmp / "world2" / "init.pt", tmp / "unsharded" /
                       "init.pt", shallow=False)


def test_checkpoint_restored_at_world_2_continues_identically(runs):
    _, world, _, _, _ = runs
    keys = [k[len("cont/"):] for k in world[0] if k.startswith("cont/")]
    assert keys
    for o in world:
        for k in keys:
            np.testing.assert_array_equal(o[f"restored/{k}"], o[f"cont/{k}"],
                                          err_msg=k)


def test_checkpoint_restored_at_world_1_continues(runs):
    _, world, _, _, (s1, m1) = runs
    np.testing.assert_array_equal(_cat(world, "cont/env_state.rows", 1),
                                  s1.env_state.rows.numpy())
    np.testing.assert_array_equal(_cat(world, "cont/replay.done", 1),
                                  s1.replay.done.numpy())
    assert int(_replicated(world, "cont/learn_steps")) == int(s1.learn_steps)
    for k, v in s1.params.items():
        np.testing.assert_allclose(_replicated(world, f"cont/params.{k}"),
                                   v.numpy(), **TOL, err_msg=k)
    for k in ("episodes_done", "lines_cleared", "mean_reward"):
        np.testing.assert_array_equal(_replicated(world, f"cont/metric.{k}"),
                                      m1[k], err_msg=k)
