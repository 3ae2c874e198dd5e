"""Tensor parallelism with a noisy network, and checkpoints across mesh
shapes, in a world of 2 processes over gloo on the CPU at (data, model) =
(1, 2).

- The obs-ring Rainbow (``tests/test_frame_ring.py``'s mesh configuration:
  grayscale 6 x 8, 16 envs, 4 stacked frames, 2-step, noisy dueling) with
  a C51 head of 4 atoms, so that every layer is split over the model axis:
  the conv trunk's 32 / 64 / 64 channels, the noisy 512-wide dense and the
  noisy heads of widths 4 and 28; 16 steps, 14 of them with a learner
  update. Env rows, the ring's frames, actions and dones bitwise with the
  port's unsharded run, parameters within rtol 2e-4, atol 2e-6 of it; each
  NoisyDense's noisy weight, for one noise key, bitwise the rows of the
  unsharded layer's on the same (gathered) parameters, and its bias whole.
- Checkpoints (``tests/test_checkpoint_topology.py``'s configuration: PER,
  2-step, dueling, noisy ram; its 512 / 256 noisy layers split): the init
  state saved at (1, 2) is the unsharded run's file byte for byte; a state
  saved at (1, 2) after 24 steps and restored at (1, 2) continues 5 steps
  exactly as the run that was never saved; restored unsharded and at
  (2, 1), it continues with env rows, ring contents and dones bitwise and
  the learner within the tolerance above.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import torch_dist_harness as H
from gym_simpletetris_tpu_torch.train import dqn
from gym_simpletetris_tpu_torch.utils.checkpoint import restore_checkpoint
import port_harness  # noqa: F401 (torch on one CPU thread)

WORLD = 2
TOL = dict(rtol=2e-4, atol=2e-6)
_INTEGER_STATE = ("env_state.rows", "replay.obs", "replay.next_obs",
                  "replay.action", "replay.done", "replay.ptr",
                  "replay.filled_slots", "step", "learn_steps")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    for d in ("tp", "unsharded"):
        os.makedirs(tmp / d)
    world = H.run_world(WORLD, "tp_ckpt_job", tmp,
                        path=str(tmp / "tp" / "dqn.pt"),
                        path0=str(tmp / "tp" / "init.pt"))
    ring, _ = H.tp_ring_run(None)
    # the unsharded layers' noisy weights on the world's parameters
    cfg = dqn.DQNConfig(env=H.env_cfg("grayscale"), **H.TP_RING_KW)
    network = dqn.make_train(cfg, "cpu")[3]
    noisy = H.noisy_weights(network, {
        k: torch.from_numpy(_whole(world, f"ring/params.{k}", v.numpy()))
        for k, v in ring[0].params.items()})
    H.ckpt_run(None, str(tmp / "unsharded" / "dqn.pt"),
               str(tmp / "unsharded" / "init.pt"))
    cfg = dqn.DQNConfig(env=H.env_cfg(), **H.CKPT_KW)
    _, step_fn, _, _ = dqn.make_train(cfg, "cpu")
    one = H.continue_run(step_fn, restore_checkpoint(
        str(tmp / "tp" / "dqn.pt"), "cpu"))
    return tmp, world, ring, noisy, one


def _replicated(world, key):
    for o in world[1:]:
        np.testing.assert_array_equal(o[key], world[0][key], err_msg=key)
    return world[0][key]


def _whole(world, key, want):
    """A parameter: whole on both ranks, or their dim-0 blocks."""
    if world[0][key].shape == want.shape:
        return _replicated(world, key)
    return np.concatenate([o[key] for o in world], axis=0)


def test_obs_ring_tp_matches_unsharded(runs):
    _, world, (ts, tm), _, _ = runs
    for key, want in (("env_state.rows", ts.env_state.rows),
                      ("replay.frame", ts.replay.frame),
                      ("replay.action", ts.replay.action),
                      ("replay.done", ts.replay.done)):
        np.testing.assert_array_equal(_replicated(world, f"ring/{key}"),
                                      want.numpy(), err_msg=key)
    assert int(_replicated(world, "ring/learn_steps")) == \
        int(ts.learn_steps) > 0
    for k in ("episodes_done", "lines_cleared", "mean_reward", "loss",
              "mean_q", "td_abs_err"):
        np.testing.assert_allclose(_replicated(world, f"ring/metric.{k}"),
                                   tm[k].numpy(), **TOL, err_msg=k)
    split = 0
    for k, v in ts.params.items():
        split += world[0][f"ring/params.{k}"].shape != tuple(v.shape)
        np.testing.assert_allclose(_whole(world, f"ring/params.{k}",
                                          v.numpy()), v.numpy(), **TOL,
                                   err_msg=k)
    # 3 convs, the dense and the C51 value and advantage, mu and sigma
    assert split == 3 + 3 * 2


def test_noisy_weights_are_the_unsharded_rows(runs):
    _, world, _, noisy, _ = runs
    assert len(noisy) == 2 * 3
    for k, v in noisy.items():
        got = _whole(world, f"noisy/{k}", v)
        if k.endswith(".bias"):
            assert world[0][f"noisy/{k}"].shape == v.shape
        else:
            assert world[0][f"noisy/{k}"].shape[0] == v.shape[0] // 2
        np.testing.assert_array_equal(got.view(np.int32), v.view(np.int32),
                                      err_msg=k)


def test_checkpoint_at_1x2_is_the_unsharded_file(runs):
    tmp = runs[0]
    assert filecmp.cmp(tmp / "tp" / "init.pt", tmp / "unsharded" / "init.pt",
                       shallow=False)


def test_checkpoint_restored_at_1x2_continues_identically(runs):
    _, world, _, _, _ = runs
    keys = [k[len("cont/"):] for k in world[0] if k.startswith("cont/")]
    assert keys
    for o in world:
        for k in keys:
            np.testing.assert_array_equal(o[f"restored/{k}"], o[f"cont/{k}"],
                                          err_msg=k)


@pytest.mark.parametrize("where", ["unsharded", "2x1"])
def test_checkpoint_restored_elsewhere_continues(runs, where):
    """The (1, 2) run's continuation (``cont``) against the file restored
    unsharded, and the (2, 1) restore's continuation against the same."""
    _, world, _, _, (s1, m1) = runs
    want = H.record("x", s1, m1)
    prefix = "restored21" if where == "2x1" else "cont"
    for k in _INTEGER_STATE + tuple(f"metric.{m}" for m in (
            "episodes_done", "lines_cleared", "mean_reward")):
        np.testing.assert_array_equal(_replicated(world, f"{prefix}/{k}"),
                                      want[f"x/{k}"], err_msg=k)
    for k, v in s1.params.items():
        np.testing.assert_allclose(_replicated(world, f"{prefix}/params.{k}"),
                                   v.numpy(), **TOL, err_msg=k)
