"""The port's flagship Rainbow learner (``train/dqn.py`` with the Nature
trunk, noisy dueling C51 head, 3-step PER on the obs ring) against the plain
float32 reference (``perfbench/reference_torch/rainbow.py``), on
seeded random weights and 84 px frames at 8 envs on the CPU, under the
tolerances of the benchmark's comparison (``perfbench/entries/dqn_train.py``
``TOL``): the forward with noise and without, the C51 projection, the n-step
fold from obs-ring rows, IS weights and new priorities, one whole learner
update; controls that each fail a tolerance (the dueling mean dropped, the
projection shifted by an atom, activations in float8, below the
configuration's bf16); the trainer's spans and counters; the reference's
imports.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.func import functional_call

from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.core import threefry
from gym_simpletetris_tpu_torch.train import dqn, replay
from gym_simpletetris_tpu_torch.utils import profiling
from perfbench.entries.dqn_train import TOL, learner_checks, learner_record
from perfbench.reference_torch import rainbow as R
import port_harness  # noqa: F401 (torch on one CPU thread)

ROOT = Path(__file__).resolve().parents[1]
PALETTE = torch.tensor([0, 128, 190], dtype=torch.uint8)
ENVS, SLOTS, ROWS = 8, 16, 64


def _cfg(**kw):
    return dqn.DQNConfig(
        env=EnvConfig(obs_type="grayscale", auto_reset=True, reward_step=True,
                      penalise_height=True),
        num_envs=ENVS, buffer_capacity=ENVS * SLOTS, learn_batch=ROWS,
        learn_every=4, frame_stack=4, prioritized=True, n_step=3,
        dueling=True, distributional=True, noisy=True, frame_ring=True,
        ring_stacks=True, learn_starts=ENVS, **kw)


def _frames(gen, *shape):
    return PALETTE[torch.randint(0, 3, shape, generator=gen)]


def _fill(rs, gen, done_rate=0.3):
    """Random stacks, rewards, dones and priorities in every slot of the
    ring, the pointer mid-ring, the ring full."""
    rs.frame.copy_(_frames(gen, *rs.frame.shape))
    rs.reward.copy_(torch.randn(rs.reward.shape, generator=gen) * 5)
    rs.done.copy_(torch.rand(rs.done.shape, generator=gen) < done_rate)
    rs.priority.copy_(torch.rand(rs.priority.shape, generator=gen) + 0.05)
    rs.action.copy_(torch.randint(0, 7, rs.action.shape, generator=gen))
    return rs.replace(ptr=torch.tensor(5, dtype=torch.int32),
                      filled_slots=torch.tensor(rs.slots, dtype=torch.int32))


def _random_params(params, gen):
    """The init's weights with every bias and sigma moved off its init."""
    out = {}
    for k, v in params.items():
        if "bias" in k or "sigma" in k:
            v = v + 0.02 * torch.randn(v.shape, generator=gen)
        out[k] = v.clone()
    return out


@pytest.fixture(scope="module")
def learned():
    """One learner update of the port from a filled ring, recorded."""
    cfg = _cfg(target_update_period=1000)
    init_fn, _, chunk, net = dqn.make_train(cfg, "cpu")
    state = init_fn(2 ** 31 - 99)
    gen = torch.Generator().manual_seed(5)
    params = _random_params(state.params, gen)
    moments = lambda f: {k: f(v) for k, v in params.items()}
    state = state.replace(
        params=params,
        target_params={k: v + 0.01 * torch.randn(v.shape, generator=gen)
                       for k, v in params.items()},
        opt_state={"count": torch.tensor(7, dtype=torch.int32),
                   "mu": moments(lambda v: 1e-4 * torch.randn(
                       v.shape, generator=gen)),
                   "nu": moments(lambda v: 1e-7 * torch.rand(
                       v.shape, generator=gen))},
        replay=_fill(state.replay, gen))
    return cfg, learner_record(dqn, cfg, chunk, net, state)


@pytest.mark.parametrize("noise", [True, False])
def test_the_noisy_dueling_c51_forward(noise):
    cfg = _cfg()
    net = dqn.build_q_network("grayscale", (84, 84, 4), dueling=True,
                              num_atoms=51, noisy=True)
    net.reset_parameters(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    params = _random_params(net.state_dict(), gen)
    obs = _frames(gen, 8, 84, 84, 4)
    key = threefry.split(torch.tensor([7, 11], dtype=torch.int32))[1] \
        if noise else None
    got = functional_call(net, params, (obs, key))
    want = R.forward(params, obs, key, num_atoms=cfg.num_atoms)
    # in units of the reference's own error in bf16, as the benchmark's
    bf16 = R.forward(params, obs, key, num_atoms=cfg.num_atoms,
                     dtype=torch.bfloat16)
    scale = (bf16 - want).abs().max().clamp(min=2 ** -8 * want.abs().max())
    err = lambda a: float((a - want).abs().max() / scale)
    assert got.shape == (8, 7, 51)
    assert err(got) < TOL["logits"]
    if noise:   # the noise moves the logits far beyond the tolerance
        assert err(R.forward(params, obs, None)) > 4 * TOL["logits"]


def test_the_c51_projection():
    gen = torch.Generator().manual_seed(6)
    v_min, v_max, z = -110.0, 110.0, 51
    sup = dqn.support_f32(v_min, v_max, z, "cpu")
    probs = torch.softmax(torch.randn(32, z, generator=gen) * 2, -1)
    ret = torch.cat([torch.randn(28, generator=gen) * 60,
                     torch.tensor([150.0, -150.0, 0.0, 4.4])])
    disc = torch.where(torch.rand(32, generator=gen) < 0.3, 0.0, 0.99 ** 3)
    tz = ret[:, None] + disc[:, None] * sup
    got = dqn.project_distribution(probs, tz, v_min, v_max, z)
    want = R.project(probs, tz, v_min, v_max)
    assert torch.allclose(got, want, rtol=0, atol=2e-6)
    assert torch.allclose(got.sum(-1), torch.ones(32), atol=1e-5)


def test_the_nstep_fold_from_obs_ring_rows():
    gen = torch.Generator().manual_seed(8)
    n = 3
    rs = _fill(replay.frame_ring_init(ENVS * SLOTS, (84, 84), ENVS, 4, n,
                                      0.99, stacked=True, device="cpu"), gen,
               done_rate=0.4)
    slot, env, _ = replay.sample_draw(rs, torch.tensor([1, 2],
                                                       dtype=torch.int32), 48)
    got = replay.gather_rows(rs, slot, env)
    at = lambda j: ((slot + j) % SLOTS) * ENVS + env
    flat = lambda buf: buf.reshape(SLOTS * ENVS, -1)
    rewards = torch.stack([flat(rs.reward)[at(j), 0] for j in range(n)], 1)
    dones = torch.stack([flat(rs.done)[at(j), 0] for j in range(n)], 1)
    assert bool(dones.any(1).any()) and not bool(dones.all())
    ret, disc = R.fold_nstep(rewards, dones, 0.99)
    assert torch.equal(got["obs"], R.stacks(flat(rs.frame)[at(0)]))
    assert torch.equal(got["next_obs"], R.stacks(flat(rs.frame)[at(n)]))
    assert torch.allclose(got["reward"], ret, rtol=1e-6, atol=1e-6)
    assert torch.allclose(got["discount"], disc, rtol=1e-6, atol=0)


def test_is_weights_and_new_priorities():
    gen = torch.Generator().manual_seed(9)
    n = 3
    rs = _fill(replay.frame_ring_init(ENVS * SLOTS, (84, 84), ENVS, 4, n,
                                      0.99, stacked=True, device="cpu"), gen)
    slot, env, w = replay.sample_draw(rs, torch.tensor([3, 4],
                                                       dtype=torch.int32),
                                      ROWS, 0.55, prioritized=True)
    # a slot is sampleable once its n successors exist: age >= n
    age = (int(rs.ptr) - 1 - torch.arange(SLOTS)) % SLOTS
    valid = (age >= n)[:, None].expand(SLOTS, ENVS)
    idx = slot * ENVS + env
    assert bool(valid.reshape(-1)[idx].all())
    want = R.is_weights(rs.priority, valid, idx, 0.55)
    assert torch.allclose(w, want, rtol=2e-6, atol=0)
    td = torch.rand(ROWS, generator=gen) * 5
    rs = replay.update_priority_block(rs, slot, env, td, 0.6, 1e-3, 0)
    # a row drawn twice keeps one of its writes, both of the same delta
    last = {int(i): j for j, i in enumerate(idx)}
    rows = torch.tensor(list(last.values()))
    assert torch.allclose(rs.priority.reshape(-1)[idx[rows]],
                          R.new_priorities(td, 0.6, 1e-3)[rows],
                          rtol=2e-6, atol=0)


def test_one_learner_update(learned):
    cfg, learn = learned
    readings, out = learner_checks(learn, cfg)
    assert learn["logits"].shape == (ROWS, 7, 51)
    assert all(v == 0 for v in out.values()), (readings, out)


@pytest.mark.parametrize("control", [dict(dueling_mean=False), dict(shift=1),
                                     dict(act_round=torch.float8_e4m3fn)],
                         ids=["dueling_mean_dropped", "projection_shifted",
                              "float8_activations"])
def test_a_broken_reference_fails_a_tolerance(learned, control):
    cfg, learn = learned
    readings, out = learner_checks(learn, cfg, **control)
    assert max(out.values()) >= 1, (readings, out)


def test_the_trainer_records_its_spans_and_counters():
    cfg = dqn.DQNConfig(
        env=EnvConfig(obs_type="ram", auto_reset=True, reward_step=True,
                      width=6, height=8),
        num_envs=4, buffer_capacity=4 * 16, learn_batch=8, learn_every=2,
        learn_starts=8, prioritized=True, n_step=3, dueling=True,
        distributional=True, noisy=True, frame_ring=True,
        target_update_period=1)
    init_fn, _, chunk, _ = dqn.make_train(cfg, "cpu")
    state = init_fn(3)
    before, steps = profiling.counters(), 12
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        lo = profiling.time.time_ns()
        state, _ = chunk(state, steps)
        hi = profiling.time.time_ns()
    got = profiling.counters() - before
    spans = [s.name for s in profiling.spans_between(lo, hi)]
    updates = int(state.learn_steps)
    assert updates > 0
    assert got["dqn.actor_steps"] == spans.count("dqn.actor") == steps
    assert got["dqn.learner_updates"] == spans.count("dqn.learn") == updates
    assert got["dqn.target_syncs"] == spans.count("dqn.target_sync") \
        == updates
    assert got["replay.rows_sampled"] == updates * cfg.learn_batch
    assert spans.count("replay.sample") == spans.count("replay.priority") \
        == updates
    # four noisy layers a forward: one forward an actor step, three an update
    assert got["model.noise_draws"] == spans.count("model.noise") \
        == 4 * (steps + 3 * updates)


def test_the_reference_imports_nothing_of_the_port():
    path = ROOT / "perfbench" / "reference_torch" / "rainbow.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "hashlib", "math", "typing",
                     "torch"}, names
    code = (f"import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location(\n"
            f"    'ref', {str(path)!r})\n"
            f"spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            f"{{'jax', 'jaxlib', 'flax', 'gym_simpletetris_tpu', "
            f"'gym_simpletetris_tpu_torch', 'perfbench'}}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
