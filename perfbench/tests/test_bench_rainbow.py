"""The Rainbow trainer cell (``rainbow_flagship.train_b256``): its entry on
the CPU at a small batch (correct, and not with the control), the model
FLOP count against a hand count and against torch's FLOP counter on the
port's own actor step and learner update, and the three span readers on a
synthetic trace (their arithmetic, and nothing without spans).

    python -m pytest perfbench/tests/test_bench_rainbow.py -q
"""

import pytest
import torch

from gym_simpletetris_tpu_torch.core.config import EnvConfig
from gym_simpletetris_tpu_torch.train import dqn
from gym_simpletetris_tpu_torch.utils import profiling

from perfbench import harness, model_flops
from perfbench.trace import Event, Trace

CELL = "rainbow_flagship.train_b256"
AGENT = harness.cell_parts(harness.load_benchmark(), CELL)[2]["agent"]
SMALL = dict(batch=8, steps_per_call=8, compare_envs=4, trace_calls=1)
READERS = ("train_mfu_pct", "learner_mfu_pct", "idle_in_learner_pct")
US = 1000


def test_the_entry_is_correct_on_the_cpu_and_its_control_is_not():
    r = harness.run(CELL, 2 ** 31 + 4321, 0.2, False, device="cpu",
                    overrides=SMALL)
    assert r["correct"] is True, r["checks"]
    assert r["compared"]["learner_rows"] == 16
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"}
    c = harness.run(CELL, 2 ** 31 + 4322, 0.2, False, device="cpu",
                    control=True, overrides=SMALL)
    assert c["correct"] is False
    bad = {k for k, v in c["checks"].items() if v["value"] > v["limit"]}
    # the env is the program's, so only the learner's checks can fail
    assert bad and all(k.endswith("_out_of_tol") for k in bad), c["checks"]


def test_model_flops_match_a_hand_count():
    macs = dict(model_flops.layer_macs(AGENT))
    assert macs == {"conv1": 20 * 20 * 32 * 8 * 8 * 4,
                    "conv2": 9 * 9 * 64 * 4 * 4 * 32,
                    "conv3": 7 * 7 * 64 * 3 * 3 * 64,
                    "dense": 3136 * 512, "value": 512 * 51,
                    "advantage": 512 * 7 * 51}
    assert model_flops.forward_macs(AGENT) == 9_551_872
    assert model_flops.actor_step_flops(AGENT) == 2 * 256 * 9_551_872
    assert model_flops.learner_update_flops(AGENT) == \
        2 * 512 * (5 * 9_551_872 - 3_276_800)
    small = model_flops.at_batch(AGENT, 8)
    assert (small["buffer_capacity"], small["learn_batch"],
            small["learn_starts"]) == (2048, 16, 128)


def test_model_flops_are_what_the_port_computes():
    """torch's FLOP counter over the port's own actor step and learner
    update (convolutions and matrix products) at 8 envs."""
    from torch.utils.flop_counter import FlopCounterMode
    agent = model_flops.at_batch(AGENT, 8)
    fields = {f for f in dqn.DQNConfig.__dataclass_fields__}
    cfg = dqn.DQNConfig(env=EnvConfig(obs_type="grayscale", reward_step=True,
                                      penalise_height=True, auto_reset=True),
                        **{k: v for k, v in agent.items() if k in fields})
    init_fn, _, chunk, _ = dqn.make_train(cfg, "cpu")
    state = init_fn(11)
    for _ in range(16):
        state, (k_sample, k_nlearn, _) = chunk.actor_half(state)
    count = FlopCounterMode(display=False)
    with count:
        state, (k_sample, k_nlearn, _) = chunk.actor_half(state)
    assert count.get_total_flops() == model_flops.actor_step_flops(agent)
    count = FlopCounterMode(display=False)
    with count:
        chunk.learner_half(state, k_sample, k_nlearn)
    assert count.get_total_flops() == model_flops.learner_update_flops(agent)


@pytest.fixture
def spans(monkeypatch):
    """A profiler's flag set, the recorder's clock in µs: one actor step
    [100, 200] and one learner update [200, 600] holding a priority
    write-back [500, 550]."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    now = [0]
    monkeypatch.setattr(profiling.time, "time_ns", lambda: now[0])
    profiling.reset()
    stack = []
    for t, *name in ((100, "dqn.actor"), (200,), (200, "dqn.learn"),
                     (500, "replay.priority"), (550,), (600,)):
        now[0] = t * US
        if name:
            stack.append(profiling.span(name[0]))
            stack[-1].__enter__()
        else:
            stack.pop().__exit__(None, None, None)
    yield
    profiling.reset()


def _trace(kernels=((150, 250), (500, 700))):
    return Trace([Event("k", s * US, e * US) for s, e in kernels], [], [], 0,
                 1000 * US, 16, 256, {"agent": AGENT}, 1)


def _read(name, trace):
    return harness.reader("metrics", name).read(trace)


def test_the_readers_arithmetic(spans):
    t = _trace()
    actor, learn = 4_890_558_464, 45_550_141_440
    assert _read("train_mfu_pct", t) == pytest.approx(
        100 * (actor + learn) / (1e-3 * 989.4e12))
    # busy inside the update: [200, 250] and [500, 600]
    assert _read("learner_mfu_pct", t) == pytest.approx(
        100 * learn / (150e-6 * 989.4e12))
    # idle inside the update: [250, 500], of 1000 µs
    assert _read("idle_in_learner_pct", t) == pytest.approx(25.0)


def test_the_readers_return_nothing_without_spans(spans, monkeypatch):
    outside = _trace()._replace(start=700 * US)
    for name in READERS:
        assert _read(name, outside) is None
        assert _read(name, _trace(kernels=())) is None
    monkeypatch.delattr(profiling, "spans_between")
    for name in READERS:
        assert _read(name, _trace()) is None
