"""The port's spans and counters (``utils/profiling.py``) on the CPU: spans
only under a torch profiler, nested as the layers call each other and on the
profiler's clock; counters always; the bounded record; the spans in
``trace``'s Chrome trace."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.api import env as api_env
from gym_simpletetris_tpu_torch.api.gym_compat import TetrisEnv
from gym_simpletetris_tpu_torch.api.gymnasium_vector import _TorchVectorCore
from gym_simpletetris_tpu_torch.utils import profiling
import port_harness  # noqa: F401 (torch on one CPU thread)

EVER = (0, 2 ** 63 - 1)
DRAW_PARENTS = {"rollout.step", "env.step", "engine.clear", "vector.step"}


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _rollout(obs_type="ram", B=4, T=3):
    env = TetrisVectorEnv(EnvConfig(obs_type=obs_type, auto_reset=True), B,
                          device="cpu")
    _, state = env.reset(5)
    actions = torch.from_numpy(np.random.RandomState(0).randint(0, 7, (T, B)))
    return env.rollout(state, actions)


def _shim():
    env = TetrisEnv(seed=3, device="cpu")
    env.reset()
    for a in (2, 2, 0):
        env.step(a)
    env.reset()


def _step_fn():
    env = TetrisVectorEnv(EnvConfig(auto_reset=True), 3, device="cpu")
    _, s = env.reset(1)
    env.step(s, [2, 2, 2])


def _vector():
    core = _TorchVectorCore(3, 7, device="cpu")
    core.reset()
    core.step(np.array([2, 1, 0]))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return profiling.spans_between(*EVER), prof


def test_outside_a_profiler_no_span_is_recorded_and_counters_count():
    _rollout(T=3)
    _shim()
    assert profiling.spans_between(*EVER) == []
    c = profiling.counters()
    # the rollout: its reset, then a step's draw and a reset's draw a step;
    # the shim: two resets and three steps
    assert c["engine.draws"] == 1 + 2 * 3 + 2 + 3
    assert c["env.to_host.calls"] == 5
    assert c["kernel.step.launches"] == 0       # the CPU launches nothing


@pytest.mark.parametrize("drive", [_rollout, _shim, _step_fn, _vector])
def test_spans_under_a_profiler_nest_as_the_layers_call(drive):
    spans, _ = _profiled(drive)
    assert spans
    by = {s.index: s for s in spans}
    for s in spans:
        if s.parent < 0:
            assert s.top == s.index
            continue
        p = by[s.parent]
        assert p.start <= s.start <= s.end <= p.end
        assert s.top == p.top
    draws = [s for s in spans if s.name == "engine.draw"]
    assert draws
    assert {by[s.parent].name for s in draws} <= DRAW_PARENTS


def test_a_rollout_call_is_one_tree_of_spans():
    T = 3
    spans, _ = _profiled(lambda: _rollout("grayscale", T=T))
    names = [s.name for s in spans]
    call, = [s for s in spans if s.name == "rollout.call"]
    inside = [s for s in spans if s.top == call.index]
    assert {n: names.count(n) for n in set(names)} == {
        "engine.clear": T + 1, "engine.draw": 2 * T + 1, "rollout.call": 1,
        "rollout.step": T, "kernel.step": T, "env.reset_mask": T,
        "kernel.raster_acc": T, "kernel.raster": 1}
    # all but the reset's clear, its draw and its observation
    assert len(inside) == len(spans) - 3
    by = {s.index: s for s in spans}
    assert all(by[s.parent].name == "rollout.call"
               for s in spans if s.name == "rollout.step")


def test_spans_are_on_the_profiler_clock():
    """A span encloses the profiler's events of the ops run inside it, and
    no op of the port straddles a draw's start or end."""
    @profiling.span("test.hypot")
    def hypot(a):
        return torch.hypot(a, a)

    def run():
        a = torch.rand(64)
        for _ in range(20):
            a = torch.add(hypot(a), 1)
        _rollout(T=2)

    spans, prof = _profiled(run)
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    mine = [(s.start, s.end) for s in spans if s.name == "test.hypot"]
    hypots = [(s, e) for n, s, e in ops if n == "aten::hypot"]
    adds = [(s, e) for n, s, e in ops if n == "aten::add"]
    assert len(mine) == 20 and len(hypots) >= 20
    assert all(any(lo <= s and e <= hi for lo, hi in mine) for s, e in hypots)
    assert not any(lo <= s <= hi for lo, hi in mine for s, _ in adds)
    draws = [(s.start, s.end) for s in spans if s.name == "engine.draw"]
    assert len(draws) == 1 + 2 * 2
    assert not any(s < lo < e or s < hi < e
                   for lo, hi in draws for _, s, e in ops)


def test_trace_writes_the_spans_beside_the_ops(tmp_path):
    @profiling.span("test.hypot")
    def hypot(a):
        return torch.hypot(a, a)

    with profiling.trace(str(tmp_path)):
        a = torch.rand(64)
        for _ in range(5):
            a = torch.add(hypot(a), 1)
    name, = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    mine = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in mine] == ["test.hypot"] * 5
    assert {(e["pid"], e["tid"]) for e in mine} == {(os.getpid(), 0)}
    assert any(e.get("ph") == "M" and e["tid"] == 0 and
               e["args"] == {"name": "spans"} for e in events)
    hypots = [e for e in events if e.get("name") == "aten::hypot"]
    adds = [e for e in events if e.get("name") == "aten::add"]
    assert len(hypots) >= 5 and len(adds) >= 5
    ulp = 1e-3                       # the trace's µs carry three decimals
    for x in hypots:
        assert any(m["ts"] - ulp <= x["ts"] and
                   x["ts"] + x["dur"] <= m["ts"] + m["dur"] + ulp
                   for m in mine)
    assert not any(m["ts"] <= x["ts"] <= m["ts"] + m["dur"]
                   for m in mine for x in adds)


def test_the_record_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    outer, inner = profiling.span("outer"), profiling.span("inner")
    with profile(activities=[ProfilerActivity.CPU]):
        with outer:
            for _ in range(4):
                with profiling.span("inner"):
                    pass
        with inner:
            pass
    spans = profiling.spans_between(*EVER)
    assert [s.name for s in spans] == ["outer", "inner", "inner"]
    assert [s.parent for s in spans] == [-1, 0, 0]
    assert profiling.counters()["profiling.spans_dropped"] == 3
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with outer:
            profiling.reset()             # forgets the open span
            with inner:
                pass
    spans = profiling.spans_between(*EVER)
    assert [(s.name, s.parent, s.top) for s in spans] == [("inner", -1, 0)]
    assert profiling.counters() == {}


def test_spans_between_clips_to_the_interval():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            pass
    s, = profiling.spans_between(*EVER)
    mid = (s.start + s.end) // 2
    assert profiling.spans_between(mid, EVER[1])[0][2:4] == (mid, s.end)
    assert profiling.spans_between(0, mid)[0][2:4] == (s.start, mid)
    assert profiling.spans_between(s.end, EVER[1]) == []


def test_to_host_counts_the_bytes_of_the_tensors_given():
    ts = (torch.zeros(3, 4, dtype=torch.int32), torch.ones(5, dtype=torch.bool),
          torch.zeros(2, 3, dtype=torch.uint8), torch.zeros(7),
          torch.zeros(2, dtype=torch.int16))
    out = api_env.to_host(*ts)
    assert [o.shape for o in out] == [tuple(t.shape) for t in ts]
    c = profiling.counters()
    assert c["env.to_host.calls"] == 1
    assert c["env.to_host.bytes"] == 48 + 5 + 6 + 28 + 4
