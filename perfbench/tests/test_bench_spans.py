"""The readers of the port's spans (``draw_host_us_per_step.*``,
``idle_in_draws_pct.*``): their arithmetic on a synthetic trace and spans
recorded on a set clock (self time, overlap with the idle gaps, clipping to
the window, nothing where the port records no span, 0 where it records no
draw), and a traced CPU run of a rollout cell and of the gym cell through
the unchanged harness."""

import pytest
import torch

from gym_simpletetris_tpu_torch.utils import profiling

from perfbench import harness
from perfbench.trace import Event, Trace

SPAN_READERS = ("draw_host_us_per_step.rollout", "draw_host_us_per_step.call",
                "idle_in_draws_pct.rollout", "idle_in_draws_pct.call")
US = 1000


def _read(name, trace):
    return harness.reader("metrics", name).read(trace)


@pytest.fixture
def clock(monkeypatch):
    """Spans on: a profiler's flag set, and the recorder's clock at ``t``
    (µs) for each open and close of ``record``."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    now = [0]
    monkeypatch.setattr(profiling.time, "time_ns", lambda: now[0])
    profiling.reset()

    def record(*events):
        """Events (t, name) open a span, (t,) closes the innermost."""
        stack = []
        for t, *name in events:
            now[0] = t * US
            if name:
                stack.append(profiling.span(name[0]))
                stack[-1].__enter__()
            else:
                stack.pop().__exit__(None, None, None)
    yield record
    profiling.reset()


def _trace(lo=0, hi=1000, calls=1, steps=2):
    kernels = [Event("k", 0, 115 * US), Event("k", 140 * US, 170 * US)]
    return Trace(kernels, [], [], lo * US, hi * US, steps, 4096, {}, calls)


def _two_steps(record):
    # a step [100, 200] with a draw [110, 150] holding a child [120, 130],
    # and a second draw [160, 180]
    record((100, "rollout.step"), (110, "engine.draw"), (120, "x"), (130,),
           (150,), (160, "engine.draw"), (180,), (200,))


def test_draw_self_time_and_its_idle_share(clock):
    _two_steps(clock)
    t = _trace()
    # self time 40 - 10 + 20 us over 2 steps; over 4 calls
    assert _read("draw_host_us_per_step.rollout", t) == pytest.approx(25.0)
    assert _read("draw_host_us_per_step.call", t._replace(calls=4)) == \
        pytest.approx(12.5)
    # idle [115, 140] and [170, 1000]: 25 + 10 us of the draws, of 1000
    for name in ("idle_in_draws_pct.rollout", "idle_in_draws_pct.call"):
        assert _read(name, t) == pytest.approx(3.5)


def test_the_window_clips_the_spans(clock):
    _two_steps(clock)
    t = _trace(lo=120, hi=175)
    # draws [120, 150] less the child, and [160, 175]
    assert _read("draw_host_us_per_step.rollout", t) == pytest.approx(17.5)
    # idle [120, 140] and [170, 175] inside the draws, of 55 us
    assert _read("idle_in_draws_pct.rollout", t) == pytest.approx(2500 / 55)


def test_nothing_without_spans_and_zero_without_draws(clock, monkeypatch):
    _two_steps(clock)
    for name in SPAN_READERS:
        assert _read(name, _trace(lo=300, hi=400)) is None
    profiling.reset()
    clock((100, "rollout.step"), (200,))
    for name in SPAN_READERS:
        assert _read(name, _trace()) == 0.0
    # a port that records no spans at all
    monkeypatch.delattr(profiling, "spans_between")
    for name in SPAN_READERS:
        assert _read(name, _trace()) is None


SMALL = dict(batch=8, steps_per_call=16, compare_envs=4, warmup_calls=2,
             trace_calls=2)


@pytest.mark.parametrize("cell,kind", [("v0_ram.rollout_b4096", "rollout"),
                                       ("flagship_gray.rollout_b4096",
                                        "rollout"),
                                       ("v0_ram.gym_b1", "call")])
def test_a_traced_cpu_run_reports_the_span_metrics(cell, kind):
    r = harness.run(cell, 2 ** 31 + 77, 0.2, True, device="cpu",
                    overrides=SMALL)
    assert r["correct"] is True, r["checks"]
    got = r["metrics"]
    draw = got[f"draw_host_us_per_step.{kind}"]
    idle = got[f"idle_in_draws_pct.{kind}"]
    assert draw["unit"] == "us/step" and draw["value"] > 0
    assert idle["unit"] == "%" and 0 < idle["value"] < 100
    names = {s.name for s in profiling.spans_between(0, 2 ** 63 - 1)}
    assert "engine.draw" in names
    shown = {n for n, _ in r["breakdown"]["device_ops"]
             + r["breakdown"]["idle_gaps"]}
    assert not shown & names
