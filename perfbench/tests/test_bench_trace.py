"""The benchmark's frozen metric arithmetic: kernel bytes against the board's
shapes, and the trace reduction (busy intervals, idle share, launches per
step, kernel time by name pattern, idle gaps by host op) against a synthetic
trace."""

import pytest

from perfbench import harness, roofline
from perfbench.trace import (Event, Trace, busy_intervals, gaps_by_host_op,
                             idle_gaps, top_device_ops)


def test_step_bytes_follow_the_board():
    assert roofline.num_words(10) == 1
    assert roofline.num_words(24) == 1
    assert roofline.num_words(25) == 2
    assert roofline.step_bytes(20, 1, 1) == 397
    assert roofline.step_bytes(20, 1, 4096) == 397 * 4096
    assert roofline.step_bytes(20, 2, 1) == 12 * 40 + 157
    assert roofline.bound_us(3_350_000) == pytest.approx(1.0)
    # image written and read, rows, two pixel maps, one band's table
    assert roofline.raster_bytes(20, 1, 4096, 84, 1, True) == \
        4096 * 84 * 84 * 2 + 80 * 4096 + 8 * 84 + 8
    assert roofline.raster_bytes(20, 1, 2, 84, 1, False) == \
        2 * 84 * 84 + 160 + 672 + 8


def _trace():
    us = 1000
    kernels = [
        Event("void step_warp_kernel(StepIO, StepCfg, int)", 10 * us, 16 * us),
        Event("void (anonymous namespace)::raster_kernel<4, true, true>(int "
              "const*)", 15 * us, 35 * us),
        Event("void at::native::vectorized_elementwise_kernel<4>(int)",
              50 * us, 52 * us),
        Event("void step_thread_kernel(StepIO, StepCfg)", 60 * us, 70 * us),
        Event("void (anonymous namespace)::raster_kernel<4, false, true>()",
              70 * us, 75 * us),
    ]
    copies = [Event("Memcpy DtoH (Device -> Pinned)", 90 * us, 94 * us)]
    host = [Event("aten::add", 0, 60 * us), Event("aten::empty", 36 * us,
                                                    45 * us),
            Event("aten::copy_", 76 * us, 95 * us)]
    return Trace(kernels, copies, host, 0, 100 * us, 2, 4096,
                 {"width": 10, "height": 20}, 1)


def test_busy_and_idle_share():
    t = _trace()
    us = 1000
    assert busy_intervals(t.kernels, 0, t.end) == [
        (10 * us, 35 * us), (50 * us, 52 * us), (60 * us, 75 * us)]
    # 25 + 2 + 15 us of kernels, 4 of copy, in a window of 100 us
    assert t.busy_s() == pytest.approx(46e-6)
    assert idle_gaps(t.kernels + t.copies, 0, t.end) == [
        (0, 10 * us), (35 * us, 50 * us), (52 * us, 60 * us),
        (75 * us, 90 * us), (94 * us, 100 * us)]
    idle = harness.reader("metrics", "device_idle_pct.rollout").read(t)
    assert idle == pytest.approx(54.0)
    assert busy_intervals(t.kernels, 12 * us, 14 * us) == [(12 * us, 14 * us)]


def test_launches_and_kernel_times():
    t = _trace()
    assert harness.reader("metrics", "launches_per_step.rollout").read(t) == 2.5
    assert harness.reader("metrics", "launches_per_step.call").read(t) == 2.5
    # C: one launch of 20 us over 2 steps
    assert harness.reader("metrics", "raster_acc_us_per_step").read(t) == \
        pytest.approx(10.0)
    # A: launches of 6 and 10 us, mean 8 us; 397 B x 4096 at 3.35 TB/s
    want = 100 * 397 * 4096 / 3.35e12 * 1e6 / 8.0
    assert harness.reader("metrics", "step_kernel_roofline_pct").read(t) == \
        pytest.approx(want)


def test_readers_return_nothing_without_device_events():
    t = _trace()._replace(kernels=[], copies=[])
    for name in ("launches_per_step.rollout", "launches_per_step.call",
                 "raster_acc_us_per_step", "step_kernel_roofline_pct",
                 "device_idle_pct.rollout", "device_idle_pct.call"):
        assert harness.reader("metrics", name).read(t) is None


def test_breakdown():
    t = _trace()
    ops = top_device_ops(t)
    assert ops[0] == ["void (anonymous namespace)::raster_kernel<4, true, "
                      "true>", pytest.approx(20e-6)]
    assert len(ops) == 6
    gaps = dict((k, v) for k, v in gaps_by_host_op(t))
    # gap midpoints: 5 (add), 42.5 (empty, inside add), 56 (add),
    # 82.5 (copy_), 97 (none: python)
    assert gaps == {"aten::add": pytest.approx(18e-6),
                    "aten::empty": pytest.approx(15e-6),
                    "python": pytest.approx(6e-6),
                    "aten::copy_": pytest.approx(15e-6)}
