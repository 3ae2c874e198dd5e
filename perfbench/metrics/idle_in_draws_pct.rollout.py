"""The share of the traced rollout window in which the card ran no kernel,
copy or set while the host was inside a threefry spawn draw: the exact
overlap of the device's idle gaps with the port's ``engine.draw`` spans
(``core/engine.py`` ``spawn_draw``, recorded by ``utils/profiling.py`` on
the profiler's clock), over the window. The part of ``device_idle_pct``
that the draws' host time leaves."""

from perfbench import trace as tr

LAYER = "device"
UNIT = "%"
MOVES = "env_steps_per_s"
DRAW = "engine.draw"


def overlap_ns(a, b) -> int:
    """The length of the intersection of two sorted lists of disjoint
    (start, end) intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(trace):
    try:
        from gym_simpletetris_tpu_torch.utils.profiling import spans_between
    except ImportError:
        return None
    spans = spans_between(trace.start, trace.end)
    if not spans:
        return None
    draws = tr.busy_intervals([s for s in spans if s.name == DRAW],
                              trace.start, trace.end)
    gaps = tr.idle_gaps(trace.kernels + trace.copies, trace.start, trace.end)
    return 100.0 * overlap_ns(gaps, draws) / (trace.end - trace.start)
