"""The traced sub-window: torch.profiler around a few of the cell's calls, and
the arithmetic that reduces its events to numbers.

``record`` runs a function under the profiler (on a card its kernels,
copies and sets, and host ops where asked) and keeps the raw events in
memory as plain tuples; nothing is written to disk. ``Trace`` holds them with the window's
bounds and the work done in it, and answers what the per-layer readers in
``perfbench/metrics/`` ask: device busy time (the union of the intervals in
which any kernel, copy or set ran), the idle share, kernels counted and
timed by name pattern, the device ops that took most time, and the idle
gaps by what the host was doing.
"""

from __future__ import annotations

import re
import time
import warnings
from collections import Counter
from typing import NamedTuple

WINDOW = "perfbench.window"


class Event(NamedTuple):
    name: str
    start: int      # ns, the profiler's clock
    end: int


class Trace(NamedTuple):
    kernels: list       # device kernels
    copies: list        # device copies and sets
    host: list          # host ops (no CUDA runtime calls), by start
    start: int          # the window, ns
    end: int
    steps: int          # batched steps of the entry in the window
    batch: int
    config: dict        # the cell's configuration (the reference kwargs)
    calls: int

    # -- what the readers use -----------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_s(self) -> float:
        return sum(e - s for s, e in busy_intervals(
            self.kernels + self.copies, self.start, self.end)) / 1e9

    def matching(self, pattern: str) -> list:
        rx = re.compile(pattern)
        return [k for k in self.kernels if rx.search(k.name)]


def busy_intervals(events, lo: int, hi: int) -> list:
    """The union of the events' intervals, clipped to [lo, hi], as sorted
    disjoint (start, end) pairs."""
    spans = sorted((max(e.start, lo), min(e.end, hi)) for e in events
                   if e.end > lo and e.start < hi)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(p) for p in out]


def idle_gaps(events, lo: int, hi: int) -> list:
    """The (start, end) stretches of [lo, hi] in which no event ran."""
    gaps, at = [], lo
    for s, e in busy_intervals(events, lo, hi):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def top_device_ops(trace: Trace, n: int = 10) -> list:
    """[[name, seconds], ...]: the device ops with the most time in the
    window, summed by name, the longest first."""
    tot = Counter()
    for ev in trace.kernels + trace.copies:
        tot[_short(ev.name)] += ev.end - ev.start
    return [[k, v / 1e9] for k, v in tot.most_common(n)]


def gaps_by_host_op(trace: Trace, n: int = 10) -> list:
    """[[host op, seconds], ...]: the device's idle time in the window,
    summed by the innermost host op that was running at the middle of each
    gap ("python" where none was: the interpreter between ops), the most
    first."""
    gaps = idle_gaps(trace.kernels + trace.copies, trace.start, trace.end)
    host = sorted(trace.host, key=lambda e: (e.start, -e.end))
    tot = Counter()
    stack, i = [], 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(host) and host[i].start <= mid:
            while stack and stack[-1].end < host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        tot[stack[-1].name if stack else "python"] += e - s
    return [[k, v / 1e9] for k, v in tot.most_common(n)]


def _short(name: str) -> str:
    """A kernel's name without its closing argument list, at most 120
    letters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:120]


def record(fn, device: bool, host: bool):
    """Run ``fn()`` under torch.profiler: the card's kernels, copies and
    sets where ``device``, the host's ops where ``host``. Returns (the
    window's (start, end) in the profiler's clock, kernels, copies, host
    ops); ``fn`` has to synchronise with the card before it returns.
    With host ops, the window is the span of a ``perfbench.window``
    annotation around ``fn``. Without them the profiler records no
    annotation, and the window is read on the host's real-time clock, the
    one the profiler's timestamps count in (Unix nanoseconds), widened
    where a device op would fall outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] if host else []
    if device:
        acts.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                t0 = time.time_ns()
                fn()
                t1 = time.time_ns()
    kernels, copies, ops = [], [], []
    window = None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        e = Event(name, ev.start_ns(), ev.start_ns() + ev.duration_ns())
        on_card = ev.device_type() == DeviceType.CUDA
        if name == WINDOW:
            if not on_card:
                window = (e.start, e.end)
        elif on_card:
            (copies if name.startswith(("Memcpy", "Memset")) else
             kernels).append(e)
        elif not name.startswith(("cuda", "cu")):
            ops.append(e)
    if window is None:
        dev = kernels + copies
        window = (min([t0] + [e.start for e in dev]),
                  max([t1] + [e.end for e in dev]))
    return window, kernels, copies, ops
