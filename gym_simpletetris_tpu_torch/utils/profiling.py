"""Tracing / profiling hooks (port of ``gym_simpletetris_tpu.utils.profiling``).

- ``span(name)``: a span around a block (``with span(name):``) or a function
  (``@span(name)``). Spans are recorded only while a torch profiler runs
  (``torch.profiler.profile``, or ``trace`` below: the flag
  ``torch.autograd.profiler._is_profiler_enabled``, which a profiler sets
  whatever its activities); outside one a span site costs a flag test and
  a call. A span's record is its name, start and end
  by ``time.time_ns()`` (the real-time clock the profiler's events count
  in, Unix nanoseconds), the index of the span that encloses it and that of
  the outermost one (shared by every span of one user call). Spans nest by
  the order they open and close: record them from one thread. At most
  ``MAX_SPANS`` are kept; the rest count as ``profiling.spans_dropped``.
  Spans add no event to the profiler's own record, so a trace of the card
  holds exactly what it held without them.
- ``count(name, n=1)``: a counter, always on. The port's counters:
  ``kernel.step.launches``, ``kernel.raster.launches``,
  ``kernel.raster_acc.launches``, ``kernel.draw.launches``,
  ``kernel.noise.launches`` (its CUDA kernels' launches; on the card
  ``kernel.draw.launches`` equals ``engine.draws`` and
  ``kernel.noise.launches`` equals ``model.noise_draws``, one launch a
  noisy layer's draw), ``engine.draws`` (spawn draws) and
  ``env.to_host.calls`` / ``env.to_host.bytes`` (copies to the host and
  the bytes of the tensors they took, from their shapes); the DQN trainer's ``dqn.actor_steps``,
  ``dqn.learner_updates``, ``dqn.target_syncs``, ``replay.rows_sampled``
  (learner rows drawn) and ``model.noise_draws`` (noisy layers' weight
  draws), beside its spans ``dqn.actor``, ``dqn.learn``,
  ``dqn.target_sync``, ``replay.sample`` (a learner batch's draw and
  gather), ``replay.priority`` (the priority write-back) and
  ``model.noise``; the ES trainer's ``es.generations``,
  ``es.member_forwards`` (members' networks evaluated) and
  ``es.noise_elements`` (normals drawn), beside its spans ``es.perturb``,
  ``es.rollout``, ``es.forward`` and ``es.update``.
- ``spans_between(lo_ns, hi_ns)``, ``counters()`` and ``reset()`` read and
  clear both.
- ``trace(dir)``: context manager around ``torch.profiler`` (host ops, and
  the card's kernels where there is a card); writes a Chrome trace
  (Perfetto / ``chrome://tracing``) into ``dir`` on exit, with the spans
  recorded meanwhile on a track of their own.
- ``cost_analysis(fn, *args)``: the floating-point operations of ``fn`` on
  these arguments, from ``torch.utils.flop_counter.FlopCounterMode``. It
  runs ``fn`` once (XLA's cost analysis only compiles it), and it counts
  only the ops that have a flop formula (matmuls, convolutions, attention):
  elementwise work counts 0. XLA's ``bytes accessed`` has no torch
  counterpart and is not reported.
- ``debug_mode()``: raises ``FloatingPointError`` where an op's floating
  output holds a NaN (``jax_debug_nans``), and turns on autograd's anomaly
  detection so a NaN made by a backward op raises there. JAX's
  ``jax_check_tracer_leaks`` has no counterpart: torch has no tracers to
  leak.
- ``block(x)``: waits for the card where ``x`` holds a tensor on it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from array import array
from collections import Counter
from typing import Any, NamedTuple

import torch
from torch.autograd import profiler as _profiler
from torch.overrides import TorchFunctionMode

MAX_SPANS = 1 << 20


class Span(NamedTuple):
    index: int       # its place in the record, which ``parent`` and ``top`` name
    name: str
    start: int       # ns, time.time_ns()
    end: int
    parent: int      # the enclosing span's index, -1 for an outermost one
    top: int         # the outermost enclosing span's index (its own if outermost)


# The record: one entry a span in each array, by index; an open span's end
# is 0. ``_open`` holds the indices of the open spans, innermost last (-1
# for one that was not kept).
_names: list = []
_starts, _ends, _parents, _tops = (array("q") for _ in range(4))
_open: list = []
_counts: dict = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Counter:
    """A copy of every counter, by name (a name never counted reads 0)."""
    return Counter(_counts)


def _enter(name: str) -> None:
    i = len(_names)
    if i >= MAX_SPANS:
        count("profiling.spans_dropped")
        _open.append(-1)
        return
    parent = _open[-1] if _open else -1
    _names.append(name)
    _parents.append(parent)
    _tops.append(_tops[parent] if parent >= 0 else i)
    _ends.append(0)
    _open.append(i)
    _starts.append(time.time_ns())


def _exit() -> None:
    t = time.time_ns()
    i = _open.pop()
    if i >= 0:
        _ends[i] = t


class span:
    """A span named ``name`` around a block, ``with span(name):``, or
    around every call of a function, ``@span(name)``; recorded only while
    a torch profiler runs."""

    __slots__ = ("name", "_on")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._on = _profiler._is_profiler_enabled
        if self._on:
            _enter(self.name)

    def __exit__(self, *exc):
        if self._on:
            _exit()

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            _enter(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _exit()
        return spanned


def spans_between(lo_ns: int, hi_ns: int) -> list:
    """The closed spans that overlap [lo_ns, hi_ns], clipped to it, as
    ``Span`` records in the order they opened."""
    return [Span(i, _names[i], max(s, lo_ns), min(e, hi_ns), _parents[i],
                 _tops[i])
            for i, (s, e) in enumerate(zip(_starts, _ends))
            if e and s < hi_ns and e > lo_ns]


def reset() -> None:
    """Forget every span and counter. Spans open now are not recorded."""
    del _names[:]
    for a in (_starts, _ends, _parents, _tops):
        del a[:]
    _open[:] = [-1] * len(_open)
    _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``trace_<pid>_<ns>.json`` (a Chrome
    trace) into ``log_dir``, the spans recorded meanwhile on the track
    ``spans`` of this process, on the profiler's clock. Yields the
    ``torch.profiler.profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    lo = time.time_ns()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _add_spans(path, spans_between(lo, time.time_ns()))


def _add_spans(path: str, spans: list) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete events
    of thread 0 of this process (a thread no op runs on), named ``spans``.
    The trace's timestamps are microseconds from its
    ``baseTimeNanoseconds``."""
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    events = doc["traceEvents"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "spans"}})
    events.extend({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                   "tid": 0, "ts": (s.start - base) / 1e3,
                   "dur": (s.end - s.start) / 1e3,
                   "args": {"index": s.index, "parent": s.parent}}
                  for s in spans)
    with open(path, "w") as f:
        json.dump(doc, f)


def cost_analysis(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under ``FlopCounterMode`` and return
    ``{"flops": total}``."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


class _NanCheck(TorchFunctionMode):
    """Raise where a torch function returns a floating tensor holding a NaN
    (the mode is off inside its own handler, so the check is not checked)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def debug_mode():
    """NaN checking on every torch function's output, and autograd's anomaly
    detection for the backward, scoped. Each check syncs with the card."""
    with torch.autograd.set_detect_anomaly(True), _NanCheck():
        yield


def block(tree: Any) -> Any:
    """Barrier helper for benchmarking walls: ``torch.cuda.synchronize()``
    where ``tree`` (a tensor, or a tuple / list / dict of them) holds a
    tensor on the card. Returns ``tree``."""
    leaves = list(tree.values()) if isinstance(tree, dict) else tree
    if any(t.is_cuda for t in _tensors(leaves)):
        torch.cuda.synchronize()
    return tree
