"""Tracing / profiling hooks (port of ``gym_simpletetris_tpu.utils.profiling``).

- ``trace(dir)``: context manager around ``torch.profiler`` (host ops, and
  the card's kernels where there is a card); writes a Chrome trace
  (Perfetto / ``chrome://tracing``) into ``dir`` on exit.
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
import os
import time
from typing import Any

import torch
from torch.overrides import TorchFunctionMode


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``trace_<pid>_<ns>.json`` (a Chrome
    trace) into ``log_dir``. Yields the ``torch.profiler.profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
