"""Run one cell of the benchmark once, driven by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix. The harness finds:

- the configuration's file (``configs`` entry ``file``): the reference env's
  kwargs under ``env``;
- the traffic mix ``perfbench/traffic/<traffic>.json``: its ``entry`` names
  the module ``perfbench/entries/<entry>.py`` that drives the program,
  the rest are its parameters (batch, steps per call, actions, loop);
- each end-to-end metric ``perfbench/end_to_end/<name>.py`` and each
  per-layer metric ``perfbench/metrics/<name>.py``, a reader of the window
  or of the traced sub-window.

A run: set-up (the entry's module builds it, resets it, makes its inputs from
the seed and warms up), then with ``trace`` a profiled sub-window of the
mix's ``trace_calls`` calls, then the measured window of ``seconds``, calls
back to back until it has passed, then the comparison of everything the
entry produced with the plain reference (``perfbench/reference/``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


class Window(NamedTuple):
    calls: int
    steps_per_call: int
    seconds: float
    latencies: list
    setup_s: float


class Seeds(NamedTuple):
    """What a run draws from ``--seed``: the env's int32 seed, the seed of
    the actions, and the seed that picks the envs compared."""
    env: int
    actions: int
    sample: int


def seeds_of(seed: int) -> Seeds:
    words = np.random.SeedSequence(seed % 2 ** 64).generate_state(4, np.uint32)
    return Seeds(env=int(words[0]) - 2 ** 31,
                 actions=int(words[1]) << 32 | int(words[2]),
                 sample=int(words[3]))


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str, root: Path = ROOT):
    """The reader of a metric: ``kind`` "end_to_end" or "metrics"."""
    return _module(root / "perfbench" / kind / f"{name}.py",
                   f"perfbench_{kind}_{name}")


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "perfbench" / "traffic" / f"{name}.json")
                      .read_text())


def entry(name: str):
    """The module that drives the entry ``name`` of a traffic mix."""
    return importlib.import_module(f"perfbench.entries.{name}")


def cell_parts(bench: dict, workload: str, root: Path = ROOT):
    """(cell, configuration entry, env kwargs, traffic mix) of a cell."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    env = json.loads((root / conf["file"]).read_text())["env"]
    return cell, conf, env, traffic(cell["traffic"], root)


def metrics_of(bench: dict, workload: str, per_layer: bool) -> list:
    """The cell's metrics: the end-to-end ones that list it (or list no
    cells), or the per-layer ones that list it, or that list no cells and
    move an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names
                                 else [])]


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False, overrides=None,
        t_start: float = None, root: Path = ROOT) -> dict:
    """One run of a cell: the result's dict, ``checks`` last. ``overrides``
    replace traffic parameters (the tests' small sizes)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(root)
    _, _, env_kwargs, mix = cell_parts(bench, workload, root)
    mix = {**mix, **(overrides or {})}
    on_card = torch.device(device).type == "cuda"
    drv = entry(mix["entry"]).Entry(env_kwargs, mix, seeds_of(seed), device)
    drv.setup()
    setup_s = time.perf_counter() - t_start

    traced = None
    if trace:
        from . import trace as tr
        n = int(mix["trace_calls"])
        steps = n * drv.steps_per_call // drv.batch

        def traced_calls(host):
            (lo, hi), kernels, copies, ops = tr.record(
                lambda: [drv.call() for _ in range(n)], on_card, host)
            return tr.Trace(kernels, copies, ops, lo, hi, steps, drv.batch,
                            env_kwargs, n)
        # the metrics from a trace of the card alone, whose host cost is
        # small; the idle gaps by host op from a second one with host ops
        traced = traced_calls(host=not on_card)
        attributed = traced_calls(host=True) if on_card else traced

    calls, latencies = 0, []
    t0 = time.perf_counter()
    while True:
        lat = drv.call()
        calls += 1
        if lat is not None:
            latencies.append(lat)
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    window = Window(calls, drv.steps_per_call, t1 - t0, latencies, setup_s)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if on_card else 0}

    metrics = {}
    for m in metrics_of(bench, workload, trace):
        kind = "metrics" if trace else "end_to_end"
        value = reader(kind, m["name"], root).read(traced if trace else window)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": None, "attempted": calls, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        from . import trace as tr
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(traced),
                               "idle_gaps": tr.gaps_by_host_op(attributed)}
        del traced, attributed
    drv.collect()
    t_check = time.perf_counter()
    checks, compared = drv.check(control)
    result["compared"] = dict(compared, seconds=time.perf_counter() - t_check)
    result["correct"] = all(v["value"] <= v["limit"] for v in checks.values())
    result["checks"] = checks
    return result
