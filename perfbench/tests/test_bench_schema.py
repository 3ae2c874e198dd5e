"""BENCHMARK.json against the benchmark's contract, and the harness's
promise that a configuration, a traffic mix or a metric is added by adding
files and entries only."""

import json
import re
import shutil

import pytest

from perfbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_.%/-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_names_and_units():
    configs, cells = BENCH["configs"], BENCH["workloads"]
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert LINE.match(w["why"])
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e[[m["name"] for m in e2e].index("setup_s")]["bound"] <= 0.25
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(m["layer"])
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in (configs, cells, e2e + layers):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert {w["config"] for w in cells} == {c["name"] for c in configs}


def test_every_file_is_found_by_name():
    for w in BENCH["workloads"]:
        cell, conf, env, mix = harness.cell_parts(BENCH, w["name"])
        assert (harness.ROOT / conf["file"]).is_file()
        assert harness.entry(mix["entry"]).Entry
        assert isinstance(env, dict)
    for kind, group in (("end_to_end", "end_to_end"), ("metrics", "per_layer")):
        for m in BENCH[group]:
            mod = harness.reader(kind, m["name"])
            assert mod.UNIT == m["unit"]
            if kind == "metrics":
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_each_cell_reports_what_it_must():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = BENCH["per_layer"]
    for w in BENCH["workloads"]:
        own = {m["name"] for m in harness.metrics_of(BENCH, w["name"], False)}
        assert "setup_s" in own and len(own) >= 2
        assert harness.metrics_of(BENCH, w["name"], True)
    for m in layers:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            own = {x["name"] for x in harness.metrics_of(BENCH, w, False)}
            assert m["moves"] in own, (m["name"], w)
    by_layer = {}
    for m in layers:
        by_layer.setdefault(m["layer"], set()).add(m["name"])
    assert len(by_layer) == 4


def test_a_cell_added_as_files_only_is_picked_up(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as files
    and BENCHMARK.json entries, run through the unchanged harness."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    (root / "perfbench/configs/wide_test.json").write_text(json.dumps(
        {"env": {"width": 6, "height": 8, "lock_delay": 1}}))
    (root / "perfbench/traffic/rollout_small.json").write_text(json.dumps(
        {"entry": "rollout", "batch": 6, "steps_per_call": 8,
         "action_blocks": 2, "auto_reset": True, "acc_mode": "storage",
         "compare_envs": 6, "trace_calls": 1}))
    (root / "perfbench/metrics/calls_traced.py").write_text(
        'LAYER = "device"\nUNIT = "calls"\nMOVES = "env_steps_per_s"\n\n\n'
        "def read(trace):\n    return trace.calls\n")
    bench["configs"].append({"name": "wide_test", "source": "https://x.org",
                             "file": "perfbench/configs/wide_test.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "wide_test.rollout_small",
                               "config": "wide_test",
                               "traffic": "rollout_small", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "env_steps_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run("wide_test.rollout_small", 5, 0.2, False, device="cpu",
                    root=root)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
    r = harness.run("wide_test.rollout_small", 6, 0.2, True, device="cpu",
                    root=root)
    assert r["correct"] is True
    assert r["metrics"] == {"calls_traced": {"value": 1.0, "unit": "calls"}}
    # the metric without a cell list reaches every cell that reports its
    # end-to-end metric, and only those
    assert "calls_traced" in {m["name"] for m in harness.metrics_of(
        bench, "v0_ram.rollout_b4096", True)}
    with pytest.raises(KeyError):
        harness.cell_parts(bench, "no.such_cell", root)
