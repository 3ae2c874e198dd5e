"""What decides ``correct``, shown to fail: at sizes a CPU test run can hold,
every cell of BENCHMARK.json comes out correct on the port's CPU path, and
not correct with the control in the program's place (the reference with its
count-balanced sampler broken), and not correct with the timed path broken
underneath by each fault an env cell can have: a step that returns its state
unchanged, half the batch left out, an answer altered where it is produced.
(The fourth fault of the contract, the exchange between chips left out, has
no place in these one-chip cells.) On the card the same control runs at each
cell's own size: ``python3 perfbench/run.py ... --control 1``.
"""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from gym_simpletetris_tpu_torch.core import engine as E

from perfbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SMALL = dict(batch=8, steps_per_call=16, compare_envs=4, warmup_calls=2,
             trace_calls=2)
BIG_SEED = 2 ** 31 + 1234


def _run(cell, seed, control=False, root=harness.ROOT):
    return harness.run(cell, seed, 0.3, False, device="cpu", control=control,
                       overrides=SMALL, root=root)


def test_the_vector_cell_left_for_later_is_decided_the_same_way(
        tmp_path, monkeypatch):
    """``flagship_gray.vector_b256`` (its traffic file and entry module are kept,
    its BENCHMARK.json entry left out: PERF.md §7), added back as an entry
    only: sound, control and a broken step."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = harness.load_benchmark()
    cell = "flagship_gray.vector_b256"
    bench["workloads"].append({"name": cell, "config": "flagship_gray",
                               "traffic": "vector_b256", "chips": 1,
                               "why": "the gymnasium vector core"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert _run(cell, BIG_SEED, root=root)["correct"] is True
    assert _run(cell, 4, control=True, root=root)["correct"] is False
    monkeypatch.setattr(E, "engine_step", _half(E.engine_step))
    assert _run(cell, BIG_SEED, root=root)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct_and_the_control_is_not(cell):
    r = _run(cell, BIG_SEED)
    assert r["correct"] is True, r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    for seed in (1, 2, 3):
        c = _run(cell, seed, control=True)
        assert c["correct"] is False
        assert max(v["value"] for v in c["checks"].values()) >= 1


def _unchanged(real):
    def step(cfg, state, action, injected_r=None):
        out = real(cfg, state, action, injected_r)
        return out._replace(state=state)
    return step


def _half(real):
    def step(cfg, state, action, injected_r=None):
        out = real(cfg, state, action, injected_r)
        b = state.batch_size
        keep = torch.arange(b, device=state.device) >= b // 2
        pick = lambda new, old: torch.where(keep, old, new)
        st = out.state.replace(**{f: pick(getattr(out.state, f),
                                          getattr(state, f)) for f in (
            "rows", "piece", "rot", "ax", "ay", "lock", "time", "score",
            "holes", "lines_cleared", "piece_height", "deaths",
            "shape_counts")})
        return out._replace(state=st, reward=torch.where(keep, 0.0,
                                                         out.reward),
                            done=out.done & ~keep)
    return step


def _altered(real):
    calls = []

    def step(cfg, state, action, injected_r=None):
        out = real(cfg, state, action, injected_r)
        calls.append(1)
        if len(calls) == 3:
            r = out.reward.clone()
            r += 1.0
            return out._replace(reward=r)
        return out
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(E, "engine_step", fault(E.engine_step))
    r = _run(cell, BIG_SEED)
    assert r["correct"] is False, r
    assert max(v["value"] for v in r["checks"].values()) >= 1


def test_without_a_card_the_command_prints_nothing_and_fails():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", str(BIG_SEED), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2
    assert out.stdout == ""
