"""``tools/torch_soak_shim.py``, the port's shim-surface soak, on the CPU:
the gym shim, ``TetrisEngine`` and ``NativeTetrisEnv`` in lockstep with
their oracles over random configurations, ram and image observations; its
sampler draws ``tests/test_shim_fuzz.random_env_kwargs``'s configurations;
a fault planted in the plain path fails it, naming the surface, the step
and the field; without a card and without ``--cpu`` it exits 2; it imports
no jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu_torch.core import engine as E
import port_harness  # noqa: F401 (torch on one CPU thread)
from test_shim_fuzz import random_env_kwargs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_soak_shim as soak  # noqa: E402


# seed 2's six configurations: gym grayscale (extend_dims) and rgb, native
# ram twice; the first with penalise_holes_increase
ARGS = ["--configs", "6", "--steps", "40", "--seed", "2"]


@pytest.fixture(scope="module")
def cpu_run():
    out = []
    res = soak.soak(soak.parse_args(["--cpu", "--render-every", "10"] + ARGS),
                    out=lambda s, **_: out.append(s))
    return res, out


def test_soak_passes_on_the_cpu_over_every_surface(cpu_run):
    res, out = cpu_run
    assert len(out) == 6 and all(" OK (" in ln for ln in out)
    per = res["surfaces"]
    assert {s: v["configs"] for s, v in per.items()} == {
        "gym": 2, "engine": 2, "native": 2}
    # image configurations of the gym and native surfaces run 60 steps
    assert {s: v["steps"] for s, v in per.items()} == {
        "gym": 120, "engine": 80, "native": 80}
    assert res["steps"] == 280
    obs = {ln.split()[5] for ln in out if ln.split()[1] != "engine"}
    assert obs == {"ram", "grayscale", "rgb"}
    assert res["episodes"] > 0 and res["renders"] == 12
    assert res["step_launches"] == res["raster_launches"] == 0


@pytest.mark.parametrize("seed", [0, 1, 13])
def test_sampler_draws_the_shim_fuzz_configurations(seed):
    got = list(soak.sample(soak.parse_args(
        ["--configs", "12", "--steps", "400", "--seed", str(seed)])))
    rng = np.random.RandomState(seed)
    for ci, surface, kw, steps in got:
        assert surface == ("gym", "engine", "native")[ci % 3]
        assert kw == random_env_kwargs(rng, with_obs=(surface != "engine"))
        image = surface != "engine" and kw["obs_type"] != "ram"
        assert steps == (100 if image else 400)


def _holes_penalised_twice(monkeypatch):
    step = E.engine_step

    def faulty(cfg, state, action, injected_r=None):
        o = step(cfg, state, action, injected_r)
        if cfg.penalise_holes_increase and not cfg.penalise_holes:
            twice = o.reward - 5 * (o.state.holes - state.holes)
            o = o._replace(reward=torch.where(o.done, o.reward, twice))
        return o
    monkeypatch.setattr(E, "engine_step", faulty)


def _reset_draw_moved(monkeypatch):
    clear = E.engine_clear

    def faulty(cfg, state, injected_r=None):
        if injected_r is not None:
            injected_r = injected_r % 7 + 1
        return clear(cfg, state, injected_r)
    monkeypatch.setattr(E, "engine_clear", faulty)


@pytest.mark.parametrize("plant, field, step", [
    (_holes_penalised_twice, "reward", None),
    (_reset_draw_moved, "info", "reset")])
def test_a_planted_fault_fails(monkeypatch, capsys, plant, field, step):
    plant(monkeypatch)
    rc = soak.main(["--cpu"] + ARGS)
    out = capsys.readouterr().out
    assert rc == 1, out
    line = out.strip().splitlines()[-1]
    assert line.startswith("SHIM SOAK FAIL: config 0 surface=gym step="), line
    at = line.split(" step=")[1].split()[0]
    assert at == step if step else at.isdigit(), line
    assert f" field={field}: " in line, line


def test_no_card_and_no_cpu_flag_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert soak.main(ARGS) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_the_tool_leaves_jax_out():
    """The tool runs, and imports, without jax, flax or the JAX package
    (a fresh process)."""
    code = (
        "import os, sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import torch_soak_shim\n"
        "rc = torch_soak_shim.main(['--cpu', '--configs', '3', "
        "'--steps', '8'])\n"
        "assert rc == 0, rc\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'gym_simpletetris_tpu'))\n"
        "tests = os.path.join(os.getcwd(), 'tests') + os.sep\n"
        "bad += sorted(m for m, mod in list(sys.modules.items()) if "
        "(getattr(mod, '__file__', None) or '').startswith(tests))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "clean"
