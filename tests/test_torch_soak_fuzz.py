"""``tools/torch_soak_fuzz.py``, the port's soak fuzz, on the CPU: the plain
engine replays the port's C++ oracle's games (``native.drive_many``) bit
for bit, over every action script and rows of one and two words; the
84 px images match the host raster; each configuration's line equals
``tools/soak_fuzz.py``'s for the same arguments (the JAX tool, run as it
is); a fault planted in the engine fails it; without a card and without
``--cpu`` it exits nonzero; it and ``chip_smoke.py`` import no jax.
"""

import os
import subprocess
import sys

import pytest

from gym_simpletetris_tpu_torch.core import engine as E
import port_harness  # noqa: F401 (torch on one CPU thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_soak_fuzz as soak  # noqa: E402


# seed 89's six configurations draw all six scripts and widths above 24
ARGS = ["--configs", "6", "--batch", "8", "--steps", "64", "--seed", "89"]


def _lines(text: str) -> list:
    """Each configuration's line up to its verdict."""
    return [ln.split(" OK (")[0] for ln in text.splitlines()
            if ln.startswith("[")]


@pytest.fixture(scope="module")
def cpu_run():
    out = []
    res = soak.soak(soak.parse_args(["--cpu"] + ARGS),
                    out=lambda s, **_: out.append(s))
    return res, out


def test_soak_passes_on_the_cpu_over_every_script(cpu_run):
    res, out = cpu_run
    assert res["steps"] == 6 * 8 * 64 and res["configs"] == 6
    assert res["instances"] == {"plain": {"configs": 6, "launches": 0}}
    assert {ln.split()[4] for ln in _lines("\n".join(out))} == set(
        soak.SCRIPTS)
    widths = [int(ln.split()[1][1:]) for ln in _lines("\n".join(out))]
    assert max(widths) > 24 and min(widths) <= 24


def test_lines_equal_the_jax_tools(cpu_run):
    jax_out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "soak_fuzz.py"),
         "--cpu"] + ARGS, capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert jax_out.returncode == 0, jax_out.stderr[-2000:]
    assert "SOAK PASS: 0.00M steps bitwise across 6" in jax_out.stdout
    want = _lines(jax_out.stdout)
    assert len(want) == 6
    assert _lines("\n".join(cpu_run[1])) == want


def test_pixels_pass_on_the_cpu_at_84(capsys):
    rc = soak.main(["--cpu", "--pixels", "--configs", "3", "--batch", "4",
                    "--steps", "24", "--seed", "5", "--chunk-bytes",
                    str(4 * 84 * 84 * 10)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "SOAK PASS: 0.00M steps bitwise across 3 random configs" in out


def test_a_planted_fault_fails(monkeypatch, capsys):
    """The reset's draws taken from the neighbouring env."""
    clear = E.engine_clear

    def shifted(cfg, state, injected_r=None):
        if injected_r is not None:
            injected_r = injected_r.roll(1)
        return clear(cfg, state, injected_r)

    monkeypatch.setattr(E, "engine_clear", shifted)
    rc = soak.main(["--cpu"] + ARGS)
    out = capsys.readouterr().out
    assert rc == 1
    assert "SOAK FAIL: cfg=" in out and " env=" in out and " step=" in out


def test_no_card_and_no_cpu_flag_exits_nonzero(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert soak.main(ARGS) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(ValueError, match="card only"):
        soak.soak(soak.parse_args(["--cpu", "--instances", "all"] + ARGS))


def test_the_tool_and_chip_smoke_leave_jax_out():
    """The tool runs, and it and ``chip_smoke.py`` import, without jax,
    flax or the JAX package (a fresh process)."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tools')\n"
        "import chip_smoke, torch_soak_fuzz\n"
        "rc = torch_soak_fuzz.main(['--cpu', '--pixels', '--configs', '2', "
        "'--batch', '4', '--steps', '8'])\n"
        "assert rc == 0, rc\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'gym_simpletetris_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "clean"
