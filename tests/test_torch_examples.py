"""Run every examples/torch_*.py end to end on the CPU (``--device cpu``)
with ``GST_EXAMPLE_SMOKE=1``, which shrinks their workloads, each in a
subprocess on one torch thread (the suite runs several workers at once)."""

import os
import subprocess
import sys

import pytest
import port_harness  # noqa: F401 (torch on one CPU thread)

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                            "examples")

_EXPECT = {
    "torch_random_agent.py": "episode 2:",
    "torch_vectorized_rollout.py": "env-steps/s on cpu",
    "torch_standalone_engine.py": "spawn statistics:",
    "torch_native_cpu.py": "native and cpu engines agree",
    "torch_train_and_watch.py": "wrote dqn_episode.gif",
}


@pytest.mark.parametrize("name", sorted(_EXPECT))
def test_torch_example_runs(name, tmp_path):
    path = os.path.abspath(os.path.join(EXAMPLES_DIR, name))
    env = dict(os.environ, GST_EXAMPLE_SMOKE="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, path, "--device", "cpu"],
        cwd=tmp_path,             # artifacts (gifs) land in the tmp dir
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        f"{name} failed:\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    assert _EXPECT[name] in proc.stdout, (
        f"{name} missing expected output {_EXPECT[name]!r}:\n{proc.stdout}")
    if name == "torch_train_and_watch.py":
        assert (tmp_path / "dqn_episode.gif").stat().st_size > 0
