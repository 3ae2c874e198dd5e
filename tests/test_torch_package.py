"""Boundaries of the PyTorch port: it imports no JAX, a CUDA request on a host
without CUDA raises instead of running on the CPU, other devices raise, and
a missing nvcc raises instead of falling back."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.core import engine as E
from gym_simpletetris_tpu_torch.core.state import init_state
from gym_simpletetris_tpu_torch.ops import _build, cuda_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import gym_simpletetris_tpu_torch\n"
        "import gym_simpletetris_tpu_torch.api.env, "
        "gym_simpletetris_tpu_torch.api.spaces\n"
        "import gym_simpletetris_tpu_torch.ops.cuda_step, "
        "gym_simpletetris_tpu_torch.ops.cuda_raster, "
        "gym_simpletetris_tpu_torch.ops._build\n"
        "import gym_simpletetris_tpu_torch.api.wrappers, "
        "gym_simpletetris_tpu_torch.models.actor_critic, "
        "gym_simpletetris_tpu_torch.models.heuristic, "
        "gym_simpletetris_tpu_torch.train.ppo, "
        "gym_simpletetris_tpu_torch.train.run_ppo, "
        "gym_simpletetris_tpu_torch.train.evaluate, "
        "gym_simpletetris_tpu_torch.utils.checkpoint, "
        "gym_simpletetris_tpu_torch.utils.kernel_timing\n"
        "from gym_simpletetris_tpu_torch.utils.checkpoint import "
        "load_flax_params\n"
        "load_flax_params('artifacts/ppo_lineclear_params.npz')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'gym_simpletetris_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is about hosts without it")
    with pytest.raises(RuntimeError, match="cuda"):
        TetrisVectorEnv(EnvConfig(), 4, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        init_state(EnvConfig(), 4, 0, device="cuda")


def test_entry_points_default_to_the_card():
    """With no ``device`` the entry points ask for the card: on a host
    without one each raises, none runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is about hosts without it")
    from gym_simpletetris_tpu_torch.api.env import reset_fn
    from gym_simpletetris_tpu_torch.train.evaluate import make_action_fn
    cfg = EnvConfig()
    with pytest.raises(RuntimeError, match="cuda"):
        TetrisVectorEnv(cfg, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        reset_fn(cfg, 4, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        init_state(cfg, 4, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        make_action_fn("random", cfg, 4)


def test_other_devices_raise():
    with pytest.raises(ValueError, match="device"):
        TetrisVectorEnv(EnvConfig(), 4, device="meta")
    cfg = EnvConfig()
    s = init_state(cfg, 4, 0, device="meta")
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_step.step(cfg, s, z, z, s.key)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_follows_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libtetris_kernels_") and path.suffix == ".so"
    assert sorted(p.name for p in _build._sources()) == ["raster.cu", "step.cu"]


def test_cpu_step_never_launches():
    cfg = EnvConfig()
    s, _ = E.engine_clear(cfg, init_state(cfg, 4, 0, device="cpu"))
    n = cuda_step.step.launches
    out = E.engine_step(cfg, s, np.full(4, 2))
    assert out.state.rows.device.type == "cpu"
    assert cuda_step.step.launches == n
