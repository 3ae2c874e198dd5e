"""Boundaries of the PyTorch port: it imports no JAX (nor flax or optax; the
DQN path on the legacy ring and the obs ring, an ES generation, a shim and a
standalone engine run a few steps in the check), it imports and runs
without gymnasium, gym, pygame, PIL and tensorboardX, a CUDA request on a
host without CUDA raises instead of running on the CPU, other devices
raise, and a missing nvcc raises instead of falling back."""

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
from gym_simpletetris_tpu_torch.utils.profiling import counters
import port_harness  # noqa: F401 (torch on one CPU thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# The user-facing surfaces and utils: each imports without jax, and without
# gymnasium, gym, pygame, PIL and tensorboardX (the card's machine has none).
_NEW_MODULES = (
    "import gym_simpletetris_tpu_torch.api.engine, "
    "gym_simpletetris_tpu_torch.api.primitives, "
    "gym_simpletetris_tpu_torch.api.gym_compat, "
    "gym_simpletetris_tpu_torch.api.registry, "
    "gym_simpletetris_tpu_torch.api.gymnasium_vector, "
    "gym_simpletetris_tpu_torch.api.native_env, "
    "gym_simpletetris_tpu_torch.native, "
    "gym_simpletetris_tpu_torch.utils.metrics, "
    "gym_simpletetris_tpu_torch.utils.video, "
    "gym_simpletetris_tpu_torch.utils.profiling, "
    "gym_simpletetris_tpu_torch.parallel.mesh, "
    "gym_simpletetris_tpu_torch.parallel.collective_bench, "
    "gym_simpletetris_tpu_torch.parallel.scaling_bench, "
    "gym_simpletetris_tpu_torch.train.sharding, "
    "gym_simpletetris_tpu_torch.graft_entry\n")


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
        "import gym_simpletetris_tpu_torch.models.dqn, "
        "gym_simpletetris_tpu_torch.train.replay, "
        "gym_simpletetris_tpu_torch.train.dqn, "
        "gym_simpletetris_tpu_torch.train.run_dqn, "
        "gym_simpletetris_tpu_torch.train.es, "
        "gym_simpletetris_tpu_torch.train.run_es\n"
        "from gym_simpletetris_tpu_torch.train import dqn, es\n"
        "for ring in (False, True):\n"
        "    init_fn, _, chunk_fn, _ = dqn.make_train(dqn.DQNConfig("
        "num_envs=4, buffer_capacity=32, learn_batch=4, learn_starts=8, "
        "noisy=True, distributional=True, prioritized=True, n_step=2, "
        "frame_ring=ring, ring_stacks=ring, sample_slots=ring), 'cpu')\n"
        "    chunk_fn(init_fn(0), 4)\n"
        "init_fn, gen_fn, _ = es.make_es(es.ESConfig(pop_size=4, "
        "envs_per_member=1, horizon=2, hidden=(8,)), 'cpu')\n"
        "gen_fn(init_fn(0))\n"
        "from gym_simpletetris_tpu_torch.utils.checkpoint import "
        "load_flax_params\n"
        "load_flax_params('artifacts/ppo_lineclear_params.npz')\n"
        + _NEW_MODULES +
        "from gym_simpletetris_tpu_torch import TetrisEnv, TetrisEngine\n"
        "env = TetrisEnv(obs_type='grayscale', device='cpu')\n"
        "env.reset()\n"
        "env.step(2)\n"
        "env.render('rgb_array')\n"
        "eng = TetrisEngine(10, 20, device='cpu')\n"
        "eng.clear()\n"
        "eng.step(2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'gym_simpletetris_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_imports_without_the_optional_packages():
    """With gymnasium, gym, pygame, PIL and tensorboardX blocked (a
    ``sys.modules`` entry of None makes their import raise), the package
    and every new module import and a shim runs, as on the card's
    machine."""
    code = (
        "import sys\n"
        "for m in ('gymnasium', 'gym', 'pygame', 'PIL', 'tensorboardX'):\n"
        "    sys.modules[m] = None\n"
        "import gym_simpletetris_tpu_torch as port\n"
        + _NEW_MODULES +
        "env = port.make(backend='cpu', obs_type='rgb')\n"
        "env.reset()\n"
        "env.step(0)\n"
        "assert env.render('rgb_array').shape == (160, 160, 3)\n"
        "assert port.register_gym() is False\n"
        "from gym_simpletetris_tpu_torch.api.gymnasium_vector import "
        "_TorchVectorCore\n"
        "core = _TorchVectorCore(2, 0, device='cpu')\n"
        "core.reset()\n"
        "core.step([2, 2])\n"
        "from gym_simpletetris_tpu_torch.utils.metrics import MetricLogger\n"
        "MetricLogger(stdout=False).log({'a': 1}, 0)\n"
        "for name in ('gymnasium', 'PIL', 'pygame', 'tensorboardX'):\n"
        "    try:\n"
        "        __import__(name)\n"
        "        raise SystemExit(name + ' was importable')\n"
        "    except ImportError:\n"
        "        pass\n"
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
    from gym_simpletetris_tpu_torch.train import dqn, run_dqn
    with pytest.raises(RuntimeError, match="cuda"):
        dqn.make_train(dqn.DQNConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        dqn.train(dqn.DQNConfig(num_envs=4, buffer_capacity=16), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        dqn.make_train(dqn.DQNConfig(frame_ring=True, ring_stacks=True))
    assert run_dqn.parse_args([]).device == "cuda"
    from gym_simpletetris_tpu_torch.train import es, run_es
    with pytest.raises(RuntimeError, match="cuda"):
        es.make_es(es.ESConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        es.train(es.ESConfig(pop_size=2, envs_per_member=1), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        make_action_fn("es", cfg, 4, ckpt="missing.pt")
    assert run_es.parse_args([]).device == "cuda"
    from gym_simpletetris_tpu_torch import TetrisEngine, TetrisEnv, make
    from gym_simpletetris_tpu_torch.api.gymnasium_vector import (
        _TorchVectorCore)
    from gym_simpletetris_tpu_torch.utils.checkpoint import (
        restore_checkpoint)
    for entry in (lambda: TetrisEnv(), lambda: TetrisEngine(10, 20),
                  lambda: make(), lambda: make(batch_size=2),
                  lambda: _TorchVectorCore(2, 0),
                  lambda: restore_checkpoint("missing.pt")):
        with pytest.raises(RuntimeError, match="cuda"):
            entry()


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
    assert sorted(p.name for p in _build._sources()) == [
        "draw.cu", "noise.cu", "raster.cu", "reset.cu", "step.cu"]


def test_library_name_follows_the_headers(tmp_path, monkeypatch):
    """A changed header (``csrc/*.cuh``, which the sources include) names
    another library, so it builds anew."""
    for src in _build.CSRC_DIR.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path()
    header = tmp_path / "threefry.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build.library_path() != before


def test_cpu_step_never_launches():
    cfg = EnvConfig()
    s, _ = E.engine_clear(cfg, init_state(cfg, 4, 0, device="cpu"))
    n = counters()["kernel.step.launches"]
    out = E.engine_step(cfg, s, np.full(4, 2))
    assert out.state.rows.device.type == "cpu"
    assert counters()["kernel.step.launches"] == n


_MESH_MODULES = ("gym_simpletetris_tpu_torch.parallel.mesh",
                 "gym_simpletetris_tpu_torch.parallel.collective_bench",
                 "gym_simpletetris_tpu_torch.parallel.scaling_bench",
                 "gym_simpletetris_tpu_torch.train.sharding",
                 "gym_simpletetris_tpu_torch.graft_entry")


def test_mesh_modules_leave_jax_out_and_add_only_torch_distributed():
    """The data-parallel modules import no JAX, and nothing outside torch
    and the standard library that the rest of the port does not import
    already; a world of one (in-process store) drives the sharded env, the
    three trainers' mesh branches, a mesh checkpoint and ``entry()``."""
    code = (
        "import sys, tempfile, os\n"
        "import gym_simpletetris_tpu_torch.train.dqn, "
        "gym_simpletetris_tpu_torch.train.ppo, "
        "gym_simpletetris_tpu_torch.train.es, "
        "gym_simpletetris_tpu_torch.utils.checkpoint\n"
        "before = {m.split('.')[0] for m in sys.modules}\n"
        f"for m in {_MESH_MODULES!r}:\n"
        "    __import__(m)\n"
        "new = {m.split('.')[0] for m in sys.modules} - before\n"
        "assert new <= set(sys.stdlib_module_names) | {'torch'}, new\n"
        "from gym_simpletetris_tpu_torch import EnvConfig\n"
        "from gym_simpletetris_tpu_torch.parallel import mesh as M\n"
        "from gym_simpletetris_tpu_torch.train import dqn, ppo, es\n"
        "from gym_simpletetris_tpu_torch.utils import checkpoint as C\n"
        "from gym_simpletetris_tpu_torch import graft_entry\n"
        "M.init_distributed()\n"
        "mesh = M.make_data_mesh('cpu')\n"
        "env = M.ShardedTetrisEnv(EnvConfig(auto_reset=True), 4, mesh)\n"
        "obs, s = env.reset(0)\n"
        "env.step(s, [2, 2, 2, 2])\n"
        "i, _, c, _ = dqn.make_train(dqn.DQNConfig(num_envs=4, "
        "buffer_capacity=32, learn_batch=4, learn_starts=8, "
        "prioritized=True), 'cpu', mesh=mesh)\n"
        "st, _ = c(i(0), 4)\n"
        "d = tempfile.mkdtemp()\n"
        "C.save_checkpoint(os.path.join(d, 'c.pt'), st, mesh=mesh)\n"
        "C.restore_checkpoint(os.path.join(d, 'c.pt'), 'cpu', mesh=mesh)\n"
        "i, u, _ = ppo.make_ppo(ppo.PPOConfig(num_envs=4, rollout_len=2, "
        "num_minibatches=2), 'cpu', mesh=mesh)\n"
        "u(i(0))\n"
        "i, g, _ = es.make_es(es.ESConfig(pop_size=4, envs_per_member=1, "
        "horizon=2, hidden=(8,)), 'cpu', mesh=mesh)\n"
        "g(i(0))\n"
        "fn, args = graft_entry.entry('cpu')\n"
        "assert tuple(fn(*args).shape) == (8, 7)\n"
        "M.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'gym_simpletetris_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


_FAKE_NVCC = """#!/bin/sh
# a stand-in for nvcc: records each call, takes a while, writes its -o
out=""
prev=""
for a in "$@"; do
    [ "$prev" = "-o" ] && out="$a"
    prev="$a"
done
echo "$PPID $*" >> "$(dirname "$0")/calls"
sleep 1
echo built > "$out"
"""


def test_concurrent_builds_build_once(tmp_path):
    """Two processes that build the kernels at once into an empty build
    directory (nvcc mocked): the sources compile once and link once, and
    both get the same library."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from gym_simpletetris_tpu_torch.ops import _build\n"
        f"_build.BUILD_DIR = Path({str(build_dir)!r})\n"
        "print(_build.build()['path'])\n")
    env = dict(os.environ, CUDA_HOME=str(cuda))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    lib = paths.pop()
    assert os.path.exists(lib) and os.path.dirname(lib) == str(build_dir)
    calls = (cuda / "bin" / "calls").read_text().splitlines()
    n_src = len(_build._sources())
    assert len(calls) == n_src + 1, calls          # each source, one link
    assert sum(" -c " in c for c in calls) == n_src
    assert len({c.split()[0] for c in calls}) == 1   # one process built
    leftovers = [p.name for p in build_dir.iterdir()
                 if p.name not in (os.path.basename(lib), ".lock")]
    assert not leftovers, leftovers
