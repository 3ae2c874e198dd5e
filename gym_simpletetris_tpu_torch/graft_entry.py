"""Entry points of the PyTorch port for a one-card compile check and a
multi-process dry run (the twin of the repository root's
``__graft_entry__.py``, which drives the JAX package).

``entry()`` returns the flagship model's forward (the dueling NatureDQN on
84 x 84 grayscale observations) with example arguments on the card.

``dryrun_multichip(n)`` spawns n ranks (one process each; NCCL on n
cards, gloo on the CPU or when named) and runs the JAX dry run's two
trainer families on its tiny configurations: the Rainbow DQN on the obs
ring with a live PER learner (a 6-step chunk whose last step is the first
learner update), and one PPO update (rollout, GAE, minibatched epochs). It
sweeps the JAX dry run's (data, model) mesh shapes, (n, 1), (n/2, 2) and
(n/4, 4) where they divide, all in the one world of n processes; a model
axis splits the conv trunk, the dense layers and the PPO MLP (the heads
stay whole). Every metric at every shape is held to the unsharded run on
one device (rtol 1e-5, atol 1e-6), but PPO's loss metrics above one rank
(``_tolerance``).

    python -m gym_simpletetris_tpu_torch.graft_entry [n] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

DRYRUN_TIMEOUT = 600


def entry(device="cuda"):
    """(fn, example_args) for a compile check of the flagship model: the
    dueling NatureDQN forward over 8 grayscale 84 x 84 observations."""
    from .api.env import check_device
    from .models.dqn import build_q_network
    device = check_device(device)
    net = build_q_network("grayscale", (84, 84, 1), dueling=True)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(device)

    def fn(obs):
        with torch.no_grad():
            return net(obs)

    return fn, (torch.full((8, 84, 84, 1), 128.0, device=device),)


def _dryrun_configs(n: int):
    """The JAX dry run's DQN and PPO configurations for n ranks."""
    from .core.config import EnvConfig
    from .train.dqn import DQNConfig
    from .train.ppo import PPOConfig
    num_envs = max(8, n)
    num_envs -= num_envs % n
    dqn = DQNConfig(
        env=EnvConfig(obs_type="grayscale", auto_reset=True, width=6,
                      height=8),
        num_envs=num_envs, buffer_capacity=num_envs * 8,
        # learning goes live on the chunk's last step: one learner update
        learn_batch=num_envs, learn_starts=num_envs * 6,
        prioritized=True, n_step=2, dueling=True, distributional=True,
        num_atoms=21, noisy=True, frame_stack=2, frame_ring=True,
        ring_stacks=True)
    ppo = PPOConfig(
        env=EnvConfig(obs_type="ram", auto_reset=True, width=6, height=8),
        num_envs=max(16, num_envs), rollout_len=8, epochs=2,
        num_minibatches=4, shuffle_block=1)
    return dqn, ppo


def mesh_shapes(n: int) -> list:
    """The (data, model) shapes of an n-rank dry run: (n, 1), then (n/2, 2)
    and (n/4, 4) where they divide (JAX's ``_mesh_shapes``)."""
    return [(n, 1)] + [(n // m, m) for m in (2, 4) if n % m == 0]


def _run_families(n: int, device, mesh=None) -> dict:
    """Metrics of the DQN chunk and the PPO update (prefixed), as numpy."""
    from .train.dqn import make_train
    from .train.ppo import make_ppo
    dqn_cfg, ppo_cfg = _dryrun_configs(n)
    init_fn, _, chunk_fn, _ = make_train(dqn_cfg, device, mesh=mesh)
    _, m = chunk_fn(init_fn(0), 6)
    out = {f"dqn.{k}": v for k, v in m.items()}
    init_fn, update_fn, _ = make_ppo(ppo_cfg, device, mesh=mesh)
    _, m = update_fn(init_fn(1))
    out.update({f"ppo.{k}": v for k, v in m.items()})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


# PPO's loss metrics are means over the update's 8 minibatches, 7 of them
# after an Adam step. Above one rank the learner sums the ranks' float32
# gradient shares (over the data axis), or a layer's input gradient from
# the model ranks' partial sums (over the model axis), in another order
# than one device's GEMM sums its rows,
# so a weight gradient whose float32 sum lies at a bf16 rounding boundary
# can round the other way (a few weights a step), and Adam carries that
# into the next minibatch's losses. pg_loss, a mean of terms of order 1
# that cancel to a few hundredths, moves most (2.1e-6 at 2 ranks on the
# CPU): those metrics are held to the trainers' mesh tolerance
# (tests/test_torch_mesh_train.py, rtol 2e-4, atol 2e-6); every other
# metric, and every metric at one rank, to 1e-5 / 1e-6.
_PPO_LOSS_METRICS = ("ppo.pg_loss", "ppo.v_loss", "ppo.entropy",
                     "ppo.clip_frac")


def _tolerance(metric: str, n: int):
    if n > 1 and metric in _PPO_LOSS_METRICS:
        return 2e-4, 2e-6
    return 1e-5, 1e-6


def _dryrun_rank(rank: int, n: int, store: str, device: str, backend: str,
                 out: str):
    from torch.distributed.device_mesh import init_device_mesh
    from .parallel.mesh import init_distributed, shutdown
    torch.set_num_threads(1)
    init_distributed(f"file://{store}", n, rank, backend=backend)
    metrics = {}
    try:
        for d, m in mesh_shapes(n):
            mesh = init_device_mesh(device, (d, m),
                                    mesh_dim_names=("data", "model"))
            metrics.update({f"{d}x{m}/{k}": v for k, v in
                            _run_families(n, device, mesh).items()})
    finally:
        shutdown()
    if rank == 0:
        np.savez(out, **metrics)


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: str = None) -> dict:
    """Run both trainer families at each (data, model) shape of
    ``mesh_shapes(n_devices)`` in one world of ``n_devices`` spawned
    processes, and assert every metric against the unsharded run on one
    device. ``backend``: NCCL on cards (one a rank), gloo on the CPU; gloo
    on the card runs every rank on one card. Returns the sharded metrics,
    keyed ``"{data}x{model}/{family}.{metric}"``."""
    from .api.env import check_device
    dev = check_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                         f"cards, this host has {torch.cuda.device_count()}")
    golden = _run_families(n_devices, dev)
    assert np.isfinite(golden["dqn.mean_q"]), golden
    assert golden["dqn.loss"] != 0.0, golden     # the learner really ran
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="gst_dryrun_") as tmp:
        out = os.path.join(tmp, "metrics.npz")
        code = ("import sys; from gym_simpletetris_tpu_torch.graft_entry "
                "import _dryrun_rank; _dryrun_rank(*sys.argv[1:2], "
                f"{n_devices}, {os.path.join(tmp, 'store')!r}, "
                f"{dev.type!r}, {backend!r}, {out!r})")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
        procs = [subprocess.Popen([sys.executable, "-c", code.replace(
            "*sys.argv[1:2]", str(r))], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n_devices)]
        try:
            logs = [p.communicate(timeout=DRYRUN_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip({n_devices}): rank {r} "
                                   f"exited {p.returncode}:\n{log[-4000:]}")
        with np.load(out) as z:
            host = {k: z[k] for k in z.files}
    shapes = mesh_shapes(n_devices)
    assert set(host) == {f"{d}x{m}/{k}" for d, m in shapes for k in golden}, \
        (set(host), set(golden))
    for d, m in shapes:
        for family in ("dqn", "ppo"):
            keys = [k for k in golden if k.startswith(family + ".")]
            got = {k: host[f"{d}x{m}/{k}"] for k in keys}
            bitwise = all(np.array_equal(got[k], golden[k]) for k in keys)
            for k in keys:
                rtol, atol = _tolerance(k, n_devices)
                np.testing.assert_allclose(
                    got[k], golden[k], rtol=rtol, atol=atol,
                    err_msg=f"mesh ({d}, {m}) metric {k} != unsharded")
            print(f"dryrun_multichip({n_devices}): {family.upper()} mesh "
                  f"({d}, {m}) ok: metrics match unsharded "
                  f"({'bitwise' if bitwise else 'within tolerance'})",
                  flush=True)
    print(f"dryrun_multichip({n_devices}): ok at the (data, model) shapes "
          f"{', '.join(f'({d}, {m})' for d, m in shapes)} for both trainer "
          f"families", flush=True)
    return host


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("n", type=int, nargs="?", default=None,
                   help="ranks (default: the cards present)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device != "cpu":
        fn, example = entry(args.device)
        out = fn(*example)
        print("entry forward:", tuple(out.shape), out.dtype, flush=True)
    n = args.n or (torch.cuda.device_count() if args.device != "cpu" else 2)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
