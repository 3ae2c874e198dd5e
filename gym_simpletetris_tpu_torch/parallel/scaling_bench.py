"""Weak-scaling benchmark over the mesh's data axis (port of
``gym_simpletetris_tpu.parallel.scaling_bench``): the sharded storage
rollout, or with ``--train`` the mesh-aware DQN actor-learner, at a fixed
per-device batch on 1, 2, 4, ... ranks, reporting env-steps/s per device
(ideal weak scaling is flat). The device counts are capped at the world
size; a count below it runs on the first ranks (a sub-mesh) while the
others wait. Host clock around synchronised chunks.

    torchrun --nproc-per-node N -m gym_simpletetris_tpu_torch.parallel.scaling_bench --per-device 4096
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core import threefry
from ..core.config import EnvConfig
from ..core.state import _key_tensor
from .mesh import (DATA_AXIS, ShardedTetrisEnv, data_axis, init_distributed,
                   make_data_mesh, mesh_device)


def _sync(mesh) -> None:
    """Wait for this rank's device and for every rank of the mesh."""
    dev = mesh_device(mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.all_reduce(torch.zeros(1, device=dev), group=data_axis(mesh)[0])


def bench_mesh(cfg: EnvConfig, mesh, per_device: int, steps: int,
               chunk: int) -> dict:
    """The sharded rollout at ``per_device`` envs a rank."""
    _, rank, n = data_axis(mesh)
    B = per_device * n
    env = ShardedTetrisEnv(cfg, B, mesh)
    obs, state = env.reset(0)
    # the rank's block of the global actions, drawn on the rank
    off = env.env_offset
    actions = threefry.randint(_key_tensor(1, env.device), (chunk, B), 0, 7,
                               (1, off, off + per_device))
    state, acc, rew, done = env.rollout(state, actions)   # warm-up
    _sync(mesh)
    n_chunks = max(1, steps // chunk)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, acc, rew, done = env.rollout(state, actions)
    _sync(mesh)
    dt = time.perf_counter() - t0
    total = n_chunks * chunk * B
    return {"devices": n, "global_batch": B,
            "env_steps_per_sec": total / dt,
            "per_device_steps_per_sec": total / dt / n, "wall_s": dt}


def bench_train_mesh(ecfg: EnvConfig, mesh, per_device: int, steps: int,
                     chunk: int) -> dict:
    """Weak scaling of the full actor-learner: the mesh-aware
    ``make_train`` (env step, observation, replay insert, TD learner with
    its gradient ``all_reduce``, target sync) at ``per_device`` envs a
    rank."""
    from ..train.dqn import DQNConfig, make_train
    _, _, n = data_axis(mesh)
    B = per_device * n
    cfg = DQNConfig(env=ecfg, num_envs=B, buffer_capacity=B * 16,
                    learn_batch=max(64, B // 4), learn_starts=B * 2)
    init_fn, _, chunk_fn, _ = make_train(cfg, mesh_device(mesh), mesh=mesh)
    state = init_fn(0)
    state, m = chunk_fn(state, chunk)                     # warm-up
    _sync(mesh)
    n_chunks = max(1, steps // chunk)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, m = chunk_fn(state, chunk)
    _sync(mesh)
    dt = time.perf_counter() - t0
    total = n_chunks * chunk * B
    return {"devices": n, "global_batch": B, "mode": "actor_learner",
            "env_steps_per_sec": total / dt,
            "per_device_steps_per_sec": total / dt / n,
            "learn_steps": int(state.learn_steps), "wall_s": dt}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obs", default="ram", choices=["ram", "grayscale", "rgb"])
    p.add_argument("--per-device", type=int, default=4096)
    p.add_argument("--steps", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--device-counts", default=None,
                   help="comma list, default 1,2,4,...,world (capped at "
                        "the world size)")
    p.add_argument("--train", action="store_true",
                   help="weak-scale the full DQN actor-learner instead of "
                        "the bare env rollout")
    p.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu "
                   "(gloo)")
    args = p.parse_args(argv)

    cfg = EnvConfig(obs_type=args.obs, auto_reset=True,
                    reward_step=args.train)
    init_distributed(backend="gloo" if args.device == "cpu" else None)
    world_mesh = make_data_mesh(args.device)
    world = world_mesh.size()
    if args.device_counts:
        counts = [int(c) for c in args.device_counts.split(",")]
    else:
        counts = [c for c in (1, 2, 4, 8, 16, 32, 64) if c <= world]
    counts = [c for c in counts if c <= world]
    rank = dist.get_rank()
    results = []
    for c in counts:
        mesh = (world_mesh if c == world else
                DeviceMesh(world_mesh.device_type, list(range(c)),
                           mesh_dim_names=(DATA_AXIS,)))
        if rank < c:
            fn = bench_train_mesh if args.train else bench_mesh
            r = fn(cfg, mesh, args.per_device, args.steps, args.chunk)
            results.append(r)
            if rank == 0:
                print(json.dumps(r), flush=True)
        _sync(world_mesh)
    if len(results) > 1 and rank == 0:
        eff = (results[-1]["per_device_steps_per_sec"]
               / results[0]["per_device_steps_per_sec"])
        print(json.dumps({"weak_scaling_efficiency": eff,
                          "from": counts[0], "to": counts[-1]}), flush=True)
    return results


if __name__ == "__main__":
    main()
