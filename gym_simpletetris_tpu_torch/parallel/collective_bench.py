"""Collective micro-benchmark over the mesh's data axis (port of
``gym_simpletetris_tpu.parallel.collective_bench``): the three collectives
the data-parallel trainers ride on, with the JAX script's ops and JSON keys.

- ``psum``: ``all_reduce`` divided by n;
- ``all_gather_sum``: ``all_gather_into_tensor``, summed over the ranks;
- ``ppermute``: each rank sends its buffer to the next around a ring
  (``batch_isend_irecv``); at world 1 it is the identity, and the result
  says so instead of timing a copy.

Timed with CUDA events on the card (the host clock on the CPU), ``iters``
calls after a warm-up. Bandwidth figures mean something only across cards.

    torchrun --nproc-per-node N -m gym_simpletetris_tpu_torch.parallel.collective_bench --mb 64
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from .mesh import data_axis, init_distributed, make_data_mesh, mesh_device


def _seconds(fn, iters: int, device: torch.device) -> float:
    """Mean seconds of ``fn()`` over ``iters`` calls after one warm-up."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def bench_collectives(mesh, mb: float = 64.0, iters: int = 10) -> dict:
    """{"devices", "mb_per_device", "results": [{"op", "seconds",
    "algo_GBps_per_device"}, ...]} for psum, all_gather_sum and ppermute
    on ``mb`` MB of float32 per rank."""
    group, rank, n = data_axis(mesh)
    dev = mesh_device(mesh)
    per_dev = int(mb * 1e6 / 4)
    x = torch.ones(per_dev, dtype=torch.float32, device=dev)
    gathered = torch.empty(n * per_dev, dtype=torch.float32, device=dev)
    recv = torch.empty_like(x)

    def psum():
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / n

    def all_gather_sum():
        dist.all_gather_into_tensor(gathered, x, group=group)
        return gathered.view(n, per_dev).sum(dim=0)

    def ppermute():
        peer = lambda i: dist.get_global_rank(group, i % n)
        ops = [dist.P2POp(dist.isend, x, peer(rank + 1), group),
               dist.P2POp(dist.irecv, recv, peer(rank - 1), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def run(name, fn, bytes_per_device):
        dt = _seconds(fn, iters, dev)
        return {"op": name, "seconds": dt,
                "algo_GBps_per_device": bytes_per_device / dt / 1e9}

    shard_bytes = per_dev * 4
    res = [
        # ring all-reduce: reduce-scatter + all-gather = 2*(n-1)/n shards
        run("psum", psum, shard_bytes * 2 * (n - 1) / n),
        # ring all-gather: each rank sends and receives (n-1) shards
        run("all_gather_sum", all_gather_sum, shard_bytes * (n - 1)),
    ]
    if n == 1:
        res.append({"op": "ppermute", "seconds": None,
                    "algo_GBps_per_device": None,
                    "note": "identity at world 1: nothing is sent"})
    else:
        res.append(run("ppermute", ppermute, shard_bytes))
    return {"devices": n, "mb_per_device": mb, "results": res}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mb", type=float, default=64.0)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu "
                   "(gloo)")
    args = p.parse_args(argv)
    init_distributed(backend="gloo" if args.device == "cpu" else None)
    out = bench_collectives(make_data_mesh(args.device), args.mb, args.iters)
    if dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
