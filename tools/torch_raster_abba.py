#!/usr/bin/env python3
"""Time two versions of the PyTorch port's raster kernels B and C (and the
rollouts around them) on one CUDA card, in turns: parent, new, new, parent,
twice.

    git archive <parent commit> | tar -x -C <dir>
    python3 tools/torch_raster_abba.py --parent <dir> [--out readings.jsonl]

Imports this checkout's ``gym_simpletetris_tpu_torch`` and the parent's as
``parent_port`` into one process; each builds its own kernels from its own
``csrc/``. For each shape (84 px at B = 4096 on 10 x 20 and 32 x 20, and at
B = 256; 160 px at B = 4096; 512 px at B = 1024 on 40 x 26) it holds both
versions' images bitwise equal, then times each version's kernels with
``utils.kernel_timing.raster_device_times`` (device us by CUDA-graph replay,
each against its bytes bound, C with L2 evicted and, beside it, warm) and
their wrapper ms. The new kernels are also timed into an image view at a
4-byte offset, which takes the walk instead of the chunk table. Then the
rollout env-steps/s of both at B = 4096, T = 128, for ram, grayscale and rgb
on both boards, interleaved the same way. Prints one JSON line per reading
and a summary; with ``--out``, writes the readings there as JSON lines too.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("parent", "new", "new", "parent") * 2
SHAPES = (  # (width, height, size, batch)
    (10, 20, 84, 4096), (32, 20, 84, 4096), (10, 20, 84, 256),
    (10, 20, 160, 4096), (40, 26, 512, 1024))
KERNELS = ("raster", "raster_accumulate", "raster_accumulate_l2_warm",
           "raster_walk", "raster_accumulate_walk")


def _import_as(name: str, pkg_dir: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _random_rows(cfg, B, rng):
    """Random words (guard bits too) in the state layout of ``cfg``."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch.core.state import rows_shape
    words = rng.randint(0, 2 ** 32, rows_shape(cfg, B),
                        dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)).to("cuda")


def _kernel_readings(ports, rng):
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch.utils import kernel_timing as kt
    out = []
    flush = kt.l2_flush()
    for w, h, size, B in SHAPES:
        cfgs = {k: p.EnvConfig(width=w, height=h) for k, p in ports.items()}
        crs = {k: importlib.import_module(p.__name__ + ".ops.cuda_raster")
               for k, p in ports.items()}
        rows = _random_rows(cfgs["new"], B, rng)
        imgs = {k: crs[k].rasterize_rows(cfgs[k], rows, size) for k in ports}
        if not torch.equal(imgs["new"], imgs["parent"]):
            raise RuntimeError(f"new != parent image at {w}x{h} {size}px")
        acc0 = torch.as_tensor(rng.randint(0, 256, (B, size, size),
                                           dtype=np.uint8), device="cuda")
        accs = {k: crs[k].raster_accumulate(cfgs[k], rows, acc0.clone(), size)
                for k in ports}
        if not torch.equal(accs["new"], accs["parent"]):
            raise RuntimeError(f"new != parent accumulate at {w}x{h} {size}px")
        for turn, which in enumerate(ORDER):
            cr, cfg, acc = crs[which], cfgs[which], accs[which]
            times = kt.raster_device_times(cfg, rows, size, cuda_raster=cr)
            c = times["raster_accumulate"]
            times["raster_accumulate_l2_warm"] = dict(
                device_us=c.pop("l2_warm_device_us"))
            times["raster"]["wrapper_ms"] = kt.sync_ms(
                lambda: cr.rasterize_rows(cfg, rows, size), 200)
            c["wrapper_ms"] = kt.sync_ms(
                lambda: cr.raster_accumulate(cfg, rows, acc, size), 200)
            if which == "new":
                # the walk instead of the chunk table: an image view at a
                # 4-byte offset is not 16-byte aligned
                n = B * size * size
                view = torch.empty(n + 16, dtype=torch.uint8,
                                   device="cuda")[4:4 + n].view(B, size, size)
                for name, fn, fl, ref in (
                        ("raster_walk",
                         lambda: cr._launch(cfg, rows, view, size, False),
                         None, "raster"),
                        ("raster_accumulate_walk",
                         lambda: cr.raster_accumulate(cfg, rows, view, size),
                         flush, "raster_accumulate")):
                    us = kt.device_us(fn, 20, fl)
                    bound = times[ref]["bound_us"]
                    times[name] = dict(device_us=us, bound_us=bound,
                                       bound_share=bound / us)
            for kernel in KERNELS:
                if kernel in times:
                    rec = dict(what="kernel", kernel=kernel, version=which,
                               turn=turn, width=w, height=h, size=size, B=B,
                               **times[kernel])
                    out.append(rec)
                    print(json.dumps(rec), flush=True)
    return out


def _rollout_readings(ports, T: int = 128, B: int = 4096):
    import numpy as np
    import torch
    out = []
    for w in (10, 32):
        for o in ("ram", "grayscale", "rgb"):
            envs, starts = {}, {}
            acts = torch.as_tensor(np.random.RandomState(3).randint(
                0, 7, (T, B)), device="cuda")
            for k, p in ports.items():
                cfg = p.EnvConfig(width=w, obs_type=o, auto_reset=True)
                envs[k] = p.TetrisVectorEnv(cfg, B, device="cuda")
                starts[k] = envs[k].reset(0)[1]
                envs[k].rollout(starts[k], acts[:8])        # warm up
            finals = {}
            for turn, which in enumerate(ORDER):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                final, acc, rew, don = envs[which].rollout(starts[which], acts)
                torch.cuda.synchronize()
                rate = B * T / (time.perf_counter() - t0)
                finals[which] = acc
                rec = dict(what="rollout", version=which, turn=turn, width=w,
                           obs=o, B=B, T=T, env_steps_per_s=rate)
                out.append(rec)
                print(json.dumps(rec), flush=True)
            if not torch.equal(finals["new"], finals["parent"]):
                raise RuntimeError(f"new != parent rollout at w{w} {o}")
    return out


def _summary(recs) -> None:
    med = statistics.median
    for w, h, size, B in SHAPES:
        for kernel in KERNELS:
            line = [f"{w}x{h} {size}px B={B} {kernel}:"]
            for which in ("parent", "new"):
                rs = [r for r in recs if r["what"] == "kernel"
                      and r["kernel"] == kernel and r["version"] == which
                      and (r["width"], r["size"], r["B"]) == (w, size, B)]
                if not rs:
                    continue
                us = [r["device_us"] for r in rs]
                share = (f", {100 * rs[0]['bound_us'] / med(us):.1f}% of "
                         f"{rs[0]['bound_us']:.3f}" if "bound_us" in rs[0]
                         else ", L2-warm: no HBM bound")
                line.append(f"{which} {[round(u, 3) for u in us]} us "
                            f"(median {med(us):.3f}{share})")
            print(" ".join(line), flush=True)
    for w in (10, 32):
        for o in ("ram", "grayscale", "rgb"):
            line = [f"rollout w{w} {o}:"]
            for which in ("parent", "new"):
                xs = [r["env_steps_per_s"] for r in recs
                      if r["what"] == "rollout" and r["version"] == which
                      and r["width"] == w and r["obs"] == o]
                line.append(f"{which} {[round(x) for x in xs]} "
                            f"(median {med(xs):.0f})")
            print(" ".join(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the parent commit (its root)")
    ap.add_argument("--out", default=None,
                    help="a file for the readings, one JSON object a line")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_raster_abba: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import gym_simpletetris_tpu_torch as new
    parent = _import_as("parent_port", os.path.join(
        os.path.abspath(args.parent), "gym_simpletetris_tpu_torch"))
    ports = {"parent": parent, "new": new}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    recs = _kernel_readings(ports, np.random.RandomState(0))
    recs += _rollout_readings(ports)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps({"card": card, "torch": torch.__version__})
                    + "\n")
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    _summary(recs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
