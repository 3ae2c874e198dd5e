#!/usr/bin/env python3
"""Time two versions of the PyTorch port's step kernel A on one CUDA card, in
turns: parent, new, new, parent, twice.

    git archive <parent commit> | tar -x -C <dir>
    python3 tools/torch_step_abba.py --parent <dir> [--out readings.jsonl]

Imports this checkout's ``gym_simpletetris_tpu_torch`` and the parent's as
``parent_port`` into one process (``torch_raster_abba._import_as``); each
builds its own kernels from its own ``csrc/``. For each shape (10 x 20 at
B = 512, 3584, 4096, 8192, 16384, 32768 and 65536; 32 x 20 at B = 4096) it
makes one state as a rollout meets it (``kernel_timing.step_inputs``),
holds both versions' step outputs bitwise equal on it for the random
actions and for all hard drops, then times each version with
``kernel_timing.step_device_times`` (device us by CUDA-graph replay, beside
the bytes bound, both action mixes; for the new version its other instances
too) and its wrapper ms (``sync_ms`` over 200 calls). The crossover shapes
(32 x 20, 100 x 20, 10 x 32 and 1024 x 20 at larger batches) place the
batch from which the launch plan leaves the warp instance. Prints one JSON
line per reading and a summary; with ``--out``, writes the readings there
as JSON lines too. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("parent", "new", "new", "parent") * 2
SHAPES = ((10, 20, 512), (10, 20, 3584), (10, 20, 4096), (10, 20, 8192),
          (10, 20, 16384), (10, 20, 32768), (10, 20, 65536),
          (32, 20, 4096),                    # (width, height, batch)
          # the crossover shapes: NW = 2 and 4, H = 32, NW = 33
          (32, 20, 8192), (32, 20, 16384), (32, 20, 32768), (32, 20, 65536),
          (100, 20, 4096), (100, 20, 16384), (100, 20, 65536),
          (10, 32, 8192), (10, 32, 16384), (10, 32, 65536),
          (1024, 20, 4096), (1024, 20, 16384))


def _state_of(port, state):
    """``state`` as ``port``'s EnvState (the same tensors)."""
    from gym_simpletetris_tpu_torch.core.state import FIELDS
    cls = importlib.import_module(port.__name__ + ".core.state").EnvState
    return cls(**{f: getattr(state, f) for f in FIELDS})


def _same_outputs(ports, cfgs, state, a, r, key, what):
    """Both versions' step on the same inputs: every output bitwise equal."""
    import torch
    from gym_simpletetris_tpu_torch.core.state import FIELDS
    outs = {}
    for k, p in ports.items():
        st = _state_of(p, state)
        o = importlib.import_module(p.__name__ + ".ops.cuda_step").step(
            cfgs[k], st, a, r, key)
        outs[k] = [getattr(o.state, f) for f in FIELDS] + [
            o.emitted_rows, o.reward.view(torch.int32), o.done]
    for x, y in zip(outs["new"], outs["parent"]):
        if not torch.equal(x, y):
            raise RuntimeError(f"new != parent step outputs: {what}")


def _parent_runs(cs, cfg, state, r, key):
    """The parent's step as ``step_device_times`` runs: its wrapper's own
    choice, named by its launch plan where it has one (a tree from before
    the redesign has one instance, a thread per env on global memory)."""
    plan = getattr(cs, "launch_plan", None)
    inst = (plan(cfg.height, cfg.num_words, state.batch_size).instance
            if plan else "thread_global")
    return {inst: lambda a: cs.step(cfg, state, a, r, key)}


def _readings(ports, rng):
    import torch
    from gym_simpletetris_tpu_torch.utils import kernel_timing as kt
    out = []
    for w, h, B in SHAPES:
        cfgs = {k: p.EnvConfig(width=w, height=h) for k, p in ports.items()}
        steps = {k: importlib.import_module(p.__name__ + ".ops.cuda_step")
                 for k, p in ports.items()}
        state, a, r, key = kt.step_inputs(cfgs["new"], B, rng, "cuda")
        states = {k: _state_of(p, state) for k, p in ports.items()}
        for mix, act in (("random", a), ("hard_drop", torch.full_like(a, 2))):
            _same_outputs(ports, cfgs, state, act, r, key,
                          f"{w}x{h} B={B} {mix}")
        for turn, which in enumerate(ORDER):
            cs, cfg, st = steps[which], cfgs[which], states[which]
            t = kt.step_device_times(
                cfg, st, a, r, key, runs=None if which == "new"
                else _parent_runs(cs, cfg, st, r, key))
            wrapper_ms = kt.sync_ms(lambda: cs.step(cfg, st, a, r, key), 200)
            for role, reading in [("step", t["step"])] + [
                    ("other", o) for o in t["others"]]:
                rec = dict(version=which, turn=turn, width=w,
                           height=h, B=B, role=role, **reading,
                           copy_stream_us=t["copy_stream"]["device_us"])
                if role == "step":
                    rec["wrapper_ms"] = wrapper_ms
                out.append(rec)
                print(json.dumps(rec), flush=True)
    return out


def _summary(recs) -> None:
    med = statistics.median
    for w, h, B in SHAPES:
        for key, label in (("device_us", "random actions"),
                           ("hard_drop_device_us", "all hard drops"),
                           ("wrapper_ms", "wrapper ms")):
            line = [f"{w}x{h} B={B} {label}:"]
            meds = {}
            here = [x for x in recs
                    if (x["width"], x["height"], x["B"]) == (w, h, B)
                    and key in x]
            runs = sorted({(x["version"], x["role"], x["instance"])
                           for x in here},
                          key=lambda v: (v[0] != "parent", v[1] != "step", v[2]))
            for which, role, inst in runs:
                v = [x[key] for x in here if (x["version"], x["role"],
                                              x["instance"]) == (which, role, inst)]
                meds[which, role] = med(v)
                share = (f", {100 * here[0]['bound_us'] / med(v):.1f}% of "
                         f"{here[0]['bound_us']:.3f}" if key == "device_us"
                         else "")
                line.append(f"{which} {inst} {[round(u, 4) for u in v]} "
                            f"(median {med(v):.4f}{share})")
            if ("parent", "step") in meds and ("new", "step") in meds:
                ratio = meds["new", "step"] / meds["parent", "step"]
                line.append(f"new/parent {ratio:.3f}")
            print(" ".join(line), flush=True)
        ys = [x["copy_stream_us"] for x in recs
              if (x["width"], x["height"], x["B"]) == (w, h, B)]
        print(f"{w}x{h} B={B} copy_ of the same bytes: median "
              f"{med(ys):.4f} us", flush=True)


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
        print("torch_step_abba: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch_raster_abba import _import_as
    import gym_simpletetris_tpu_torch as new
    parent = _import_as("parent_port", os.path.join(
        os.path.abspath(args.parent), "gym_simpletetris_tpu_torch"))
    ports = {"parent": parent, "new": new}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    recs = _readings(ports, np.random.RandomState(0))
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
