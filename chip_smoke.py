#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gym_simpletetris_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gym_simpletetris_tpu_torch/csrc`` with
nvcc, holds each kernel bitwise against its plain PyTorch version on the card
(single-word boards, and wide boards of 25 to 1024 columns), replays the
golden reference traces through the CUDA path, drives the main path
(``TetrisVectorEnv`` reset / step / rollout with auto_reset at B = 4096 for
ram, grayscale and rgb) on the default 10 x 20 board and on the wide 32 x 20
board, and times the kernels beside their plain versions: wrapper ms by CUDA
events, device us by CUDA events around a CUDA-graph replay of 20
launches, each against its bound (the bytes it must move at the HBM rate;
the raster-accumulate with L2 evicted before each launch, its L2-warm time
beside it), the raster kernels also at 160 and 512 px; 6d holds the
spawn-draw kernel bitwise against the plain draw at B = 4096 (a key chain
at env offsets 0 and 2048, the injected-r path) and times both (device us
by CUDA-graph replay, wrapper us by CUDA events over 200 calls); 6n holds
the noise kernel bitwise against the plain noisy weights at the flagship
Rainbow's three noisy layers and times it likewise; 6r holds the reset
kernel bitwise against the plain reset at B = 4096 and 65,536 (the done
envs of a stepped state, and no mask; threefry and injected draws) and
times it likewise, beside its bound. Phase 2 resets its even lanes that
died with the reset kernel on one side and the plain reset on the other,
both compared. The main path must launch the draw kernel once for every
spawn draw and the reset kernel once for every reset, and every
plain-path run below takes the plain draw and reset too. Then the trainer
path: the lookahead heuristic (kernel A at 7 * B), the greedy evaluation of
the line-clear PPO checkpoint (``artifacts/ppo_lineclear_params.npz``; it
must clear at least 4 lines per episode), and PPO updates through
``run_ppo`` for ram and grayscale, with their kernel launches counted; each
is held bitwise to a run on the plain step and raster (heuristic and PPO
collection whole, the evaluation's first 500 steps), and kernels A and B to
their plain versions at the trainer's batch sizes and env flags. Then the
Rainbow DQN path through ``run_dqn`` (7f ram: PER, 3-step, dueling at the
defaults, 1024 envs and a 262,144-transition ring; 7g grayscale: NatureDQN
with C51, dueling, noisy, 4 stacked frames, 256 envs, a 65,536-transition
ring) and the dqn policy of ``evaluate`` on 7f's checkpoint (7h); one more
chunk of each from its final state is held bitwise to a run on the plain
step and raster with deterministic algorithms on. Then the frame rings and
ES: 7i, the grayscale Rainbow of 7g on the obs ring (``--replay-layout
obs-ring``), a chunk held bitwise to the plain step and raster and one chunk
with ``--sample-slots``; 7j, the single-frame frame ring at the same point
with uniform sampling, and the actor stream of the three layouts held equal
for 32 steps with learning off; 7k, ES on ram at the JAX package's defaults
(pop 256 x 4 envs, horizon 256, RamDQN 64 / 64) through ``run_es`` for 2
generations, one generation held bitwise to a run on the plain step; 7l, the
es policy of ``evaluate`` on 7k's checkpoint, bitwise with the kernels and
with the plain step. Then the user-facing surfaces, each held bitwise to a
run on the plain step and raster that must launch no kernel: 8a, the gym
shim ``make("SimpleTetris-v0")`` at B = 1 on 10 x 20 for ram, grayscale, rgb
and grayscale with extend_dims (300 actions each, out-of-range ones
included), its renders at 160 and 512 px against the host raster; 8b, the
shim on 8 random configurations (widths 4-16, heights 5-24, every flag);
8c, the standalone ``TetrisEngine`` (500 steps, the board setter); 8d, the
gymnasium vector adapter's core with next-step autoreset (ram 4096 envs x
200 steps, grayscale 1024 x 100); 8e, the port's host C++
``NativeTetrisEnv`` (built with g++) against the shim on the card, on the
same spawn draws; 8f, ``record_episode`` at 160 px. Then the data-parallel
layer (phase 9, last; the process group is destroyed before the last line):
9a, at world 1 over NCCL (a TCP store on 127.0.0.1), ``ShardedTetrisEnv``
at B = 4096 (ram and grayscale: reset, 64 steps, a 256-step storage
rollout) against ``TetrisVectorEnv`` and the plain path, ``global_metrics``
against the unsharded sums, and ``shard_map_step`` against the plain step
with the key folded by 0; 9b, two ranks on the one card over gloo (spawned,
2048 envs each, 64 steps) concatenated against 9a, and gloo's collectives
on CUDA tensors; 9c, the mesh branches of the DQN (7f), obs-ring Rainbow
(7i, 32 steps), PPO (ram 1024 x 64) and ES (defaults) trainers at world 1
against the unsharded trainers and the plain path, and a world-1
checkpoint against the unsharded file; 9d, ``collective_bench`` and
``scaling_bench`` (for information); 9e, ``graft_entry.entry()`` and
``dryrun_multichip(1)`` over NCCL. Then tensor parallelism over the
``model`` mesh axis (phase 10; gloo on the one card, not NCCL across
cards): 10a, two ranks at (data, model) = (1, 2) (spawned, cuda:0 each)
run 9c's DQN 7f (48 steps), obs-ring Rainbow 7i (32 steps) and PPO ram
update at full width, with deterministic algorithms on, held to 9c's
unsharded runs: env rows, actions, dones, the ring and the obs bitwise
(a divergence passes only where the sharded forward on the same
parameters is not bitwise on the card, or after the learner ran, and is
printed with its first slot and the forward's largest difference), the
learned floats and metrics of 7f and PPO within rtol 2e-4, atol 2e-6, the
obs-ring Rainbow's printed; a 7f chunk at (1, 2) bitwise on the plain
step; 10c, the 7f state saved at (1, 2) and restored unsharded in this
process continues 8 steps with its integer state bitwise and its floats
within that tolerance; 10b, ``dryrun_multichip(4)`` over gloo on the card:
(4, 1), (2, 2) and (1, 4). Kernels A and B must launch in each 10a rank.
Then phase 11: 11a, the sharded learner above one rank (gradients summed
in float32 at the layers' cast points, then rounded once): two ranks at
(data, model) = (2, 1) over gloo on the one card run 9c's four trainers
(7f, the obs-ring Rainbow, PPO ram, ES), each rank half of every batch,
held to 9c's unsharded runs: the gathered state bitwise up to each DQN's
first learner update, PPO's collection and ES theta bitwise; the learned
floats' distance (against the CPU tests' rtol 2e-4, atol 2e-6), the first
divergence after the first update, s a step and the gradient
``all_reduce``s a learner step are printed; 11b,
``tools/torch_soak_fuzz.py`` in this process: 16 random configurations
(widths to 56, heights to 64, lock delays to 8, every flag, six action
scripts) x 256 envs x 512 steps through every instance of kernel A each
board admits, and kernel B's images of 4 configurations at 84 px and 2 at
512 px, all bitwise against the port's C++ oracle and its host raster.
Then phase 13, ``tools/torch_soak_shim.py`` in this process: 12 random
shim configurations (widths 4-16, heights 5-24, every flag and obs type)
x 300 steps (75 for image observations), the gym shim on the card (kernel
A at B = 1, kernel B for each image observation and the 160 px renders)
and ``TetrisEngine`` on the card (its attribute surface too) each against
the port's C++ engine and host raster, and ``NativeTetrisEnv`` against the
shim on the CPU plain path, on the same spawn draws: obs, reward, done and
info at every step. One line per phase;
then a JSON line of the
kernels, the card's name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure, or no CUDA device, exits nonzero without that line. Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B_MAIN = 4096
STEPS = 256
CHECK_STEPS = 160   # phase 2's steps per flag set (cut from 256 for time)
FLAG_SETS = (
    dict(),
    dict(reward_step=True, advanced_clears=True, penalise_height=True,
         penalise_holes=True),
    dict(high_scoring=True, penalise_height_increase=True,
         penalise_holes_increase=True, lock_delay=2, step_reset=True),
    dict(width=9, height=12, lock_delay=3),
    dict(width=24, reward_step=True, penalise_holes_increase=True),  # bit 31
    # the warp instance's edge (a lane per row, anchor 32 by a second
    # ballot) and the thread-per-env instance that takes H > 32
    dict(height=32, advanced_clears=True, penalise_holes=True),
    dict(height=40, penalise_height_increase=True, lock_delay=1),
)
# Other action mixes: every env hard-drops (every step locks), and pieces
# pushed against both walls; and batches around a warp's and a tile's edges.
MIX_CASES = (("hard", dict(), (B_MAIN, 1000)),
             ("walls", dict(width=9, height=12), (B_MAIN, 1000)),
             ("random", dict(height=32), (1, 31, 33)))
MIX_STEPS = 64
# Every instance of kernel A, forced, on one step: the rollout's batch and
# the largest timed one on 10 x 20, a tall board; wide boards below.
INSTANCE_CASES = ((dict(penalise_holes=True), (B_MAIN, 65536)),
                  (dict(height=40, penalise_height_increase=True), (B_MAIN,)))
WIDE_INSTANCE_CASES = ((dict(width=32, advanced_clears=True), (B_MAIN,)),
                       (dict(width=100, height=31), (1000,)))
# Kernel A's timed batches on the 10 x 20 board: evaluation, the
# heuristic's lookahead at 7 * 512, the rollout, the JAX package's ram
# record batch and the largest; the 32 x 20 board at the rollout's.
STEP_TIMED_B = (512, 3584, B_MAIN, 16384, 65536)
# Wide boards (multi-word rows): (flags, batch sizes). NW = 2, 2, 2, 3, 4, 33,
# 33.
WIDE_STEPS = 128
WIDE_CASES = (
    (dict(width=25, advanced_clears=True, penalise_height=True,
          penalise_holes=True), (B_MAIN, 1000)),
    (dict(width=32, high_scoring=True, penalise_height_increase=True,
          penalise_holes_increase=True, lock_delay=2, step_reset=True),
     (B_MAIN, 1000)),
    (dict(width=40, reward_step=True, lock_delay=1), (B_MAIN, 1000)),
    (dict(width=57, height=12, penalise_height=True), (B_MAIN, 1000)),
    (dict(width=100, advanced_clears=True), (B_MAIN, 1000)),
    (dict(width=1024, height=6, penalise_height_increase=True), (64,)),
    # past the staged thread instance's tile: the global thread instance
    (dict(width=1024, height=40, penalise_height=True), (64,)),
)
# The JAX package's wide-board throughput configuration
# (tests/test_perf_floor.py:85): the second main path.
WIDE_MAIN = dict(width=32, height=20)
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_traces.json")
PPO_GRAY_B = 256            # grayscale PPO's batch (PPO_GRAY below)


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def _import_port():
    sys.path.insert(0, ROOT)
    import gym_simpletetris_tpu_torch as port
    if not os.path.abspath(port.__file__).startswith(ROOT + os.sep):
        raise PhaseError(f"imported the port from {port.__file__}, not {ROOT}")
    return port


def _fmt_device(times: dict) -> str:
    """Device us by kernel, each with its bound and share where it has one
    (C: L2 evicted before each launch), and C's L2-warm time beside it."""
    def one(k, v):
        s = f"{k} {v['device_us']:.2f} us"
        if "bound_us" in v:
            s += f" (bound {v['bound_us']:.2f}, {100 * v['bound_share']:.1f}%"
            if "l2_warm_device_us" in v:
                s += (f", L2 evicted; {v['l2_warm_device_us']:.2f} us with acc"
                      " warm in L2, which no HBM bound holds")
            s += ")"
        return s
    return ", ".join(one(k, v) for k, v in times.items())


# ------------------------------------------------------------------- phases

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    from gym_simpletetris_tpu_torch.ops import _build
    info = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "stack frame" in ln
            or "Compiling entry" in ln]
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; kernels built in "
        f"{info['seconds']:.2f} s ({info['path'].name}); ptxas: {regs}")
    return card


def _diff(a, b):
    """(any difference, max |a - b|) as device tensors, bitwise for floats."""
    import torch
    if a.dtype == torch.float32:
        return (a.view(torch.int32) != b.view(torch.int32)).any(), \
            (a - b).abs().max()
    ai, bi = a.to(torch.int64), b.to(torch.int64)
    return (ai != bi).any(), (ai - bi).abs().max().to(torch.float32)


def _check_step_kernel(cases, steps, seed0, mix="random"):
    """Each (flags, batch sizes) case: ``steps`` steps of the step kernel and
    of the plain step from the same prefilled state, every field compared,
    with actions of ``mix`` (``kernel_timing.mix_actions``); after each step
    the envs of even lanes that died reset, the reset kernel's state and
    rows compared with the plain reset's (``apply_reset_mask_plain``, its
    plain draw too). Returns
    (max_abs_err, comparisons, {(cfg, B): last emitted rows})."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.api.env import (
        apply_reset_mask, apply_reset_mask_plain)
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.core.state import FIELDS
    from gym_simpletetris_tpu_torch.ops import cuda_step
    from gym_simpletetris_tpu_torch.utils.kernel_timing import (
        mix_actions, prefilled_state)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_err, n_cmp, last = 0.0, 0, {}
    for fi, (flags, batches) in enumerate(cases):
        cfg = EnvConfig(**flags)
        for B in batches:
            rng = np.random.RandomState(seed0 + 1000 * fi + B)
            s_k = s_p = prefilled_state(cfg, B, rng, dev)
            even = torch.arange(B, device=dev) % 2 == 0
            bad, errs = [], []
            n_done = torch.zeros((), dtype=torch.int64, device=dev)
            n_lines = torch.zeros((), dtype=torch.int64, device=dev)
            for t in range(steps):
                a = torch.as_tensor(mix_actions(mix, B, rng), device=dev)
                r = torch.as_tensor(rng.randint(1, 36, B), device=dev)
                o_k = E.engine_step(cfg, s_k, a, injected_r=r)
                o_p = E.engine_step_plain(cfg, s_p, a, injected_r=r)
                n_done += o_k.done.sum()
                n_lines += (o_k.state.lines_cleared
                            - s_k.lines_cleared).sum()
                # odd lanes step on past death; even lanes start a new
                # episode: the reset kernel against the plain reset
                mask = o_k.done & even
                s_k, e_k = apply_reset_mask(cfg, o_k.state, o_k.emitted_rows,
                                            mask)
                s_p, e_p = apply_reset_mask_plain(
                    cfg, o_p.state, o_p.emitted_rows, mask)
                pairs = [(getattr(o_k.state, f), getattr(o_p.state, f))
                         for f in FIELDS] + [
                    (o_k.emitted_rows, o_p.emitted_rows),
                    (o_k.reward, o_p.reward), (o_k.done, o_p.done)] + [
                    (getattr(s_k, f), getattr(s_p, f)) for f in FIELDS] + [
                    (e_k, e_p)]
                d = [_diff(x, y) for x, y in pairs]
                bad.append(torch.stack([x for x, _ in d]))
                errs.append(torch.stack([e for _, e in d]).max())
            bad = torch.stack(bad).cpu().numpy()
            max_err = max(max_err, float(torch.stack(errs).max()))
            n_cmp += bad.size
            if bad.any():
                t, f = np.argwhere(bad)[0]
                names = list(FIELDS) + ["emitted", "reward", "done"] + [
                    "reset " + f for f in FIELDS] + ["reset emitted"]
                raise PhaseError(
                    f"step or reset kernel != plain: {flags} B={B} first at "
                    f"step {t}, field {names[f]}")
            last[cfg, B] = o_k.emitted_rows
            inst = cuda_step.launch_plan(cfg.height, cfg.num_words, B,
                                         sms).instance
            log(f"  step kernel == plain: {flags or 'default'} B={B} "
                f"NW={cfg.num_words} ({inst} instance, {mix} actions): "
                f"{steps} steps, {int(n_done)} done flags, {int(n_lines)} "
                "lines")
    return max_err, n_cmp, last


def _check_instances(cases, seed):
    """Each (flags, batch sizes) case: every instance of kernel A the board
    takes (``cuda_step.instances_for``), forced, against the plain
    transition on the same inputs (``kernel_timing.step_inputs``), for
    random actions and for all hard drops. Returns (max_abs_err,
    comparisons)."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.core.engine import transition_plain
    from gym_simpletetris_tpu_torch.core.state import FIELDS
    from gym_simpletetris_tpu_torch.ops import cuda_step
    from gym_simpletetris_tpu_torch.utils.kernel_timing import step_inputs
    rng = np.random.RandomState(seed)
    max_err, n_cmp = 0.0, 0
    for flags, batches in cases:
        cfg = EnvConfig(**flags)
        names = cuda_step.instances_for(cfg.height, cfg.num_words)
        for B in batches:
            s, a, r, key = step_inputs(cfg, B, rng, "cuda")
            for mix, act in (("random", a), ("hard", torch.full_like(a, 2))):
                want = transition_plain(cfg, s, act, r, key)
                for inst in names:
                    got = cuda_step._launch(cfg, s, act, r, key, inst)
                    d = [_diff(getattr(got.state, f), getattr(want.state, f))
                         for f in FIELDS] + [
                        _diff(x, y) for x, y in (
                            (got.emitted_rows, want.emitted_rows),
                            (got.reward, want.reward), (got.done, want.done))]
                    n_cmp += len(d)
                    max_err = max(max_err, float(torch.stack(
                        [e for _, e in d]).max()))
                    if bool(torch.stack([x for x, _ in d]).any()):
                        raise PhaseError(f"step kernel instance {inst} != "
                                         f"plain: {flags} B={B}, {mix}")
            log(f"  every instance {list(names)} == plain: "
                f"{flags or 'default'} B={B}, random actions and all hard "
                "drops")
    return max_err, n_cmp


def phase_step_kernel():
    from gym_simpletetris_tpu_torch import EnvConfig
    cases = [(flags, (B_MAIN, 1000)) for flags in FLAG_SETS]
    max_err, n_cmp, last = _check_step_kernel(cases, CHECK_STEPS, 0)
    for k, (mix, flags, batches) in enumerate(MIX_CASES):
        e, n, _ = _check_step_kernel([(flags, batches)], MIX_STEPS,
                                     300 + k, mix)
        max_err, n_cmp = max(max_err, e), n_cmp + n
    e, n = _check_instances(INSTANCE_CASES, 400)
    max_err, n_cmp = max(max_err, e), n_cmp + n
    log(f"phase 2 step kernel: bitwise equal to the plain step in {n_cmp} "
        f"field comparisons (max_abs_err {max_err}), heights "
        f"{sorted({EnvConfig(**f).height for f in FLAG_SETS})}, action "
        f"mixes {[m for m, _, _ in MIX_CASES]}, every instance at "
        f"{[(f, b) for f, b in INSTANCE_CASES]}")
    return max_err, last[EnvConfig(), B_MAIN]


def phase_wide_step_kernel():
    max_err, n_cmp, last = _check_step_kernel(WIDE_CASES, WIDE_STEPS, 500)
    e, n = _check_instances(WIDE_INSTANCE_CASES, 600)
    max_err, n_cmp = max(max_err, e), n_cmp + n
    log(f"phase 2w wide step kernel: bitwise equal to the plain step at "
        f"widths {[f['width'] for f, _ in WIDE_CASES]} in {n_cmp} field "
        f"comparisons (max_abs_err {max_err}), every instance at "
        f"{list(WIDE_INSTANCE_CASES)}")
    return max_err, last


def _random_rows(cfg, B, rng):
    """Random words in the state layout of ``cfg`` (guard bits set too)."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch.core.state import rows_shape
    words = rng.randint(0, 2 ** 32, rows_shape(cfg, B),
                        dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)).to("cuda")


def _check_raster(cases, rng):
    """Each (cfg, rows, size, what): the raster kernel against the plain
    raster, and three in-place folds of the raster-accumulate kernel into a
    random accumulator (every pixel value wraps) against the plain folds.
    Returns the max abs errors by kernel; raises on any difference."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch.ops import cuda_raster, raster
    err = {"raster": 0.0, "raster_accumulate": 0.0}
    for cfg, rows, size, what in cases:
        got = cuda_raster.rasterize_rows(cfg, rows, size)
        want = raster.rasterize_rows_plain(cfg, rows, size)
        e = (got.int() - want.int()).abs().max().item()
        err["raster"] = max(err["raster"], e)
        if e:
            raise PhaseError(f"raster kernel != plain: {what} at {size}px")
        acc = torch.as_tensor(rng.randint(0, 256, got.shape, dtype=np.uint8),
                              device=rows.device)
        acc_k, acc_p = acc.clone(), acc.clone()
        for _ in range(3):
            cuda_raster.raster_accumulate(cfg, rows, acc_k, size)
            raster.raster_accumulate_plain(cfg, rows, acc_p, size)
        e = (acc_k.int() - acc_p.int()).abs().max().item()
        err["raster_accumulate"] = max(err["raster_accumulate"], e)
        if e:
            raise PhaseError(
                f"raster-accumulate kernel != plain: {what} at {size}px")
    return err


def _check_offset_views(cases, rng):
    """Each (cfg, rows, size): kernels B and C into an image tensor that is a
    view at a 4-, 8- and 12-byte offset of its buffer (4- but not 16-byte
    aligned), bitwise equal to the plain versions, with no byte outside the
    view written. Returns the largest difference (0)."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch.ops import cuda_raster, raster
    for cfg, rows, size in cases:
        B = rows.shape[-1]
        n = B * size * size
        want = raster.rasterize_rows_plain(cfg, rows, size)
        for off in (4, 8, 12):
            buf = torch.full((n + 16,), 77, dtype=torch.uint8,
                             device=rows.device)
            img = buf[off:off + n].view(B, size, size)
            cuda_raster._launch(cfg, rows, img, size, accumulate=False)
            same = torch.equal(img, want)
            acc0 = torch.as_tensor(
                rng.randint(0, 256, (B, size, size), dtype=np.uint8),
                device=rows.device)
            img.copy_(acc0)
            cuda_raster.raster_accumulate(cfg, rows, img, size)
            same = same and torch.equal(img, acc0 + want)
            if not same or (buf[:off] != 77).any() or (buf[off + n:] != 77).any():
                raise PhaseError(
                    f"raster kernels into a view at offset {off}: "
                    f"{cfg.width}x{cfg.height} B={B} {size}px differs or "
                    "wrote outside the view")
    return 0.0


def phase_raster_kernels(board_rows):
    import numpy as np
    from gym_simpletetris_tpu_torch import EnvConfig
    rng = np.random.RandomState(7)
    sets = [(EnvConfig(), board_rows, "phase-2 boards")]
    for w, h in ((10, 20), (9, 12), (4, 5), (24, 20)):
        cfg = EnvConfig(width=w, height=h)
        sets.append((cfg, _random_rows(cfg, B_MAIN, rng), f"random {w}x{h}"))
    # grayscale PPO's batch, and an odd batch whose images do not end on a
    # 4- or 16-byte boundary (83 px)
    cfg, small = EnvConfig(), EnvConfig(width=4, height=5)
    extra = [(cfg, _random_rows(cfg, PPO_GRAY_B, rng), 84,
              f"random 10x20 B={PPO_GRAY_B}"),
             (cfg, _random_rows(cfg, PPO_GRAY_B, rng), 83,
              f"random 10x20 B={PPO_GRAY_B}"),
             (small, _random_rows(small, 3, rng), 83, "random 4x5 B=3")]
    err = _check_raster([(cfg, rows, 84, what) for cfg, rows, what in sets]
                        + [(EnvConfig(), board_rows, 160, "phase-2 boards")]
                        + extra, rng)
    _check_offset_views([(EnvConfig(), board_rows, 84),
                         (small, extra[2][1], 83)], rng)
    log(f"phase 3 raster kernels: bitwise equal to the plain raster and "
        f"raster-accumulate on {len(sets)} board sets at B={B_MAIN}, 84 px "
        f"(and 160 px on the phase-2 boards), at B={PPO_GRAY_B} (84 and "
        f"83 px) and B=3 (83 px), and into image views at 4-, 8- and 12-byte "
        f"offsets (B={B_MAIN} 84 px, B=3 83 px)")
    return err


def phase_wide_raster_kernels(wide_boards):
    """Kernels B and C on word-form rows: the wide step phase's boards and
    random words at 84 px (an image fits up to 41 columns there), and the
    render-fuzz wide geometries w40/h26 and w57/h6 at 512 px."""
    import numpy as np
    from gym_simpletetris_tpu_torch import EnvConfig
    rng = np.random.RandomState(8)
    cases = [(cfg, rows, 84, f"phase-2w boards {cfg.width}x{cfg.height}")
             for (cfg, B), rows in wide_boards.items()
             if B == B_MAIN and cfg.width <= 41]
    for w, h, size, B in ((25, 8, 84, B_MAIN), (41, 20, 84, B_MAIN),
                          (40, 26, 84, B_MAIN), (40, 26, 512, 1024),
                          (57, 6, 512, 1024), (33, 14, 160, 1000)):
        cfg = EnvConfig(width=w, height=h)
        cases.append((cfg, _random_rows(cfg, B, rng), size,
                      f"random {w}x{h} B={B}"))
    cfg = EnvConfig(**WIDE_MAIN)
    cases.append((cfg, _random_rows(cfg, PPO_GRAY_B, rng), 84,
                  f"random 32x20 B={PPO_GRAY_B}"))
    err = _check_raster(cases, rng)
    by_what = {(what, size): (c, rows) for c, rows, size, what in cases}
    _check_offset_views(
        [by_what["phase-2w boards 32x20", 84] + (84,),
         by_what["random 40x26 B=1024", 512] + (512,)], rng)
    log(f"phase 3w wide raster kernels: bitwise equal to the plain raster "
        f"and raster-accumulate on {len(cases)} word-form board sets "
        f"({', '.join(what + f' {size}px' for _, _, size, what in cases)}), "
        "and into image views at 4-, 8- and 12-byte offsets (32x20 84 px, "
        "40x26 512 px)")
    return err


def _board_hash(board) -> str:
    import numpy as np
    bits = (np.asarray(board) != 0).astype(np.uint8)
    return hashlib.sha256(bits.tobytes()).hexdigest()[:16]


def phase_golden():
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.core.pieces import PIECE_NAMES
    from gym_simpletetris_tpu_torch.core.state import init_state
    from gym_simpletetris_tpu_torch.ops.bitops import unpack_board
    dev = torch.device("cuda")
    lanes = 128
    with open(GOLDEN) as f:
        traces = json.load(f)
    n_steps = 0
    for tr in traces:
        cfg = EnvConfig(width=tr["width"], height=tr["height"], **tr["flags"])
        full = lambda v: torch.full((lanes,), v, dtype=torch.int32, device=dev)
        resets = list(tr["resets"])
        s = init_state(cfg, lanes, 0, dev)
        s, _ = E.engine_clear(cfg, s, injected_r=full(resets.pop(0)))
        for t, st in enumerate(tr["steps"]):
            r = st["r"] if st["r"] is not None else 0
            out = E.engine_step(cfg, s, full(st["action"]), injected_r=full(r))
            s = out.state
            boards = unpack_board(cfg, out.emitted_rows, torch.uint8).cpu().numpy()
            got = dict(
                board=_board_hash(boards[0]), reward=float(out.reward[0]),
                done=bool(out.done[0]), score=int(s.score[0]),
                lines=int(s.lines_cleared[0]), holes=int(s.holes[0]),
                deaths=int(s.deaths[0]), piece=PIECE_NAMES[int(s.piece[0])])
            want = {k: st[k] for k in got}
            lanes_same = (boards == boards[:1]).all() and all(
                bool((x == x[0]).all()) for x in (
                    out.reward, out.done, s.score, s.lines_cleared, s.holes,
                    s.deaths, s.piece))
            if got != want or not lanes_same:
                raise PhaseError(f"golden trace {tr['name']} step {t}: got "
                                 f"{got}, want {want}, lanes same {lanes_same}")
            if got["done"]:
                s, _ = E.engine_clear(cfg, s, injected_r=full(resets.pop(0)))
            n_steps += 1
    log(f"phase 4 golden traces: {len(traces)} traces, {n_steps} steps x "
        f"{lanes} lanes through the CUDA step kernel match the reference")


# the kernel launch counters of utils/profiling.py, by the names printed here
_COUNTERS = {"step": "kernel.step.launches",
             "raster": "kernel.raster.launches",
             "raster_accumulate": "kernel.raster_acc.launches",
             "draw": "kernel.draw.launches",
             "noise": "kernel.noise.launches",
             "reset": "kernel.reset.launches"}


def _reset_counters() -> None:
    from gym_simpletetris_tpu_torch.utils import profiling
    profiling.reset()


def phase_main_path(board: dict, label: str):
    """The main path on ``board`` (EnvConfig width / height): reset, 64
    steps and a T-step rollout for each obs type, the rollout held to the
    same steps taken one at a time. The kernel counts are set to 0 just
    before and read just after; each kernel of the env's path must have
    launched, the draw kernel once for every spawn draw and the reset
    kernel once for every reset and auto-reset step."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
    dev = torch.device("cuda")
    _reset_counters()
    envs = {}
    for o in ("ram", "grayscale", "rgb"):
        cfg = EnvConfig(obs_type=o, auto_reset=True, **board)
        env = TetrisVectorEnv(cfg, B_MAIN, device="cuda")
        rng = np.random.RandomState(11)
        obs, s = env.reset(0)
        for _ in range(64):
            a = torch.as_tensor(rng.randint(0, 7, B_MAIN), device=dev)
            obs, s, reward, done, info = env.step(s, a)
        acts = torch.as_tensor(rng.randint(0, 7, (STEPS, B_MAIN)), device=dev)
        final, acc, rew, don = env.rollout(s, acts)
        # the same steps one at a time, folding the delivered observation
        acc2 = torch.zeros_like(acc)
        s2, rews, dones = s, [], []
        for a in acts:
            obs, s2, reward, done, info = env.step(s2, a)
            acc2 += (obs[..., 0] if o == "rgb" else obs).to(torch.uint8)
            rews.append(reward)
            dones.append(done)
        shape = env.observation_space.shape
        if tuple(obs.shape) != (B_MAIN,) + shape or not torch.isfinite(obs).all():
            raise PhaseError(f"{o}: bad observation {tuple(obs.shape)}")
        allowed = torch.tensor([0, 1] if o == "ram" else [0, 128, 190],
                               dtype=obs.dtype, device=dev)
        if not torch.isin(obs, allowed).all():
            raise PhaseError(f"{o}: observation values outside {allowed.tolist()}")
        same = (torch.equal(acc, acc2) and torch.equal(rew, torch.stack(rews))
                and torch.equal(don, torch.stack(dones))
                and torch.equal(final.rows, s2.rows)
                and torch.equal(final.key, s2.key))
        if not same:
            raise PhaseError(f"{o}: rollout != step loop")
        if not torch.isfinite(rew).all() or int(don.sum()) == 0:
            raise PhaseError(f"{o}: rewards not finite or no episode ended")
        envs[o] = (env, s, acts)
        log(f"  main path {o} {cfg.width}x{cfg.height}: reset + 64 steps + "
            f"rollout T={STEPS} at B={B_MAIN}; rollout == step loop; "
            f"{int(don.sum())} episodes ended, mean reward "
            f"{float(rew.mean()):.4f}")
    torch.cuda.synchronize()
    launches = _launches()
    for k, n in launches.items():
        if n <= 0 and k != "noise":      # the env path has no noisy layer
            raise PhaseError(f"kernel {k} was not launched on the main path "
                             f"{board or 'default'}")
    from gym_simpletetris_tpu_torch.utils import profiling
    draws = profiling.counters()["engine.draws"]
    if launches["draw"] != draws:
        raise PhaseError(f"{launches['draw']} draw kernel launches for "
                         f"{draws} spawn draws on the main path")
    # a reset, 64 steps, the rollout and the step loop, each obs type
    resets = len(envs) * (1 + 64 + 2 * STEPS)
    if launches["reset"] != resets:
        raise PhaseError(f"{launches['reset']} reset kernel launches for "
                         f"{resets} resets on the main path")
    log(f"{label}: kernel launches {launches}")
    return launches, envs


def phase_timing(envs, board: dict, label: str, extra=(),
                 step_batches=(B_MAIN,)):
    """For information only: env-steps/s of the rollout and each kernel's
    time at B = 4096 on ``board``: wrapper ms (CUDA events, Python and
    ctypes included) beside its plain version's, and device us
    (CUDA-graph replay) beside its bound, C with L2 evicted
    (``kernel_timing.raster_device_times``), A for two action mixes and
    at each of ``step_batches``, with the instance that ran
    (``kernel_timing.step_device_times``). ``extra``: more
    (cfg, rows, size) at which to time the raster kernels' device us."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.ops import cuda_raster, cuda_step, raster
    from gym_simpletetris_tpu_torch.utils import kernel_timing as kt
    rates = {}
    for o, (env, s, acts) in envs.items():
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            env.rollout(s, acts)
            torch.cuda.synchronize()
            runs.append(B_MAIN * acts.shape[0] / (time.perf_counter() - t0))
        rates[o] = sorted(runs)
    cfg = EnvConfig(**board)
    env, s, acts = envs["grayscale"]
    key, r = E.spawn_draw(s, None)
    a = acts[0].to(torch.int32).contiguous()
    out = E.transition_plain(cfg, s, a, r, key)
    rows = out.emitted_rows
    acc = torch.zeros((B_MAIN, 84, 84), dtype=torch.uint8, device=rows.device)
    ms = {
        "step": (kt.sync_ms(lambda: cuda_step.step(cfg, s, a, r, key), 200),
                 kt.sync_ms(lambda: E.transition_plain(cfg, s, a, r, key), 50)),
        "raster": (kt.sync_ms(lambda: cuda_raster.rasterize_rows(cfg, rows), 200),
                   kt.sync_ms(lambda: raster.rasterize_rows_plain(cfg, rows), 50)),
        "raster_accumulate": (
            kt.sync_ms(lambda: cuda_raster.raster_accumulate(cfg, rows, acc), 200),
            kt.sync_ms(lambda: raster.raster_accumulate_plain(cfg, rows, acc), 50)),
    }
    step_times = []
    rng = np.random.RandomState(13)
    for B in step_batches:
        inputs = ((s, a, r, key) if B == B_MAIN
                  else kt.step_inputs(cfg, B, rng, s.device))
        t = kt.step_device_times(cfg, *inputs)
        step_times.append(_step_reading(B, t))
    dev = {"step": dict(next(t for t in step_times if t["B"] == B_MAIN),
                        device_times=step_times)}
    dev.update(kt.raster_device_times(cfg, rows, 84))
    log(f"{label} (information only, {cfg.width}x{cfg.height}, B={B_MAIN}, "
        f"T={STEPS}): "
        "env-steps/s of the rollout, 3 runs sorted: "
        + ", ".join(f"{o} {[round(v) for v in r]}" for o, r in rates.items())
        + "; kernel wrapper ms "
        + ", ".join(f"{k} {a:.5f} (plain {p:.5f})" for k, (a, p) in ms.items())
        + f"; device at 84 px: {_fmt_device(dev)}")
    for t in step_times:
        log(f"  {label}, step kernel A at B={t['B']}, {cfg.width}x"
            f"{cfg.height}: {t['instance']} {t['device_us']:.2f} us (bound "
            f"{t['bound_us']:.2f} us, {100 * t['bound_share']:.1f}%), all "
            f"hard drops {t['hard_drop_device_us']:.2f} us"
            + "".join(f"; {o['instance']} instance {o['device_us']:.2f} us, "
                      f"all hard drops {o['hard_drop_device_us']:.2f} us"
                      for o in t["others"])
            + f"; copy_ of the same bytes {t['copy_stream_us']:.2f} us")
    for xcfg, xrows, size in extra:
        log(f"  {label}, raster kernels at {size} px, {xcfg.width}x"
            f"{xcfg.height}, B={xrows.shape[-1]}: "
            + _fmt_device(kt.raster_device_times(xcfg, xrows, size)))
    return rates, ms, dev


def _step_reading(B, t):
    """``kernel_timing.step_device_times`` as one record: the plan's
    instance, the others as (instance, device_us, hard_drop_device_us)."""
    return dict(B=B, **t["step"], copy_stream_us=t["copy_stream"]["device_us"],
                others=[{k: o[k] for k in ("instance", "device_us",
                                           "hard_drop_device_us")}
                        for o in t["others"]])


def phase_draw_kernel():
    """6d: the spawn-draw kernel (``csrc/draw.cu``) against the plain draw
    (``threefry.split`` and ``draw_spawn_r``) at B = 4096: a 64-draw key
    chain at env offsets 0 and 2048 and the injected-r path (the key
    alone), bitwise. Then, for information, its device us by CUDA-graph
    replay and its wrapper us by CUDA events over 200 calls, beside the
    plain draw's. Returns the readings."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch.core import threefry
    from gym_simpletetris_tpu_torch.core.state import _key_tensor
    from gym_simpletetris_tpu_torch.ops import cuda_draw
    from gym_simpletetris_tpu_torch.utils import kernel_timing as kt
    dev = torch.device("cuda")
    rng = np.random.RandomState(17)

    def plain(key, counts, offset=0):
        carry, draw_key = threefry.split(key)
        return carry, threefry.draw_spawn_r(draw_key, counts, offset)

    n_cmp = 0
    for offset in (0, 2048):
        counts = torch.as_tensor(
            rng.randint(0, 400, (7, B_MAIN)).astype(np.int32), device=dev)
        key = key_p = _key_tensor(np.array([0x80000000, 0x7FFFFFFF],
                                           np.uint32), dev)
        for t in range(64):
            key, r = cuda_draw.draw(key, counts, offset)
            key_p, r_p = plain(key_p, counts, offset)
            inj_key, inj_r = cuda_draw.draw(key_p, counts, offset, r_p)
            if not (torch.equal(key, key_p) and torch.equal(r, r_p)
                    and torch.equal(inj_key, threefry.split(key_p)[0])
                    and torch.equal(inj_r, r_p)):
                raise PhaseError(f"draw kernel != plain draw at offset "
                                 f"{offset}, draw {t}")
            n_cmp += 1
    got = dict(
        comparisons=n_cmp,
        device_us=kt.device_us(lambda: cuda_draw.draw(key, counts)),
        wrapper_us=1e3 * kt.sync_ms(lambda: cuda_draw.draw(key, counts), 200),
        plain_device_us=kt.device_us(lambda: plain(key, counts)),
        plain_wrapper_us=1e3 * kt.sync_ms(lambda: plain(key, counts), 200))
    log(f"phase 6d draw kernel: {n_cmp} draws at B={B_MAIN} (offsets 0 and "
        f"2048, with and without injected r) equal to the plain draw; "
        f"device {got['device_us']:.2f} us (plain "
        f"{got['plain_device_us']:.2f} us), wrapper {got['wrapper_us']:.2f} "
        f"us (plain {got['plain_wrapper_us']:.2f} us) a draw")
    return got


RESET_TIMED_B = (B_MAIN, 65536)


def phase_reset_kernel():
    """6r: the reset kernel (``csrc/reset.cu``) at B = 4096 and 65,536 on
    10 x 20, on a state after 8 random steps: with the steps' done envs as
    the mask (a rollout's auto-reset), threefry and injected draws, and
    with no mask (``engine_clear``), bitwise against the plain reset. Then,
    for information, its device us by CUDA-graph replay, with L2 evicted
    (held to its bound, ``kernel_timing.reset_bytes``) and warm, and the
    wrapper us of ``apply_reset_mask`` (the draw and the kernel) by CUDA
    events over 200 calls, beside the reset it replaced on the main path
    (the draw kernel, then the plain clear and select). Returns the
    readings by B."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.api import env as api_env
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.core.state import FIELDS
    from gym_simpletetris_tpu_torch.ops import cuda_reset
    from gym_simpletetris_tpu_torch.utils import kernel_timing as kt
    dev = torch.device("cuda")
    cfg = EnvConfig()
    flush = kt.l2_flush()

    def same(a, b):
        return all(torch.equal(getattr(a[0], f), getattr(b[0], f))
                   for f in FIELDS) and torch.equal(a[1], b[1])

    got = {}
    for B in RESET_TIMED_B:
        rng = np.random.RandomState(23 + B)
        s = kt.prefilled_state(cfg, B, rng, dev)
        for _ in range(8):
            out = E.engine_step(cfg, s, torch.as_tensor(
                rng.randint(0, 7, B), device=dev))
            s = out.state
        em, mask = out.emitted_rows, out.done
        injected = torch.as_tensor(rng.randint(1, 36, B), device=dev)
        for r in (None, injected):
            if not (same(api_env.apply_reset_mask(cfg, s, em, mask, r),
                         api_env.apply_reset_mask_plain(cfg, s, em, mask, r))
                    and same(E.engine_clear(cfg, s, r),
                             E.engine_clear_plain(cfg, s, r))):
                raise PhaseError(f"reset kernel != plain reset at B={B}, "
                                 f"injected r {r is not None}")
        key, r = E.spawn_draw(s)
        masked = lambda: cuda_reset.reset(cfg, s, r, key, em, mask)
        every = lambda: cuda_reset.reset(cfg, s, r, key)

        def replaced():
            k, d = E.spawn_draw(s)
            return api_env._select_reset(mask, *E.clear_plain(cfg, s, d, k),
                                         s, em)

        resets = int(mask.sum())
        got[B] = g = dict(
            resets=resets,
            bound_us=kt.bound_us(kt.reset_bytes(cfg, B, resets)),
            device_us=kt.device_us(masked, flush=flush),
            l2_warm_device_us=kt.device_us(masked),
            every_bound_us=kt.bound_us(kt.reset_bytes(cfg, B, B, False)),
            every_device_us=kt.device_us(every, flush=flush),
            wrapper_us=1e3 * kt.sync_ms(
                lambda: api_env.apply_reset_mask(cfg, s, em, mask), 200),
            replaced_wrapper_us=1e3 * kt.sync_ms(replaced, 200))
        log(f"phase 6r reset kernel at B={B} ({resets} envs reset): equal to "
            f"the plain reset (mask and no mask, threefry and injected "
            f"draws); device {g['device_us']:.2f} us L2 evicted "
            f"({g['l2_warm_device_us']:.2f} warm), bound "
            f"{g['bound_us']:.2f} us ({100 * g['bound_us'] / g['device_us']:.1f}%);"
            f" no mask {g['every_device_us']:.2f} us (bound "
            f"{g['every_bound_us']:.2f} us); apply_reset_mask "
            f"{g['wrapper_us']:.2f} us a call (the draw kernel and the "
            f"plain clear and select it replaced: "
            f"{g['replaced_wrapper_us']:.2f} us)")
    return got


def phase_noise_kernel():
    """6n: the noise kernel (``csrc/noise.cu``) against the plain noisy
    weights (``NoisyDense.noisy_weights_plain``) for the flagship Rainbow's
    three noisy layers (dense 3136 -> 512, value 512 -> 51, advantage 512
    -> 357), bitwise, on 16 keys. Then, for information, each layer's
    device us by CUDA-graph replay (L2 evicted, and warm), its wrapper us
    by CUDA events over 200 calls, and the plain version's wrapper us.
    Returns the readings by layer."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch.core.state import _key_tensor
    from gym_simpletetris_tpu_torch.models import dqn
    from gym_simpletetris_tpu_torch.ops import cuda_noise
    from gym_simpletetris_tpu_torch.utils import kernel_timing as kt
    dev = torch.device("cuda")
    net = dqn.build_q_network("grayscale", (84, 84, 4), dueling=True,
                              num_atoms=51, noisy=True)
    net.reset_parameters(torch.Generator().manual_seed(19))
    net = net.to(dev)
    layers = [m for m in net.modules() if isinstance(m, dqn.NoisyDense)]
    rng = np.random.RandomState(19)
    keys = [_key_tensor(w.astype(np.uint32), dev)
            for w in rng.randint(0, 2 ** 32, (16, 2), dtype=np.uint64)]
    flush = kt.l2_flush()
    got = {}
    for m in layers:
        with torch.no_grad():
            for k in keys:
                a, b = m.noisy_weights(k), m.noisy_weights_plain(k)
                if not all(torch.equal(x.view(torch.int32),
                                       y.view(torch.int32))
                           for x, y in zip(a, b)):
                    raise PhaseError(f"noise kernel != plain noise for "
                                     f"{m.path} under key {k.tolist()}")
            k = keys[0]
            launch = lambda: cuda_noise._launch(
                k, m.fold, m.weight_mu, m.weight_sigma, m.bias_mu,
                m.bias_sigma, 0)
            rows, in_f = m.weight_mu.shape
            got["/".join(m.path)] = r = dict(
                shape=[in_f, m.features],
                bound_us=kt.bound_us(kt.noise_bytes(in_f, m.features, rows)),
                device_us=kt.device_us(launch, flush=flush),
                l2_warm_device_us=kt.device_us(launch),
                wrapper_us=1e3 * kt.sync_ms(lambda: m.noisy_weights(k), 200),
                plain_wrapper_us=1e3 * kt.sync_ms(
                    lambda: m.noisy_weights_plain(k), 20))
        log(f"phase 6n noise kernel {'/'.join(m.path)} {in_f}->{m.features}: "
            f"{len(keys)} keys equal to the plain noise; device "
            f"{r['device_us']:.2f} us L2 evicted ({r['l2_warm_device_us']:.2f}"
            f" warm), bound {r['bound_us']:.2f} us, wrapper "
            f"{r['wrapper_us']:.2f} us (plain {r['plain_wrapper_us']:.1f} us)")
    return got


# ------------------------------------------------------------ trainer path

TRAIN_B = 512
HEUR_STEPS = 200
EVAL_STEPS = 3000
EVAL_CMP_STEPS = 500   # kernel against plain on the evaluation's path
EVAL_JAX_CPU = 5.225     # lines/episode of the JAX package's CPU evaluation
EVAL_FLOOR = 4.0
PARAMS_NPZ = os.path.join(ROOT, "artifacts", "ppo_lineclear_params.npz")
PPO_RAM = ["--num-envs", "1024", "--rollout-len", "64", "--minibatches", "8",
           "--epochs", "2", "--shuffle-block", "64", "--updates", "3"]
PPO_GRAY = ["--obs", "grayscale", "--num-envs", "256", "--rollout-len", "32",
            "--minibatches", "4", "--updates", "1"]
# run_dqn at its defaults (1024 envs, a 262,144-transition ring, batch 1024,
# learning from 4096 transitions, RamDQN 512 / 256) with Rainbow's PER,
# 3-step returns and dueling; and the grayscale Rainbow on NatureDQN
DQN_RAM = ["--prioritized", "--n-step", "3", "--dueling", "--chunk", "16",
           "--total-steps", "48"]
DQN_GRAY = ["--obs", "grayscale", "--num-envs", "256", "--frame-stack", "4",
            "--n-step", "3", "--prioritized", "--distributional", "--dueling",
            "--noisy", "--learn-every", "4", "--buffer", "65536", "--chunk",
            "32", "--total-steps", "64"]
DQN_EVAL_STEPS = 200
# the JAX package's flagship image point on the obs ring (7i), and the
# single-frame frame ring there with uniform sampling (7j)
DQN_OBS_RING = DQN_GRAY + ["--replay-layout", "obs-ring"]
DQN_FRAME_RING = [a for a in DQN_GRAY if a != "--prioritized"] + [
    "--replay-layout", "frame-ring", "--total-steps", "32"]
# 7j's actor streams: 7i's network and ring at n_step 1, learning off
STREAM_ARGS = ["--obs", "grayscale", "--num-envs", "256", "--frame-stack",
               "4", "--distributional", "--dueling", "--noisy", "--buffer",
               "65536", "--learn-starts", str(10 ** 9)]
STREAM_STEPS = 32
# run_es at the JAX package's defaults (pop 256 x 4 envs, horizon 256,
# RamDQN 64 / 64), 2 generations
ES_RAM = ["--generations", "2"]
ES_EVAL_STEPS = 200


def _launches() -> dict:
    from gym_simpletetris_tpu_torch.utils import profiling
    got = profiling.counters()
    return {k: got[name] for k, name in _COUNTERS.items()}


@contextlib.contextmanager
def _plain_path():
    """The trainer path on the plain versions, for a comparison run: the env
    step, reset and raster of ``api.env``, the engine's clear, the
    heuristic's lookahead step, the engine's spawn draw and the noisy
    layers' noise."""
    from gym_simpletetris_tpu_torch.api import env as api_env
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.models import heuristic
    from gym_simpletetris_tpu_torch.models.dqn import NoisyDense
    from gym_simpletetris_tpu_torch.ops import raster
    saved = (E.engine_step, api_env.rasterize_rows, heuristic.engine_step,
             api_env.raster_accumulate, E.spawn_draw, NoisyDense.noisy_weights,
             E.engine_clear, api_env.apply_reset_mask)
    E.engine_step = heuristic.engine_step = E.engine_step_plain
    api_env.rasterize_rows = raster.rasterize_rows_plain
    api_env.raster_accumulate = raster.raster_accumulate_plain
    E.spawn_draw = E.spawn_draw_plain
    NoisyDense.noisy_weights = NoisyDense.noisy_weights_plain
    E.engine_clear = E.engine_clear_plain
    api_env.apply_reset_mask = api_env.apply_reset_mask_plain
    try:
        yield
    finally:
        (E.engine_step, api_env.rasterize_rows, heuristic.engine_step,
         api_env.raster_accumulate, E.spawn_draw, NoisyDense.noisy_weights,
         E.engine_clear, api_env.apply_reset_mask) = saved


def _play(cfg, act, steps):
    """``steps`` steps of ``act(obs, env_state)`` at B = TRAIN_B under
    EpisodeStats from seed 0: (actions, rewards, dones stacked [T, B], final
    stats)."""
    import torch
    from gym_simpletetris_tpu_torch import TetrisVectorEnv
    from gym_simpletetris_tpu_torch.api.wrappers import EpisodeStats
    env = TetrisVectorEnv(cfg, TRAIN_B, device="cuda")
    es = EpisodeStats(env)
    obs, st = es.reset(0)
    acts, rews, dones = [], [], []
    for _ in range(steps):
        a = act(obs, st.env_state)
        obs, st, r, d, _ = es.step(st, a)
        acts.append(a)
        rews.append(r)
        dones.append(d)
    torch.cuda.synchronize()
    return torch.stack(acts), torch.stack(rews), torch.stack(dones), st


def _same_play(what, kernel_run, plain_run):
    """Actions, rewards and dones of two ``_play`` runs bitwise equal."""
    import torch
    for name, x, y in zip(("actions", "rewards", "dones"), kernel_run[:3],
                          plain_run[:3]):
        if not torch.equal(x, y):
            t = int(torch.nonzero((x != y).any(dim=1))[0])
            raise PhaseError(f"{what} with the kernels != with the plain "
                             f"versions: {name} first differ at step {t}")


def phase_heuristic():
    """The lookahead policy's 7 * B engine step through kernel A, held
    bitwise to the same policy with the plain step swapped in (lookahead and
    env step). Returns the kernel run's launches."""
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.models.heuristic import make_heuristic_policy
    cfg = EnvConfig(auto_reset=True, reward_step=True)
    policy = make_heuristic_policy(cfg)
    act = lambda obs, s: policy(s)
    n0 = _launches()
    t0 = time.perf_counter()
    run = _play(cfg, act, HEUR_STEPS)
    secs = time.perf_counter() - t0
    n1 = _launches()
    with _plain_path():
        _same_play("heuristic", run, _play(cfg, act, HEUR_STEPS))
    st = run[3]
    eps = int(st.episodes.sum())
    lines = int(st.total_lines.sum())
    done = st.last_length[st.episodes > 0].float()
    lengths = f"mean length {done.mean():.1f}" if eps else "none ended yet"
    log(f"phase 7a heuristic: {HEUR_STEPS} steps at B={TRAIN_B} (lookahead "
        f"B={7 * TRAIN_B}), actions/rewards/dones bitwise equal with kernel "
        f"A and with the plain step; {eps} episodes ({lengths}), {lines} "
        f"lines; {secs:.3f} s with the kernel")
    return {k: n1[k] - n0[k] for k in n1}


def phase_greedy_eval():
    """The line-clear checkpoint in greedy play, as the JAX package's
    evaluate CLI runs it: B = 512, 3000 steps, seed 0, ram, reward_step.
    Then its first EVAL_CMP_STEPS steps again with the kernels and with the
    plain versions, bitwise equal. Returns the evaluation's launches."""
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
    from gym_simpletetris_tpu_torch.train.evaluate import (
        evaluate_policy, make_action_fn)
    cfg = EnvConfig(obs_type="ram", auto_reset=True, reward_step=True)
    env = TetrisVectorEnv(cfg, TRAIN_B, device="cuda")
    fn = make_action_fn("ppo", cfg, TRAIN_B, PARAMS_NPZ, device="cuda")
    torch.cuda.synchronize()
    n0 = _launches()
    t0 = time.perf_counter()
    res = evaluate_policy(env, fn, EVAL_STEPS, 0)
    secs = time.perf_counter() - t0
    n1 = _launches()
    lpe = res["lines_per_episode"]
    log(f"phase 7b greedy eval of {os.path.relpath(PARAMS_NPZ, ROOT)}: "
        f"{json.dumps(res)}; lines/episode {lpe} (JAX package on the CPU: "
        f"{EVAL_JAX_CPU}); {secs:.2f} s, "
        f"{TRAIN_B * EVAL_STEPS / secs:.0f} env-steps/s")
    if lpe is None or lpe < EVAL_FLOOR:
        raise PhaseError(f"greedy eval gave {lpe} lines/episode, under "
                         f"{EVAL_FLOOR}")
    run = _play(cfg, fn, EVAL_CMP_STEPS)
    with _plain_path():
        _same_play("greedy eval", run, _play(cfg, fn, EVAL_CMP_STEPS))
    log(f"  greedy eval: its first {EVAL_CMP_STEPS} steps "
        f"({int(run[2].sum())} dones) bitwise equal with kernel A and with "
        "the plain step")
    return {k: n1[k] - n0[k] for k in n1}


def _run_ppo(args):
    """``run_ppo.main`` on the card, its JSON lines captured (stdout keeps
    to this script's lines). Returns (final state, metric lines)."""
    import io
    from gym_simpletetris_tpu_torch.train import run_ppo
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = run_ppo.main(args + ["--device", "cuda", "--seed", "0"])
    return state, [json.loads(ln) for ln in buf.getvalue().splitlines()]


def _check_ppo(label, args, n_updates):
    """``run_ppo`` for ``n_updates`` and one more update timed in its two
    halves (the launches of both counted), then that update's collection
    again on the plain step and raster: the trajectory must be bitwise
    equal."""
    import torch
    from gym_simpletetris_tpu_torch.train import ppo, run_ppo
    n0 = _launches()
    state, lines = _run_ppo(args)
    if len(lines) != n_updates:
        raise PhaseError(f"{label}: {len(lines)} metric lines, want {n_updates}")
    for rec in lines:
        bad = [k for k, v in rec.items() if not math.isfinite(v)]
        if bad:
            raise PhaseError(f"{label}: non-finite metrics {bad} at update "
                             f"{rec['update']}")
        if not 0.0 < rec["entropy"] <= math.log(7) + 1e-3:
            raise PhaseError(f"{label}: entropy {rec['entropy']} outside "
                             "(0, ln 7]")
    cfg = run_ppo.make_config(run_ppo.parse_args(args))
    init_fn, update_fn, _ = ppo.make_ppo(cfg, "cuda")
    s0 = init_fn(0)
    moved = sum(float((state.params[k] - v).abs().sum())
                for k, v in s0.params.items())
    if not moved > 0:
        raise PhaseError(f"{label}: the parameters did not move")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rollout = update_fn.collect(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    update_fn.learn(state, rollout)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n1 = _launches()
    with _plain_path():
        plain = update_fn.collect(state)
    (env_k, obs_k, traj_k, _), (env_p, obs_p, traj_p, _) = rollout, plain
    for k in ("obs", "action", "reward", "done", "lines"):
        if not torch.equal(traj_k[k], traj_p[k]):
            t = int(torch.nonzero((traj_k[k] != traj_p[k]).reshape(
                cfg.rollout_len, -1).any(dim=1))[0])
            raise PhaseError(f"{label}: collection with the kernels != with "
                             f"the plain versions: {k} first differs at "
                             f"step {t}")
    if not (torch.equal(env_k.rows, env_p.rows) and torch.equal(obs_k, obs_p)):
        raise PhaseError(f"{label}: final env state or observation differs "
                         "with the plain versions")
    walls = [rec["wall_s"] for rec in lines]
    per_update = [b - a for a, b in zip([0.0] + walls, walls)]
    steps = cfg.num_envs * cfg.rollout_len
    return dict(per_update_s=per_update, collect_s=t1 - t0, learn_s=t2 - t1,
                env_steps_per_s=steps / (t2 - t0), moved=moved,
                dones=int(traj_k["done"].sum()), last=lines[-1],
                launches={k: n1[k] - n0[k] for k in n1})


def phase_ppo():
    """PPO ram and grayscale through ``run_ppo``. Returns their launches."""
    runs = (("7c ppo ram", PPO_RAM, 3), ("7d ppo grayscale", PPO_GRAY, 1))
    launches = {}
    for label, args, n in runs:
        r = _check_ppo(label, args, n)
        launches = {k: launches.get(k, 0) + v for k, v in r["launches"].items()}
        last = r["last"]
        log(f"phase {label}: metrics finite, entropy {last['entropy']:.4f}, "
            f"params moved (sum |dp| {r['moved']:.4f}); run_ppo s/update "
            f"{[round(x, 3) for x in r['per_update_s']]}; one more update: "
            f"collect {r['collect_s']:.3f} s + learn {r['learn_s']:.3f} s, "
            f"{r['env_steps_per_s']:.0f} env-steps/s; its collection "
            f"({r['dones']} dones) bitwise equal on the plain step and "
            f"raster; last line {json.dumps(last)}")
    return launches


def phase_trainer_kernels():
    """Kernels A and B against their plain versions at the trainer path's
    shapes and env flags: the step at B = 512 (evaluation), 1024 and 256
    (PPO ram and grayscale), the raster of 10 x 20 rows at B = 256, 84 px.
    Returns the max abs errors by kernel."""
    import numpy as np
    from gym_simpletetris_tpu_torch import EnvConfig
    eval_flags = dict(reward_step=True)
    ppo_flags = dict(reward_step=True, penalise_holes=True)
    step_err, n_cmp, last = _check_step_kernel(
        [(eval_flags, (TRAIN_B,)), (ppo_flags, (1024, 256))], STEPS, 700)
    rng = np.random.RandomState(9)
    cfg = EnvConfig()
    err = _check_raster(
        [(cfg, last[EnvConfig(**ppo_flags), 256], 84, "ppo step boards"),
         (cfg, _random_rows(cfg, 256, rng), 84, "random 10x20")], rng)
    log(f"phase 7e trainer shapes: the step kernel bitwise equal to the plain "
        f"step at B={TRAIN_B}, 1024, 256 in {n_cmp} field comparisons, the "
        f"raster kernels at B=256, 84 px (max_abs_err step {step_err}, "
        f"raster {err['raster']})")
    return dict(err, step=step_err)


def phase_trainer_path():
    """Heuristic, greedy evaluation and PPO (ram and grayscale) on the card,
    then the kernels at their shapes. Launch counts: from 0 before these
    phases, summed over their kernel runs without the comparison runs;
    step and raster must have launched."""
    _reset_counters()
    parts = (phase_heuristic(), phase_greedy_eval(), phase_ppo())
    launches = {k: sum(p[k] for p in parts) for k in parts[0]}
    log(f"phase 7 trainer path: kernel launches {launches}")
    for k in ("step", "raster"):
        if launches[k] <= 0:
            raise PhaseError(f"kernel {k} was not launched on the trainer path")
    return phase_trainer_kernels()


def _clone(x):
    """A deep copy of a trainer state's tensors (the replay ring is written
    in place, so each run from one state needs its own copy)."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def _same_dqn_state(a, b):
    """Names of the fields of two DQN states that differ."""
    import dataclasses
    import torch
    pairs = {"env_state.rows": (a.env_state.rows, b.env_state.rows),
             "obs": (a.obs, b.obs), "key": (a.key, b.key),
             "step": (a.step, b.step)}
    for f in dataclasses.fields(a.replay):
        x = getattr(a.replay, f.name)
        if isinstance(x, torch.Tensor):
            pairs["replay." + f.name] = (x, getattr(b.replay, f.name))
    for k in a.params:
        pairs["params." + k] = (a.params[k], b.params[k])
    if a.window is not None:
        for k in a.window:
            pairs["window." + k] = (a.window[k], b.window[k])
    return [n for n, (x, y) in pairs.items() if not torch.equal(x, y)]


def _device_busy_share(fn):
    """(wall s, share of it the card spent in kernels, device ops) of one
    call of ``fn`` under torch.profiler; the share is None when the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in kernels) / 1e6
    return wall, (busy / wall if busy > 0 else None), len(kernels)


def _check_dqn(label, args, ckpt=None):
    """``run_dqn`` with ``args`` on the card, then from its final state one
    more chunk: timed whole, timed in its halves (a sync after each), under
    torch.profiler, and then twice with deterministic algorithms on, with
    the kernels and with the plain step and raster: the two must end in
    the same state bit for bit (ring rows, env, params). Returns a record
    and the launches of the run and the timed chunk."""
    import io
    import torch
    from gym_simpletetris_tpu_torch.train import dqn, run_dqn
    argv = args + ["--device", "cuda", "--seed", "0"] + (
        ["--ckpt", ckpt] if ckpt else [])
    n0 = _launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        state = run_dqn.main(argv)
    run_s = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    parsed = run_dqn.parse_args(argv)
    want = parsed.total_steps // parsed.chunk
    if len(lines) != want:
        raise PhaseError(f"{label}: {len(lines)} metric lines, want {want}")
    for rec in lines:
        bad = [k for k, v in rec.items() if not math.isfinite(v)]
        if bad:
            raise PhaseError(f"{label}: non-finite metrics {bad}")
    if not lines[-1]["loss"] > 0:
        raise PhaseError(f"{label}: the learner did not run: {lines[-1]}")
    cfg = run_dqn.make_config(parsed)
    _, _, chunk_fn, _ = dqn.make_train(cfg, "cuda")
    # the target still holds the init parameters: it syncs every 500
    # learner steps, and fewer have run
    moved = sum(float((state.params[k] - v).abs().sum())
                for k, v in state.target_params.items())
    if int(state.learn_steps) >= cfg.target_update_period or not moved > 0:
        raise PhaseError(f"{label}: the parameters did not move")
    n = parsed.chunk
    parts = {"run_dqn": run_s}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = round(now - t_part, 2)
        t_part = now

    start = _clone(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1, _ = chunk_fn(_clone(start), n)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    part("timed chunk")
    # the same chunk in its two halves, a sync after each
    s, actor_s, learner_s = _clone(start), 0.0, 0.0
    filled, ls = int(s.replay.filled_slots), int(s.learn_steps)
    for t in range(n):
        t0 = time.perf_counter()
        s, (k_sample, k_nlearn, _) = chunk_fn.actor_half(s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        actor_s += t1 - t0
        filled = min(filled + 1, cfg.buffer_capacity // cfg.num_envs)
        if (t % cfg.learn_every == cfg.learn_every - 1
                and filled * cfg.num_envs >= cfg.learn_starts):
            s, _ = chunk_fn.learner_half(s, k_sample, k_nlearn, ls)
            ls += 1
            torch.cuda.synchronize()
            learner_s += time.perf_counter() - t1
    del s, s1
    part("halves")
    # a short window (the trace of a whole chunk takes minutes to read)
    n_prof = max(4, 2 * cfg.learn_every)
    wall, busy, n_ops = _device_busy_share(
        lambda: chunk_fn(_clone(start), n_prof))
    part("profiled window")
    n1 = _launches()
    # one chunk with the kernels and one on the plain versions, both from
    # the final state, deterministic algorithms on
    torch.use_deterministic_algorithms(True)
    try:
        s_k, _ = chunk_fn(_clone(start), n)
        part("deterministic chunk")
        with _plain_path():
            s_p, _ = chunk_fn(_clone(start), n)
        part("deterministic plain chunk")
    finally:
        torch.use_deterministic_algorithms(False)
    diff = _same_dqn_state(s_k, s_p)
    if diff:
        raise PhaseError(f"{label}: a chunk with the kernels != with the "
                         f"plain versions in {diff[:6]}")
    dones = int(s_k.replay.done.sum())
    del s_k, s_p
    return dict(lines=lines, run_s=run_s, moved=moved, chunk=n, start=start,
                chunk_s=chunk_s, actor_s=actor_s, learner_s=learner_s,
                sps=cfg.num_envs * n / chunk_s, profiled_wall_s=wall,
                profiled_steps=n_prof,
                busy_share=busy, device_ops=n_ops, dones=dones, parts=parts,
                launches={k: n1[k] - n0[k] for k in n1})


def _log_dqn(label, r):
    busy = ("not measured (the profiler saw no device time)"
            if r["busy_share"] is None else
            f"{100 * (1 - r['busy_share']):.1f}% idle")
    log(f"phase {label}: metrics finite, params moved (sum |dp| "
        f"{r['moved']:.4f}); run_dqn {len(r['lines'])} chunks in "
        f"{r['run_s']:.2f} s (init and prefill included); one more chunk "
        f"of {r['chunk']} steps: {r['chunk_s']:.3f} s, "
        f"{r['sps']:.0f} env-steps/s; its halves with a sync after each: "
        f"actor {r['actor_s']:.3f} s + learner {r['learner_s']:.3f} s; "
        f"{r['profiled_steps']} steps from the same state under "
        f"torch.profiler {r['profiled_wall_s']:.3f} s, device {busy}, "
        f"{r['device_ops']} device ops (a clone of the state "
        f"included); the chunk with deterministic algorithms bitwise equal "
        f"on the plain step and raster (ring rows, env, params; "
        f"{r['dones']} dones in the ring); kernel launches "
        f"{r['launches']}; seconds {r['parts']}; last line "
        f"{json.dumps(r['lines'][-1])}")


def _run_dqn_lines(label, args):
    """``run_dqn`` with ``args`` on the card: (final state, metric lines),
    every line finite and the learner run."""
    import io
    from gym_simpletetris_tpu_torch.train import run_dqn
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = run_dqn.main(args + ["--device", "cuda", "--seed", "0"])
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    for rec in lines:
        bad = [k for k, v in rec.items() if not math.isfinite(v)]
        if bad:
            raise PhaseError(f"{label}: non-finite metrics {bad}")
    if not lines or not lines[-1]["loss"] > 0:
        raise PhaseError(f"{label}: the learner did not run: {lines[-1:]}")
    return state, lines


def _actor_stream(args):
    """``STREAM_STEPS`` actor steps of ``run_dqn``'s configuration for
    ``args`` from seed 0, learning off: per step (mean reward, episodes
    done, lines cleared) and the env rows after it."""
    import torch
    from gym_simpletetris_tpu_torch.train import dqn, run_dqn
    cfg = run_dqn.make_config(run_dqn.parse_args(args))
    init_fn, _, chunk_fn, _ = dqn.make_train(cfg, "cuda")
    s = init_fn(0)
    rows = []
    for _ in range(STREAM_STEPS):
        s, (_, _, m) = chunk_fn.actor_half(s)
        rows.append((torch.stack([m["mean_reward"], m["episodes_done"],
                                  m["lines_cleared"]]),
                     s.env_state.rows.clone()))
    del s
    return rows


def phase_frame_rings():
    """7i the grayscale Rainbow on the obs ring and one chunk with slot-row
    sampling; 7j the single-frame frame ring with uniform sampling, and
    the actor stream of the three layouts. Launch counts from 0 before
    these phases, without the comparison runs. Returns the launches."""
    import torch
    from gym_simpletetris_tpu_torch.train import dqn, run_dqn
    _reset_counters()
    r = _check_dqn("7i dqn obs ring", DQN_OBS_RING)
    launches = dict(r["launches"])
    _log_dqn("7i dqn obs ring (flagship image point)", r)
    # one chunk more with whole slot rows (slot-level PER) from the same
    # state
    cfg = run_dqn.make_config(run_dqn.parse_args(DQN_OBS_RING
                                                 + ["--sample-slots"]))
    _, _, chunk_fn, _ = dqn.make_train(cfg, "cuda")
    start = r.pop("start")
    ls0 = int(start.learn_steps)
    n0 = _launches()
    t0 = time.perf_counter()
    s, m = chunk_fn(start, r["chunk"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n1 = _launches()
    launches = {k: launches[k] + n1[k] - n0[k] for k in n1}
    want = r["chunk"] // cfg.learn_every
    if int(s.learn_steps) - ls0 != want or not all(
            math.isfinite(float(v)) for v in m.values()) or \
            not float(m["loss"]) > 0:
        raise PhaseError(f"7i sample-slots chunk: {int(s.learn_steps) - ls0} "
                         f"learner steps, want {want}; metrics {m}")
    del s, start
    log(f"phase 7i --sample-slots: one chunk of {r['chunk']} steps from the "
        f"same state, {want} slot-row PER learner steps, metrics finite, in "
        f"{secs:.3f} s ({cfg.num_envs * r['chunk'] / secs:.0f} "
        f"env-steps/s); loss {float(m['loss']):.4f}")
    n0 = _launches()
    t0 = time.perf_counter()
    state, lines = _run_dqn_lines("7j dqn frame ring", DQN_FRAME_RING)
    secs = time.perf_counter() - t0
    n1 = _launches()
    launches = {k: launches[k] + n1[k] - n0[k] for k in n1}
    if not isinstance(state.replay, dqn.FrameRingState) or \
            state.replay.stacked:
        raise PhaseError("7j: the run did not use the single-frame ring")
    learned = int(state.learn_steps)
    del state
    n0 = _launches()
    t0 = time.perf_counter()
    streams = {layout: _actor_stream(STREAM_ARGS + ["--replay-layout",
                                                    layout])
               for layout in ("legacy", "frame-ring", "obs-ring")}
    stream_s = time.perf_counter() - t0
    n1 = _launches()
    for layout in ("frame-ring", "obs-ring"):
        for t, ((m0, r0), (m1, r1)) in enumerate(zip(streams["legacy"],
                                                     streams[layout])):
            if not (torch.equal(m0, m1) and torch.equal(r0, r1)):
                raise PhaseError(f"7j: the {layout} actor stream != the "
                                 f"legacy ring's at step {t}")
    dones = int(sum(float(m[1]) for m, _ in streams["legacy"]))
    del streams
    log(f"phase 7j dqn frame ring (single frames, uniform sampling): run_dqn "
        f"{len(lines)} chunk of 32 steps in {secs:.2f} s (init included), "
        f"{learned} learner steps, metrics finite; last line "
        f"{json.dumps(lines[-1])}; the actor stream of the legacy, frame and "
        f"obs rings equal for {STREAM_STEPS} steps with learning off "
        f"(n_step 1; rewards, dones and lines per step, env rows; "
        f"{dones} episode ends) in {stream_s:.2f} s, kernel "
        f"launches {dict((k, n1[k] - n0[k]) for k in n1)}")
    log(f"phase 7i-7j frame-ring path: kernel launches {launches}")
    for k in ("step", "raster"):
        if launches[k] <= 0:
            raise PhaseError(f"kernel {k} was not launched on the frame-ring "
                             f"path")
    return launches


def phase_es(tmp):
    """7k ES on ram through ``run_es`` at the JAX package's defaults, one
    generation held bitwise to a run on the plain step; 7l the es policy of
    ``evaluate`` on 7k's checkpoint. Launch counts from 0 before these
    phases, without the comparison runs. Returns the launches."""
    import io
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.train import es, run_es
    from gym_simpletetris_tpu_torch.train.evaluate import make_action_fn
    _reset_counters()
    ckpt = os.path.join(tmp, "es_ram.pt")
    argv = ES_RAM + ["--ckpt", ckpt, "--device", "cuda"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        state = run_es.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _launches()
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    cfg = run_es.make_config(run_es.parse_args(argv))
    steps = cfg.horizon * len(lines)
    if [ln["generation"] for ln in lines] != [1, 2] or not all(
            math.isfinite(v) for ln in lines for v in ln.values()):
        raise PhaseError(f"7k: run_es lines {lines}")
    if int(state.generation) != 2 or launches["step"] != steps:
        raise PhaseError(f"7k: generation {int(state.generation)}, "
                         f"{launches['step']} step launches for {steps} steps")
    # one generation from the final state, with the kernels and on the
    # plain step, deterministic algorithms on
    _, gen_fn, _ = es.make_es(cfg, "cuda")
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        k, mk = gen_fn(_clone(state))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        with _plain_path():
            t0 = time.perf_counter()
            p, mp = gen_fn(_clone(state))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    diff = [n for n in mk if not torch.equal(mk[n], mp[n])] + [
        f for f in ("theta", "key") if not torch.equal(getattr(k, f),
                                                       getattr(p, f))]
    if diff:
        raise PhaseError(f"7k: a generation with the kernels != on the plain "
                         f"step in {diff}")
    envs = cfg.pop_size * cfg.envs_per_member
    log(f"phase 7k es ram (pop {cfg.pop_size} x {cfg.envs_per_member} envs, "
        f"horizon {cfg.horizon}, RamDQN {cfg.hidden}, dim "
        f"{state.theta.numel()}): run_es {len(lines)} generations in "
        f"{run_s:.2f} s (init included), metrics finite; one more generation "
        f"{gen_s:.3f} s ({envs * cfg.horizon / gen_s:.0f} env-steps/s), on "
        f"the plain step {plain_s:.3f} s, bitwise equal (theta, key, "
        f"metrics); kernel launches {launches}; last line "
        f"{json.dumps(lines[-1])}")
    del state, k, p
    ecfg = EnvConfig(obs_type="ram", auto_reset=True, reward_step=True)
    fn = make_action_fn("es", ecfg, TRAIN_B, ckpt, device="cuda",
                        es_hidden=cfg.hidden)
    n0 = _launches()
    t0 = time.perf_counter()
    run = _play(ecfg, fn, ES_EVAL_STEPS)
    secs = time.perf_counter() - t0
    n1 = _launches()
    launches = {k: launches[k] + n1[k] - n0[k] for k in n1}
    with _plain_path():
        _same_play("es greedy eval", run, _play(ecfg, fn, ES_EVAL_STEPS))
    st = run[3]
    log(f"phase 7l es greedy eval of 7k's checkpoint: {ES_EVAL_STEPS} steps "
        f"at B={TRAIN_B} in {secs:.2f} s, actions/rewards/dones bitwise "
        f"equal with the kernels and with the plain step; "
        f"{int(st.episodes.sum())} episodes, {int(st.total_lines.sum())} "
        f"lines; {len(torch.unique(run[0]))} distinct actions")
    log(f"phase 7k-7l es path: kernel launches {launches}")
    if launches["step"] <= 0:
        raise PhaseError("kernel step was not launched on the ES path")
    return launches


def phase_dqn(tmp):
    """7f ram and 7g grayscale Rainbow DQN through ``run_dqn``, 7h the
    greedy dqn policy on 7f's checkpoint. Launch counts from 0 before these
    phases, without the comparison runs; step and raster must have
    launched. Returns the launches."""
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.train.evaluate import make_action_fn
    _reset_counters()
    ckpt = os.path.join(tmp, "dqn_ram.pt")
    launches = {}
    for label, args, path in (("7f dqn ram", DQN_RAM, ckpt),
                              ("7g dqn grayscale Rainbow", DQN_GRAY, None)):
        r = _check_dqn(label, args, path)
        del r["start"]
        launches = {k: launches.get(k, 0) + v for k, v in r["launches"].items()}
        _log_dqn(label, r)
    cfg = EnvConfig(obs_type="ram", auto_reset=True, reward_step=True)
    fn = make_action_fn("dqn", cfg, TRAIN_B, ckpt, device="cuda")
    n0 = _launches()
    t0 = time.perf_counter()
    run = _play(cfg, fn, DQN_EVAL_STEPS)
    secs = time.perf_counter() - t0
    n1 = _launches()
    launches = {k: launches[k] + n1[k] - n0[k] for k in n1}
    with _plain_path():
        _same_play("dqn greedy eval", run, _play(cfg, fn, DQN_EVAL_STEPS))
    st = run[3]
    log(f"phase 7h dqn greedy eval of 7f's checkpoint: {DQN_EVAL_STEPS} "
        f"steps at B={TRAIN_B} in {secs:.2f} s, actions/rewards/dones "
        f"bitwise equal with the kernels and with the plain step; "
        f"{int(st.episodes.sum())} episodes, {int(st.total_lines.sum())} "
        f"lines; {len(torch.unique(run[0]))} distinct actions")
    log(f"phase 7 dqn path: kernel launches {launches}")
    for k in ("step", "raster"):
        if launches[k] <= 0:
            raise PhaseError(f"kernel {k} was not launched on the DQN path")
    return launches


# ---------------------------------------------------- user-facing surfaces

SHIM_STEPS = 300          # 8a, per observation type
SHIM_ACTIONS = (-1, 0, 1, 2, 2, 3, 4, 5, 6, 7)   # -1 and 7 are no-ops
SHIM_OBS = (dict(obs_type="ram"), dict(obs_type="grayscale"),
            dict(obs_type="rgb"), dict(obs_type="grayscale", extend_dims=True))
FUZZ_CASES, FUZZ_STEPS = 8, 100   # 8b
ENGINE_STEPS = 500        # 8c
VECTOR_CASES = ((dict(obs_type="ram", reward_step=True), 4096, 200),
                (dict(obs_type="grayscale", penalise_holes=True), 1024, 100))
NATIVE_STEPS = 300        # 8e
VIDEO_STEPS = 500         # 8f, the most steps of the recorded episode


def _tool(name: str):
    """The module ``tools/<name>.py``."""
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def _same_tree(what, a, b, path="out"):
    """Two nests of numpy arrays, dicts, tuples / lists and scalars equal
    bit for bit (arrays by dtype, shape and bytes)."""
    import numpy as np
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if (a.dtype, a.shape) != (b.dtype, b.shape) or \
                a.tobytes() != b.tobytes():
            raise PhaseError(f"{what}: {path} differs between the kernels "
                             f"and the plain versions")
    elif isinstance(a, dict):
        if list(a) != list(b):
            raise PhaseError(f"{what}: {path} keys {list(a)} != {list(b)}")
        for k in a:
            _same_tree(what, a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            raise PhaseError(f"{what}: {path} lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(what, x, y, f"{path}[{i}]")
    elif type(a) is not type(b) or a != b:
        raise PhaseError(f"{what}: {path} {a!r} != {b!r}")


def _kernel_and_plain(what, run, key=lambda r: r):
    """``run()`` with the kernels, then again on the plain step and raster
    (``_plain_path``), which must launch no kernel. Returns (the kernel
    run's result, its launches, its seconds); fails unless ``key`` of the
    two results is bitwise equal."""
    import torch
    n0 = _launches()
    t0 = time.perf_counter()
    kernel = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n1 = _launches()
    with _plain_path():
        plain = run()
    torch.cuda.synchronize()
    n2 = _launches()
    if n2 != n1:
        raise PhaseError(f"{what}: the plain run launched kernels "
                         f"{ {k: n2[k] - n1[k] for k in n1} }")
    _same_tree(what, key(kernel), key(plain))
    return kernel, {k: n1[k] - n0[k] for k in n1}, secs


def _shim_play(kw, steps, seed):
    """``steps`` random actions (-1 and 7 among them: no-ops) of the gym
    shim ``make("SimpleTetris-v0", backend="cuda")``, reset on done: every
    reset and step output, the env, and the number of calls."""
    import numpy as np
    from gym_simpletetris_tpu_torch import make
    env = make("SimpleTetris-v0", backend="cuda", seed=seed, **kw)
    rng = np.random.RandomState(seed)
    out = [env.reset(return_info=True)]
    for _ in range(steps):
        r = env.step(int(rng.choice(SHIM_ACTIONS)))
        out.append(r)
        if r[2]:
            out.append(env.reset(return_info=True))
    return out, env


def _check_shim_outputs(what, env, out):
    """Observations of the declared shape and values, finite rewards, an
    episode ended; the renders against the host raster."""
    import numpy as np
    from gym_simpletetris_tpu_torch.api.gym_compat import human_image
    from gym_simpletetris_tpu_torch.ops.raster import rasterize_host
    allowed = [0, 1] if env.obs_type == "ram" else [0, 128, 190]
    for o in out:
        if o[0].shape != env.observation_space.shape or \
                not np.isin(o[0], allowed).all():
            raise PhaseError(f"{what}: bad observation {o[0].shape}")
    if not all(np.isfinite(o[1]) for o in out if len(o) == 4) or \
            not any(o[2] for o in out if len(o) == 4):
        raise PhaseError(f"{what}: rewards not finite or no episode ended")
    board = env._board()
    rgb = env.render("rgb_array")
    human = human_image(env.config, env._rows(), env.window_size)
    for img, want in ((rgb, rasterize_host(board.T, env.height, env.width,
                                           160)),
                      (human, rasterize_host(board, env.width, env.height,
                                             env.window_size))):
        if not (img == want[..., None]).all():
            raise PhaseError(f"{what}: render at {img.shape[0]} px != the "
                             "host raster")


def _add(total, part):
    for k, v in part.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_shim():
    """8a: the gym shim on 10 x 20 for each observation type; 8b: the shim
    over 8 random configurations (kernel A at B = 1 over the flag and
    geometry space). Returns (launches, ms per shim call by obs type)."""
    import numpy as np
    random_env_kwargs = _tool("torch_soak_shim").random_env_kwargs
    launches, ms = {}, {}
    for i, kw in enumerate(SHIM_OBS):
        label = kw["obs_type"] + ("+extend_dims" if kw.get("extend_dims")
                                  else "")
        (out, env), n, secs = _kernel_and_plain(
            f"8a shim {label}", lambda: _shim_play(kw, SHIM_STEPS, 20 + i),
            key=lambda r: r[0])
        n0 = _launches()
        _check_shim_outputs(f"8a shim {label}", env, out)
        n = _add(n, {k: v - n0[k] for k, v in _launches().items()})
        _add(launches, n)
        ms[label] = 1e3 * secs / len(out)
        log(f"phase 8a shim {label} 10x20: {len(out)} reset / step calls "
            f"({SHIM_STEPS} actions, {sum(o[2] for o in out if len(o) == 4)}"
            f" episodes ended), bitwise equal with the kernels and on the "
            f"plain step and raster (obs, reward, done, info); renders at 160"
            f" and 512 px equal to the host raster; {ms[label]:.3f} ms a "
            f"call with the kernels; kernel launches {n}")
    fuzz = {}
    for case in range(FUZZ_CASES):
        kw = random_env_kwargs(np.random.RandomState(1000 + case))
        (out, env), n, _ = _kernel_and_plain(
            f"8b shim fuzz {kw}", lambda: _shim_play(kw, FUZZ_STEPS, case),
            key=lambda r: r[0])
        _add(fuzz, n)
        if out[-1][0].shape != env.observation_space.shape:
            raise PhaseError(f"8b {kw}: bad observation shape")
    _add(launches, fuzz)
    log(f"phase 8b shim fuzz: {FUZZ_CASES} random configurations (widths "
        f"4-16, heights 5-24, every flag and obs type) x {FUZZ_STEPS} "
        f"actions at B=1, bitwise equal with the kernels and on the plain "
        f"step and raster; kernel launches {fuzz}")
    return launches, ms


def _engine_play(steps, seed):
    """The standalone ``TetrisEngine`` on the card: ``steps`` random
    actions, ``clear()`` on done, the info every 10 steps; then the board
    setter's round trip and 20 steps from the set board."""
    import numpy as np
    from gym_simpletetris_tpu_torch import TetrisEngine
    eng = TetrisEngine(10, 20, 1, False, True, True, False, True, False,
                       True, False, seed=seed, device="cuda")
    rng = np.random.RandomState(seed)
    out = [eng.clear()]
    for t in range(steps):
        r = eng.step(int(rng.randint(0, 7)))
        out.append(r)
        if t % 10 == 0 or r[2]:
            out.append((eng.get_info(), eng.anchor, eng.shape,
                        eng._lock_delay, eng.valid_action_count()))
        if r[2]:
            out.append(eng.clear())
    board = np.zeros((10, 20))
    board[:, 16:] = rng.randint(0, 2, (10, 4))
    eng.board = board
    if not (eng.board == (board != 0)).all():
        raise PhaseError("8c: the board setter's round trip differs")
    for _ in range(20):
        out.append(eng.step(int(rng.randint(0, 7))))
    out.append(repr(eng))
    return out


def phase_engine():
    """8c: the standalone engine. Returns its launches."""
    out, n, secs = _kernel_and_plain(
        "8c TetrisEngine", lambda: _engine_play(ENGINE_STEPS, 5))
    dones = sum(o[2] for o in out if isinstance(o, tuple) and len(o) == 3)
    log(f"phase 8c TetrisEngine 10x20 (lock_delay 1, reward_step, "
        f"penalties): {ENGINE_STEPS} steps with clear() on done ({dones} "
        f"episodes) and the board setter's round trip, bitwise equal with "
        f"the kernels and on the plain step; {secs:.2f} s with the kernels; "
        f"kernel launches {n}")
    if dones == 0:
        raise PhaseError("8c: no episode ended")
    return n


def _vector_play(kw, num_envs, steps):
    """``_TorchVectorCore`` with next-step autoreset on the card: a digest
    of every output, the seconds spent in ``step``, the envs that
    terminated, and the autoreset checked on the host."""
    import numpy as np
    from gym_simpletetris_tpu_torch.api.gymnasium_vector import (
        _TorchVectorCore)
    core = _TorchVectorCore(num_envs, 3, device="cuda", **kw)
    digest = hashlib.sha256()

    def add(*arrays):
        for a in arrays:
            digest.update(str((a.dtype, a.shape)).encode())
            digest.update(np.ascontiguousarray(a).tobytes())
    obs, info = core.reset()
    add(obs, *info.values())
    rng = np.random.RandomState(4)
    prev = np.zeros(num_envs, dtype=bool)
    piece = 1 if kw["obs_type"] == "ram" else 190   # no piece on a reset
    terms, step_s = 0, 0.0
    for t in range(steps):
        a = rng.choice([0, 1, 2, 2, 3, 4, 5, 6], num_envs)
        t0 = time.perf_counter()
        obs, reward, term, info = core.step(a)
        step_s += time.perf_counter() - t0
        add(obs, reward, term, *info.values())
        if prev.any() and (term[prev].any() or reward[prev].any()
                           or (obs[prev] == piece).any()):
            raise PhaseError(f"8d {kw}: step {t} did not reset the envs "
                             "that terminated a step before")
        prev = term
        terms += int(term.sum())
    return digest.hexdigest(), step_s, terms


def phase_vector():
    """8d: the gymnasium vector adapter's core. Returns its launches and
    env-steps/s by obs type."""
    launches, rates = {}, {}
    for kw, n_envs, steps in VECTOR_CASES:
        what = f"8d vector core {kw['obs_type']}"
        (digest, step_s, terms), n, secs = _kernel_and_plain(
            what, lambda: _vector_play(kw, n_envs, steps),
            key=lambda r: (r[0], r[2]))
        _add(launches, n)
        rates[kw["obs_type"]] = n_envs * steps / step_s
        if terms == 0:
            raise PhaseError(f"{what}: no episode ended")
        log(f"phase {what}: {n_envs} envs x {steps} steps, next-step "
            f"autoreset, bitwise equal with the kernels and on the plain "
            f"step and raster (sha256 of every output {digest[:16]}); "
            f"{terms} terminations; {rates[kw['obs_type']]:.0f} env-steps/s "
            f"in step() with the kernels (numpy out included); kernel "
            f"launches {n}")
    return launches, rates


def phase_native():
    """8e: the port's host C++ env against the shim on the card, on the
    same spawn draws. g++ must build the library here. Returns the card
    run's launches."""
    import numpy as np
    from gym_simpletetris_tpu_torch import make
    from gym_simpletetris_tpu_torch.api.native_env import NativeTetrisEnv
    kw = dict(obs_type="grayscale", reward_step=True, penalise_holes=True,
              lock_delay=1)
    nat = NativeTetrisEnv(**kw)
    env = make(backend="cuda", **kw)
    rng = np.random.RandomState(6)

    def draw(info):
        c = np.array(list(info["statistics"].values()))
        return int(rng.randint(1, int((5 + c.max() - c).sum()) + 1))

    def reset(r):
        a, b = (e.reset(return_info=True, injected_r=r) for e in (nat, env))
        _same_tree("8e native against the card (reset)", a, b)
        return b[1]
    n0 = _launches()
    info = reset(draw({"statistics": dict.fromkeys("TJLZSIO", 0)}))
    dones = 0
    for t in range(NATIVE_STEPS):
        a, r = int(rng.randint(0, 7)), draw(info)
        x, y = nat.step(a, injected_r=r), env.step(a, injected_r=r)
        _same_tree(f"8e native against the card (step {t})", x, y)
        info = y[3]
        if y[2]:
            dones += 1
            info = reset(draw(info))
    n = {k: v - n0[k] for k, v in _launches().items()}
    if dones == 0:
        raise PhaseError("8e: no episode ended")
    log(f"phase 8e native backend: the port's C++ NativeTetrisEnv and the "
        f"shim on the card, {NATIVE_STEPS} grayscale steps in lockstep on "
        f"the same spawn draws ({dones} episodes): obs, reward, done and info "
        f"equal; kernel launches {n}")
    return n


def phase_video():
    """8f: ``record_episode`` at 160 px. Returns its launches."""
    from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
    from gym_simpletetris_tpu_torch.utils.video import record_episode

    def run():
        env = TetrisVectorEnv(EnvConfig(reward_step=True), 1, device="cuda")
        return record_episode(env, max_steps=VIDEO_STEPS, size=160, seed=2)
    frames, n, secs = _kernel_and_plain("8f record_episode", run)
    if frames.shape[1:] != (160, 160, 3) or len(frames) < 3:
        raise PhaseError(f"8f: frames {frames.shape}")
    log(f"phase 8f record_episode 10x20 at 160 px: {len(frames)} frames, "
        f"bitwise equal with the kernels and on the plain step and raster; "
        f"{secs:.2f} s with the kernels; kernel launches {n}")
    return n


def phase_surfaces():
    """8a-8f, the user-facing surfaces on the card, each against a run on
    the plain step and raster that launches no kernel. Launch counts from 0
    before these phases, without the comparison runs; A and B must have
    launched. Returns the launches."""
    _reset_counters()
    launches, ms = phase_shim()
    _add(launches, phase_engine())
    vec, rates = phase_vector()
    _add(launches, vec)
    _add(launches, phase_native())
    _add(launches, phase_video())
    log(f"phase 8 user-facing surfaces: ms per shim call (8a) "
        f"{ {k: round(v, 3) for k, v in ms.items()} }; vector core "
        f"env-steps/s (8d) { {k: round(v) for k, v in rates.items()} }; "
        f"kernel launches {launches}")
    for k in ("step", "raster"):
        if launches[k] <= 0:
            raise PhaseError(f"kernel {k} was not launched on the surfaces")
    return launches


# ----------------------------------------------------------------- phase 9

P9_B = 4096               # 9a / 9b global batch
P9_ROLL = 256             # 9a storage rollout
P9_STEPS = 64             # 9a / 9b single steps
P9_RING_STEPS = 32        # 9c obs ring, 7i's configuration cut to 32 steps
P9_DQN_STEPS = 48         # 9c legacy ring, 7f's configuration


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np_state(st):
    """A state's tensors (an EnvState or a trainer state) as numpy, by
    path."""
    from gym_simpletetris_tpu_torch.train.sharding import leaves
    return {".".join(map(str, p)): x.detach().cpu().numpy()
            for p, x in leaves(st)}


def _p9_env_run(cfg, env, seed=0):
    """Reset, P9_STEPS steps and a P9_ROLL-step storage rollout of ``env``
    (the sharded or the unsharded one), from seed 0 and one action
    stream."""
    import numpy as np
    import torch
    rng = np.random.RandomState(9)
    obs, s = env.reset(seed)
    out = {"reset_obs": obs.cpu().numpy(), "reward": [], "done": []}
    for _ in range(P9_STEPS):
        a = torch.as_tensor(rng.randint(0, 7, P9_B), device="cuda")
        obs, s, r, d, _ = env.step(s, a)
        out["reward"].append(r.cpu().numpy())
        out["done"].append(d.cpu().numpy())
    out["obs"] = obs.cpu().numpy()
    out["state64"] = _np_state(s)
    acts = torch.as_tensor(rng.randint(0, 7, (P9_ROLL, P9_B)), device="cuda")
    final, acc, rew, don = env.rollout(s, acts)
    out.update(acc=acc.cpu().numpy(), roll_reward=rew.cpu().numpy(),
               roll_done=don.cpu().numpy(), final=_np_state(final))
    return out, final


def phase_9a(mesh):
    """ShardedTetrisEnv at world 1 against TetrisVectorEnv, and on the
    plain step and raster; global_metrics; shard_map_step."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
    from gym_simpletetris_tpu_torch.core import engine as E, threefry
    from gym_simpletetris_tpu_torch.parallel import mesh as M
    first64 = None
    for o in ("ram", "grayscale"):
        cfg = EnvConfig(obs_type=o, auto_reset=True, reward_step=True)
        (sh, final), _, secs = _kernel_and_plain(
            f"9a sharded {o}",
            lambda: _p9_env_run(cfg, M.ShardedTetrisEnv(cfg, P9_B, mesh)),
            key=lambda r: r[0])
        un, final_u = _p9_env_run(cfg, TetrisVectorEnv(cfg, P9_B, "cuda"))
        _same_tree(f"9a sharded {o} against TetrisVectorEnv", sh, un)
        gm = {k: v.cpu().numpy() for k, v in
              M.global_metrics(final, mesh).items()}
        gu = {k: v.cpu().numpy() for k, v in
              M.global_metrics(final_u).items()}
        _same_tree(f"9a global_metrics {o}", gm, gu)
        if o == "ram":
            first64 = sh
        log(f"phase 9a sharded env {o} 10x20 at world 1 (NCCL): reset + "
            f"{P9_STEPS} steps + rollout T={P9_ROLL} at B={P9_B} bitwise "
            f"equal to TetrisVectorEnv and to the plain step and raster; "
            f"global_metrics equal ({ {k: v.item() for k, v in gm.items()} });"
            f" {secs:.2f} s with the kernels")
    cfg = EnvConfig(auto_reset=True, width=4, height=5)
    env = TetrisVectorEnv(cfg, P9_B, "cuda")
    _, st = env.reset(4)
    step = M.shard_map_step(cfg, mesh)
    a = torch.full((P9_B,), 2, device="cuda")
    for t in range(8):
        obs, nst, r, d, fin = step(st, a)
        want = E.engine_step_plain(cfg, st.replace(
            key=threefry.fold_in(st.key, 0)), a)
        same = (torch.equal(nst.rows, want.state.rows)
                and torch.equal(r, want.reward) and torch.equal(d, want.done)
                and torch.equal(nst.key, threefry.split(st.key)[0])
                and int(fin) == int(want.done.sum()))
        if not same:
            raise PhaseError(f"9a shard_map_step at step {t} != the plain "
                             f"step with the key folded by 0")
        st = nst
    log("phase 9a shard_map_step at world 1: 8 steps equal to the plain "
        "step with the key folded by 0, the finished count and the "
        "re-derived key")
    return first64


def _p9b_rank(rank: int, store: str, out: str):
    """9b's rank: ram 10x20, its half of B, over gloo on cuda:0."""
    import numpy as np
    import torch
    import torch.distributed as dist
    _import_port()
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.parallel import mesh as M
    M.init_distributed(f"file://{store}", 2, rank, backend="gloo")
    try:
        mesh = M.make_data_mesh("cuda")
        group = M.data_axis(mesh)[0]
        # gloo takes CUDA tensors as they are
        x = torch.full((3,), float(rank + 1), device="cuda")
        dist.all_reduce(x, group=group)
        g = M.all_gather_cat(torch.full((2,), rank, device="cuda"), group)
        y = torch.full((2,), float(rank), device="cuda")
        dist.broadcast(y, dist.get_global_rank(group, 0), group=group)
        coll = (x.tolist() == [3.0] * 3 and g.tolist() == [0, 0, 1, 1]
                and y.tolist() == [0.0, 0.0])
        _reset_counters()
        cfg = EnvConfig(obs_type="ram", auto_reset=True, reward_step=True)
        env = M.ShardedTetrisEnv(cfg, P9_B, mesh)
        rng = np.random.RandomState(9)
        obs, s = env.reset(0)
        rec = {"reset_obs": obs.cpu().numpy(), "reward": [], "done": []}
        for _ in range(P9_STEPS):
            a = torch.as_tensor(rng.randint(0, 7, P9_B), device="cuda")
            obs, s, r, d, _ = env.step(s, a)
            rec["reward"].append(r.cpu().numpy())
            rec["done"].append(d.cpu().numpy())
        metrics = M.global_metrics(s, mesh)
        torch.cuda.synchronize()
        np.savez(out, reset_obs=rec["reset_obs"], obs=obs.cpu().numpy(),
                 reward=np.stack(rec["reward"]), done=np.stack(rec["done"]),
                 rows=s.rows.cpu().numpy(), coll=coll,
                 env_steps=metrics["env_steps"].cpu().numpy(),
                 launches=np.array([_launches()["step"],
                                    _launches()["raster"]]))
    finally:
        M.shutdown()


def phase_9b(first64):
    """Two ranks on the one card over gloo: each half of B = 4096, equal to
    9a's first 64 steps. Returns the ranks' launches of A and B."""
    import numpy as np
    import tempfile
    with tempfile.TemporaryDirectory(prefix=".p9b_", dir=ROOT) as tmp:
        outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(2)]
        code = ("import sys; sys.path.insert(0, {root!r}); import chip_smoke;"
                " chip_smoke._p9b_rank({r}, {store!r}, {out!r})")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code.format(
                root=ROOT, r=r, store=os.path.join(tmp, "store"),
                out=outs[r])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, lg) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise PhaseError(f"9b rank {r} exited {p.returncode}:\n"
                                 f"{lg[-3000:]}")
        ranks = [dict(np.load(o)) for o in outs]
    if not all(bool(r["coll"]) for r in ranks):
        raise PhaseError("9b: a gloo collective on CUDA tensors gave a "
                         "wrong result")
    cat = lambda k, ax: np.concatenate([r[k] for r in ranks], axis=ax)
    got = {"reset_obs": cat("reset_obs", 0), "obs": cat("obs", 0),
           "reward": cat("reward", 1), "done": cat("done", 1),
           "rows": cat("rows", 1)}
    want = {"reset_obs": first64["reset_obs"], "obs": first64["obs"],
            "reward": np.stack(first64["reward"]),
            "done": np.stack(first64["done"]),
            "rows": first64["state64"]["rows"]}
    _same_tree("9b two ranks against 9a", got, want)
    steps = int(ranks[0]["env_steps"])
    if steps != int(first64["state64"]["time"].sum()) or \
            int(ranks[1]["env_steps"]) != steps:
        raise PhaseError("9b: global_metrics over gloo != the unsharded sum")
    launches = {"step": int(sum(r["launches"][0] for r in ranks)),
                "raster": int(sum(r["launches"][1] for r in ranks)),
                "raster_accumulate": 0}
    log(f"phase 9b two ranks on one card over gloo (cuda:0 each): ram "
        f"{P9_B // 2} envs a rank, reset + {P9_STEPS} steps concatenated "
        f"bitwise equal to 9a; all_reduce, all_gather and broadcast take "
        f"CUDA tensors as they are; global_metrics equal; kernel launches "
        f"(the ranks') {launches}")
    return launches


def _p9_dqn_configs():
    """9c's (and 10a's) DQN configurations: 7f's legacy ring (PER, 3-step,
    dueling, RamDQN 512 / 256, 1024 envs), 7i's obs-ring Rainbow."""
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.train import dqn
    rainbow = dqn.DQNConfig(
        env=EnvConfig(obs_type="grayscale", auto_reset=True,
                      reward_step=True, penalise_holes=True),
        num_envs=256, buffer_capacity=65536, frame_stack=4, n_step=3,
        prioritized=True, distributional=True, dueling=True, noisy=True,
        learn_every=4, frame_ring=True, ring_stacks=True)
    legacy = dqn.DQNConfig(prioritized=True, n_step=3, dueling=True)
    return legacy, rainbow


def _p9_trainers():
    """(name, run(mesh) -> (state, metrics)) of 9c's trainers
    (``_trainer_runs``)."""
    def whole(steps, build):
        def run(mesh):
            init_fn, go = build(mesh)
            return go(init_fn(0), steps)
        return run
    return tuple((name, whole(steps, build))
                 for name, steps, _, build in _trainer_runs())


def _trainer_runs():
    """(name, steps, steps through the first learner update or None,
    build(mesh) -> (init_fn, run(state, n))) of 9c's and 11a's trainers:
    the DQN 7f (48 steps; the learner first at step 4 of 4096 / 1024
    transitions), the obs-ring Rainbow 7i (32 steps; at step 16, every 4th),
    PPO ram 1024 x 64 (one update) and ES at its defaults (a generation)."""
    from gym_simpletetris_tpu_torch.train import dqn, es, ppo
    legacy, rainbow = _p9_dqn_configs()

    def dqn_build(cfg):
        def build(mesh):
            init_fn, _, chunk_fn, _ = dqn.make_train(cfg, "cuda", mesh=mesh)
            return init_fn, chunk_fn
        return build

    def ppo_build(mesh):
        init_fn, update_fn, _ = ppo.make_ppo(ppo.PPOConfig(), "cuda",
                                             mesh=mesh)
        return init_fn, lambda st, n: update_fn(st)

    def es_build(mesh):
        init_fn, gen_fn, _ = es.make_es(es.ESConfig(), "cuda", mesh=mesh)
        return init_fn, lambda st, n: gen_fn(st)

    return (("dqn 7f", P9_DQN_STEPS, 4, dqn_build(legacy)),
            ("obs-ring rainbow 7i", P9_RING_STEPS, 16, dqn_build(rainbow)),
            ("ppo ram 1024x64", 1, None, ppo_build),
            ("es defaults", 1, None, es_build))


def phase_9c(mesh, tmp):
    """The trainers' mesh branches at world 1 against the unsharded
    trainers (and the mesh run on the plain step and raster), bitwise;
    a checkpoint saved at world 1 continues identically."""
    import filecmp
    import torch
    from gym_simpletetris_tpu_torch.train import dqn
    from gym_simpletetris_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)
    host = lambda r: (_np_state(r[0]),
                      {k: v.cpu().numpy() for k, v in r[1].items()})
    torch.use_deterministic_algorithms(True)
    try:
        launches, secs, unsharded = {}, {}, {}
        for name, run in _p9_trainers():
            sharded, n, secs[name] = _kernel_and_plain(
                f"9c {name} mesh", lambda: host(run(mesh)))
            _add(launches, n)
            unsharded[name] = host(run(None))
            _same_tree(f"9c {name}: mesh at world 1 against unsharded",
                       sharded, unsharded[name])
        # a checkpoint at world 1, byte for byte the unsharded one's
        cfg = dqn.DQNConfig(prioritized=True, n_step=3, dueling=True)
        files, runs = [], []
        for m, sub in ((mesh, "mesh"), (None, "unsharded")):
            os.makedirs(os.path.join(tmp, sub))
            init_fn, _, chunk_fn, _ = dqn.make_train(cfg, "cuda", mesh=m)
            st, _ = chunk_fn(init_fn(0), 8)
            runs.append((chunk_fn, st))
            files.append(save_checkpoint(os.path.join(tmp, sub, "dqn.pt"),
                                         st, mesh=m))
        if not filecmp.cmp(*files, shallow=False):
            raise PhaseError("9c: the world-1 checkpoint != the unsharded "
                             "one")
        chunk_fn, st = runs[0]
        again = restore_checkpoint(files[0], "cuda", mesh=mesh)
        _same_tree("9c checkpoint continues",
                   host(chunk_fn(_clone(st), 8)), host(chunk_fn(again, 8)))
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"phase 9c mesh trainers at world 1: {', '.join(secs)} bitwise "
        f"equal to the unsharded trainers and to the plain step and raster "
        f"(deterministic algorithms on); s with the kernels "
        f"{ {k: round(v, 2) for k, v in secs.items()} }; a checkpoint saved "
        f"at world 1 is the unsharded file byte for byte and continues "
        f"identically; kernel launches {launches}")
    return launches, unsharded, secs


def phase_9de(mesh, card):
    """9d, for information: collective_bench and scaling_bench at world 1;
    9e: graft_entry.entry() and dryrun_multichip(1) over NCCL."""
    import io
    from gym_simpletetris_tpu_torch import graft_entry
    from gym_simpletetris_tpu_torch.parallel import (collective_bench,
                                                     scaling_bench)
    cb = collective_bench.bench_collectives(mesh, mb=64, iters=10)
    log(f"phase 9d collective_bench at world 1, 64 MB ({card}): "
        f"{json.dumps(cb)}")
    for extra in ([], ["--train"]):
        with contextlib.redirect_stdout(io.StringIO()):
            res = scaling_bench.main(["--per-device", "4096", "--steps",
                                      "256", "--obs", "ram"] + extra)
        log(f"phase 9d scaling_bench {' '.join(extra) or 'rollout'} at 1 "
            f"device, per-device 4096, ram, 256 steps ({card}): "
            f"{json.dumps(res)}")
    fn, args = graft_entry.entry()
    out = fn(*args)
    if tuple(out.shape) != (8, 7) or not bool(out.isfinite().all()):
        raise PhaseError(f"9e entry(): output {tuple(out.shape)}")
    with contextlib.redirect_stdout(io.StringIO()) as said:
        graft_entry.dryrun_multichip(1)
    log(f"phase 9e graft_entry.entry(): dueling NatureDQN forward on 8 x 84 "
        f"x 84 grayscale, {tuple(out.shape)}; dryrun_multichip(1) over NCCL: "
        f"{said.getvalue().strip().splitlines()[-1]}")


def phase_mesh(card, tmp):
    """Phase 9: the data-parallel layer on the card. World 1 over NCCL
    (9a, 9c-9e), two ranks over gloo on the one card (9b). Launch counts
    from 0 before the phase, without the plain runs and the 9c unsharded
    runs' copies counted twice; A and B must have launched in 9a-9c and C
    in 9a. Returns the launches, and 9c's unsharded results and seconds
    (phase 10 holds its tensor-parallel runs to them)."""
    from gym_simpletetris_tpu_torch.parallel import mesh as M
    _reset_counters()
    M.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    try:
        mesh = M.make_data_mesh("cuda")
        first64 = phase_9a(mesh)
        n9a = _launches()
        if n9a["raster_accumulate"] <= 0:
            raise PhaseError("kernel raster_accumulate was not launched in 9a")
        launches = dict(n9a)
        _add(launches, phase_9b(first64))
        n9c, unsharded, secs = phase_9c(mesh, tmp)
        _add(launches, n9c)
        for k in ("step", "raster"):
            if launches[k] <= 0:
                raise PhaseError(f"kernel {k} was not launched in 9a-9c")
        phase_9de(mesh, card)
    finally:
        M.shutdown()
    log(f"phase 9 data-parallel layer: kernel launches {launches}")
    return launches, unsharded, secs


# ---------------------------------------------------------------- phase 10

P10_CONT = 8                # 10c: steps continued after the (1, 2) save
P10_HALVES = 4              # actor and learner halves timed apart
P10_TOL = dict(rtol=2e-4, atol=2e-6)    # the CPU tests' TP tolerance
# 10a prints the learned floats' distance from the unsharded runs against
# it (``_p10_compare``); 10c holds the continued 7f state to it.
# the state's float fields that the learner writes
_LEARNED = ("params.", "target_params.", "opt_state.", "replay.priority",
            "replay.max_p")


def _p10_split(arrays: dict):
    """A state's arrays by path -> (the learned floats, per-slot digests of
    the rest): a replay field ``[S, B, ...]`` one digest a slot row, any
    other field one digest."""
    import numpy as np
    learned, digests = {}, {}
    for k, a in arrays.items():
        if k.startswith(_LEARNED):
            learned[k] = a
            continue
        a = np.ascontiguousarray(a)
        rows = a if k.startswith("replay.") and a.ndim >= 2 else a[None]
        digests[k] = np.array([hashlib.blake2b(r.tobytes(), digest_size=16)
                               .hexdigest() for r in rows])
    return learned, digests


def _p10_record(name, state, metrics, network, mesh, noise_key,
                stream=True):
    """A 10a rank's record of a run: the weight blocks gathered over the
    model axis; with ``stream`` also the rest of the state as digests, the
    metrics, and the sharded forward on the state's obs (``noise_key`` for
    a noisy network)."""
    import torch
    from torch.func import functional_call
    from gym_simpletetris_tpu_torch.parallel import mesh as M
    from gym_simpletetris_tpu_torch.train.sharding import leaves, model_paths
    group, _, m = M.model_axis(mesh)
    split = model_paths(state, m)
    arrays = {}
    for p, x in leaves(state):
        if p in split:
            x = M.all_gather_cat(x, group, 0)
        arrays[".".join(map(str, p))] = x.detach().cpu().numpy()
    learned, digests = _p10_split(
        arrays if stream else {k: v for k, v in arrays.items()
                               if k.startswith(_LEARNED)})
    rec = {f"{name}/learned/{k}": v for k, v in learned.items()}
    if not stream:
        return rec
    args = (state.obs,) if noise_key is False else (state.obs, noise_key)
    with torch.no_grad():
        out = functional_call(network, state.params, args)
    out = out if isinstance(out, tuple) else (out,)
    rec.update({f"{name}/digest/{k}": v for k, v in digests.items()})
    rec.update({f"{name}/metric/{k}": v.cpu().numpy()
                for k, v in metrics.items()})
    rec.update({f"{name}/probe{i}": o.cpu().numpy()
                for i, o in enumerate(out)})
    rec[f"{name}/obs"] = state.obs.cpu().numpy()
    return rec


def _p10_runs():
    """(name, steps, steps through the first learner update or None,
    build(mesh) -> (init_fn, run(state, n), network, noise key or False))
    of 10a's trainers: 9c's DQN 7f (48 steps; the learner first at step 4
    of 4096 / 1024 transitions), obs-ring Rainbow 7i (32 steps; at step 16,
    every 4th) and PPO ram 1024 x 64 (one update)."""
    from gym_simpletetris_tpu_torch.core.state import _key_tensor
    from gym_simpletetris_tpu_torch.train import dqn, ppo
    legacy, rainbow = _p9_dqn_configs()

    def dqn_build(cfg):
        def build(mesh):
            init_fn, _, chunk_fn, net = dqn.make_train(cfg, "cuda", mesh=mesh)
            key = _key_tensor(11, "cuda") if cfg.noisy else None
            return init_fn, chunk_fn, net, key
        return build

    def ppo_build(mesh):
        init_fn, update_fn, net = ppo.make_ppo(ppo.PPOConfig(), "cuda",
                                               mesh=mesh)
        return init_fn, lambda st, n: update_fn(st), net, False

    return (("dqn 7f", P9_DQN_STEPS, 4, dqn_build(legacy)),
            ("obs-ring rainbow 7i", P9_RING_STEPS, 16, dqn_build(rainbow)),
            ("ppo ram 1024x64", 1, None, ppo_build))


@contextlib.contextmanager
def _count_model_collectives(group):
    """Within the block, count the ``all_gather`` / ``all_reduce`` calls on
    ``group``; yields the dict of counts."""
    import torch.distributed as dist
    counts = {"all_gather": 0, "all_reduce": 0}
    saved = {k: getattr(dist, k) for k in counts}

    def counting(k):
        def call(*a, group=None, **kw):
            counts[k] += group is not None and group == want
            return saved[k](*a, group=group, **kw)
        return call

    want = group
    for k in counts:
        setattr(dist, k, counting(k))
    try:
        yield counts
    finally:
        for k in counts:
            setattr(dist, k, saved[k])


def _p10a_rank(rank: int, store: str, outdir: str):
    """10a / 10c's rank at (data, model) = (1, 2) over gloo on cuda:0."""
    import numpy as np
    import torch
    _import_port()
    from torch.distributed.device_mesh import init_device_mesh
    from gym_simpletetris_tpu_torch.parallel import mesh as M
    from gym_simpletetris_tpu_torch.utils.checkpoint import save_checkpoint
    M.init_distributed(f"file://{store}", 2, rank, backend="gloo")
    torch.use_deterministic_algorithms(True)
    try:
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        _reset_counters()
        rec, kept = {}, {}
        for name, steps, first, build in _p10_runs():
            init_fn, run, net, key = build(mesh)
            if first:
                st, metrics = run(init_fn(0), first)
                rec.update(_p10_record(f"{name} first", st, metrics, net,
                                       mesh, key, stream=False))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, metrics = run(init_fn(0), steps)
            torch.cuda.synchronize()
            rec[f"{name}/secs"] = np.array(time.perf_counter() - t0)
            rec.update(_p10_record(name, st, metrics, net, mesh, key))
            kept[name] = (st, run, net)
        rec["launches"] = np.array([_launches()[k] for k in _COUNTERS])
        # 10c: the 7f state saved at (1, 2), then continued with the
        # kernels and again on the plain step, bitwise
        st, run, net = kept["dqn 7f"]
        save_checkpoint(os.path.join(outdir, "dqn7f.pt"), st, mesh=mesh)
        cont, cm = run(_clone(st), P10_CONT)
        with _plain_path():
            plain, pm = run(_clone(st), P10_CONT)
        same = _same_dqn_state(cont, plain) + [
            k for k in cm if not torch.equal(cm[k], pm[k])]
        rec["plain_differs"] = np.array(" ".join(same))
        rec.update(_p10_record("cont", cont, cm, net, mesh, None))
        # the halves timed apart, and the model-axis collectives of one
        # learner step
        half = _clone(st)
        actor, learner = run.actor_half, run.learner_half
        times = {"actor": [], "learner": []}
        for _ in range(P10_HALVES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            half, (k_s, k_n, _) = actor(half)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with _count_model_collectives(M.model_axis(mesh)[0]) as counts:
                half, _ = learner(half, k_s, k_n)
                torch.cuda.synchronize()
            times["actor"].append(t1 - t0)
            times["learner"].append(time.perf_counter() - t1)
        rec["halves"] = np.array([np.median(times["actor"]),
                                  np.median(times["learner"])])
        rec["collectives"] = np.array([counts["all_gather"],
                                       counts["all_reduce"]])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        M.shutdown()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **rec)


def _spawn_ranks(what, n, target, args, timeout=600):
    """``n`` processes running ``chip_smoke.<target>(rank, *args)``; fails
    the phase unless every one exits 0."""
    code = ("import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
            "chip_smoke.{target}({r}, *{args!r})")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(root=ROOT, target=target, r=r,
                                           args=tuple(args))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, lg) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise PhaseError(f"{what} rank {r} exited {p.returncode}:\n"
                             f"{lg[-3000:]}")


def _p10_first_divergence(got: dict, want: dict):
    """(field, slot) of the first ring slot where two digest records
    differ (a ring slot is an actor step's row), else (field, 0) of the
    first other field that differs; None when they agree."""
    import numpy as np
    first = None
    for k in sorted(got, key=lambda k: not k.startswith("replay.")):
        diff = np.nonzero(got[k] != want[k])[0]
        if len(diff) and (first is None or (k.startswith("replay.")
                                            and diff[0] < first[1])):
            first = (k, int(diff[0]))
    return first


def _p10_drift(got: dict, want: dict):
    """The largest difference of two dicts of floats, its largest share of
    P10_TOL, and the key where that share is."""
    import numpy as np
    worst, share, where = 0.0, 0.0, None
    for k, a in want.items():
        a = np.asarray(a, dtype=np.float64)
        d = np.abs(np.asarray(got[k], dtype=np.float64) - a)
        r = d / (P10_TOL["atol"] + P10_TOL["rtol"] * np.abs(a))
        worst = max(worst, float(d.max(initial=0.0)))
        if float(r.max(initial=0.0)) > share:
            i = tuple(map(int, np.unravel_index(int(r.argmax()), r.shape))) \
                if r.ndim else ()
            share, where = float(r.max()), (
                f"{k}{list(i)}: {float(np.asarray(got[k])[i]):.6g} against "
                f"{float(a[i]):.6g}")
    return worst, share, where


def _p10_unsharded_probe(name, rec):
    """The unsharded network's forward on the 10a rank's gathered
    parameters and obs: the outputs the sharded forward must equal."""
    import torch
    from torch.func import functional_call
    from gym_simpletetris_tpu_torch.train import dqn, ppo
    params = {k[len(f"{name}/learned/params."):]: torch.from_numpy(v).cuda()
              for k, v in rec.items()
              if k.startswith(f"{name}/learned/params.")}
    obs = torch.from_numpy(rec[f"{name}/obs"]).cuda()
    for run_name, _, _, build in _p10_runs():
        if run_name == name:
            _, _, net, key = build(None)
    args = (obs,) if key is False else (obs, key)
    with torch.no_grad(), _deterministic():
        out = functional_call(net, params, args)
    return [o.cpu().numpy() for o in (out if isinstance(out, tuple)
                                       else (out,))]


@contextlib.contextmanager
def _deterministic():
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _p10_learned(rec: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


def _p10_compare(name, steps, first, build, rec, unsharded, secs9):
    """10a's checks of one run against the unsharded one: (a note, a list
    of faults). The stream (env rows, actions, dones, the ring, the obs)
    bitwise, or a divergence explained by a sharded forward that is not
    bitwise on the card, or by the learner once it has run (PPO collects
    before it learns; a DQN ring slot below learn_starts / num_envs was
    written before the first learner step). The learned floats' distance
    from the unsharded run, after the first learner update (PPO's one) and
    at the end, is printed against P10_TOL, not held: cuBLAS and cuDNN
    choose their summation order by shape, so a layer's block (N / 2
    rows) and the whole layer may sum in other orders on the card."""
    import numpy as np
    state, metrics = unsharded
    learned, digests = _p10_split(state)
    faults = []
    no_ring = lambda d: {k: v for k, v in d.items()
                         if not k.startswith("replay.")}
    if first:
        init_fn, run, _, _ = build(None)
        with _deterministic():
            st1, _ = run(init_fn(0), first)
        held = _p10_drift(_p10_learned(rec, f"{name} first/learned/"),
                          no_ring(_p10_split(_np_state(st1))[0]))
    else:
        held = _p10_drift(_p10_learned(rec, f"{name}/learned/"),
                          no_ring(learned))
    got_l = _p10_learned(rec, f"{name}/learned/")
    end = _p10_drift(got_l, no_ring(learned))
    # the priorities apart: a double-DQN target whose argmax is a near tie
    # flips with the parameters' last bits, and its sample's priority
    pri = [k for k in learned if k.startswith("replay.")]
    p_end = _p10_drift({k: got_l[k] for k in pri},
                       {k: learned[k] for k in pri})
    m_end = _p10_drift({k: rec[f"{name}/metric/{k}"] for k in metrics},
                       metrics)
    probe = _p10_unsharded_probe(name, rec)
    fwd = max(float(np.abs(rec[f"{name}/probe{i}"] - p).max())
              for i, p in enumerate(probe))
    off = sum(int((rec[f"{name}/probe{i}"] != p).sum()) for i, p in
              enumerate(probe)) / sum(p.size for p in probe)
    div = _p10_first_divergence(_p10_learned(rec, f"{name}/digest/"),
                                digests)
    if div is not None:
        cfg = _p9_dqn_configs()[name.startswith("obs")]
        learned_from = 0 if name.startswith("ppo") else \
            cfg.learn_starts // cfg.num_envs
        if off == 0 and (name.startswith("ppo") or div[1] < learned_from):
            faults.append(f"10a {name}: diverges at {div} with a bitwise "
                          f"forward, before the learner ran")
    stream = ("env rows, actions, dones, ring and obs bitwise" if div is None
              else f"DIVERGES first at {div[0]} slot {div[1]} (bitwise "
                   f"before it)")
    fwd_note = "bitwise" if off == 0 else \
        f"not bitwise: {100 * off:.3g}% of outputs differ, by up to {fwd:.3g}"
    note = (f"{name}: {stream}; sharded forward on the same parameters "
            f"{fwd_note}; parameters and Adam state after the first learner "
            f"update {held[0]:.3g} from the unsharded run ({held[1]:.3g} of "
            f"the CPU tolerance, at {held[2]}), at the end {end[0]:.3g} "
            f"({end[1]:.3g}); metrics {m_end[0]:.3g} ({m_end[1]:.3g}); "
            f"priorities {p_end[0]:.3g} ({p_end[1]:.3g}); "
            f"{float(rec[f'{name}/secs']) / steps:.4f} s a step (9c world 1: "
            f"{secs9 / steps:.4f})")
    return note, faults


def phase_tp(card, unsharded: dict, secs9: dict, tmp):
    """Phase 10: tensor parallelism over the model axis on the one card.
    10a / 10c: two ranks at (data, model) = (1, 2) over gloo on cuda:0 run
    9c's DQN 7f, obs-ring Rainbow and PPO at full width, held to 9c's
    unsharded runs, and save the 7f state, which the parent restores
    unsharded and continues; 10b: ``dryrun_multichip(4)`` over gloo on the
    card, (4, 1), (2, 2) and (1, 4). Returns the ranks' launches."""
    import io
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import graft_entry
    from gym_simpletetris_tpu_torch.train import dqn
    from gym_simpletetris_tpu_torch.utils.checkpoint import restore_checkpoint
    t0 = time.perf_counter()
    out = os.path.join(tmp, "p10")
    os.makedirs(out)
    _spawn_ranks("10a", 2, "_p10a_rank", (os.path.join(out, "store"), out))
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(2)]
    t10a = time.perf_counter() - t0
    for k in ranks[0]:
        if not k.endswith(("secs", "halves")) and \
                ranks[0][k].tobytes() != ranks[1][k].tobytes():
            raise PhaseError(f"10a: the two model ranks differ in {k}")
    rec = ranks[0]
    if str(rec["plain_differs"]):
        raise PhaseError(f"10a: a 7f chunk at (1, 2) with the kernels != on "
                         f"the plain step: {rec['plain_differs']}")
    launches = {k: int(sum(r["launches"][i] for r in ranks))
                for i, k in enumerate(_COUNTERS)}
    for r in ranks:
        for i, k in enumerate(("step", "raster")):
            if r["launches"][i] <= 0:
                raise PhaseError(f"10a: kernel {k} was not launched in a "
                                 f"rank")
    notes, faults = [], []
    for name, steps, first, build in _p10_runs():
        note, fault = _p10_compare(name, steps, first, build, rec,
                                   unsharded[name], secs9[name])
        notes.append(note)
        faults += fault
    log(f"phase 10a tensor parallelism at (data, model) = (1, 2), two ranks "
        f"over gloo on cuda:0 ({card}; gloo on one card, not NCCL across "
        f"cards), against 9c's unsharded runs: " + "; ".join(notes))
    log(f"phase 10a seconds per 7f actor / learner half at (1, 2): "
        f"{rec['halves'][0]:.4f} / {rec['halves'][1]:.4f} (medians of "
        f"{P10_HALVES}); model-axis collectives a learner step: "
        f"{int(rec['collectives'][0])} all_gather, "
        f"{int(rec['collectives'][1])} all_reduce; kernel launches (both "
        f"ranks) {launches}; {t10a:.1f} s")
    if faults:
        raise PhaseError("; ".join(faults))
    # 10c: the (1, 2) checkpoint restored unsharded continues identically
    with _deterministic():
        init_fn, _, chunk_fn, _ = dqn.make_train(_p9_dqn_configs()[0], "cuda")
        st, _ = chunk_fn(restore_checkpoint(os.path.join(out, "dqn7f.pt"),
                                            "cuda"), P10_CONT)
    learned, digests = _p10_split(_np_state(st))
    got_d = {k[len("cont/digest/"):]: v for k, v in rec.items()
             if k.startswith("cont/digest/")}
    div = _p10_first_divergence(got_d, digests)
    if div is not None:
        raise PhaseError(f"10c: the restored unsharded run diverges from the "
                         f"(1, 2) run at {div}")
    worst, share, where = _p10_drift(
        {k[len("cont/learned/"):]: v for k, v in rec.items()
         if k.startswith("cont/learned/")}, learned)
    if share > 1:
        raise PhaseError(f"10c: learned floats {worst:.3g} from the restored "
                         f"unsharded run, {share:.3g} of the tolerance (at "
                         f"{where})")
    log(f"phase 10c the 7f state saved at (1, 2) and restored unsharded: "
        f"{P10_CONT} more steps with env rows, ring and obs bitwise, the "
        f"learned floats within {worst:.3g} ({share:.2f} of the tolerance); "
        f"the (1, 2) chunk bitwise on the plain step")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        graft_entry.dryrun_multichip(4, "cuda", backend="gloo")
    log(f"phase 10b dryrun_multichip(4) over gloo on the one card: "
        f"{' | '.join(said.getvalue().strip().splitlines())}; "
        f"{time.perf_counter() - t1:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 11

@contextlib.contextmanager
def _count_grad_reduces():
    """Within the block, count the learner's gradient sums
    (``DataParallel.grads`` calls) and the ``all_reduce`` calls they make;
    yields the dict of counts."""
    import torch.distributed as dist
    from gym_simpletetris_tpu_torch.train import sharding
    counts = {"grads": 0, "all_reduce": 0}
    inside = [False]
    saved_grads, saved_reduce = sharding.DataParallel.grads, dist.all_reduce

    def grads(self, *a, **kw):
        counts["grads"] += 1
        inside[0] = True
        try:
            return saved_grads(self, *a, **kw)
        finally:
            inside[0] = False

    def all_reduce(*a, **kw):
        counts["all_reduce"] += inside[0]
        return saved_reduce(*a, **kw)

    sharding.DataParallel.grads, dist.all_reduce = grads, all_reduce
    try:
        yield counts
    finally:
        sharding.DataParallel.grads, dist.all_reduce = saved_grads, saved_reduce


def _p11a_rank(rank: int, store: str, outdir: str):
    """11a's rank at (data, model) = (2, 1) over gloo on cuda:0: each
    trainer to its first learner update and through its run, gathered to
    the global state (every rank holds it)."""
    import numpy as np
    import torch
    _import_port()
    from torch.distributed.device_mesh import init_device_mesh
    from gym_simpletetris_tpu_torch.parallel import mesh as M
    from gym_simpletetris_tpu_torch.train.sharding import gather_train_state
    M.init_distributed(f"file://{store}", 2, rank, backend="gloo")
    torch.use_deterministic_algorithms(True)
    try:
        mesh = init_device_mesh("cuda", (2, 1),
                                mesh_dim_names=("data", "model"))
        _reset_counters()
        rec = {}
        for name, steps, first, build in _trainer_runs():
            init_fn, run = build(mesh)
            if first:
                st, _ = run(init_fn(0), first)
                learned, digests = _p10_split(_np_state(
                    gather_train_state(st, mesh)))
                rec.update({f"{name} first/learned/{k}": v
                            for k, v in learned.items()})
                rec.update({f"{name} first/digest/{k}": v
                            for k, v in digests.items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _count_grad_reduces() as counts:
                st, metrics = run(init_fn(0), steps)
                torch.cuda.synchronize()
            rec[f"{name}/secs"] = np.array(time.perf_counter() - t0)
            rec[f"{name}/grad_reduces"] = np.array([counts["grads"],
                                                    counts["all_reduce"]])
            learned, digests = _p10_split(_np_state(
                gather_train_state(st, mesh)))
            rec.update({f"{name}/learned/{k}": v for k, v in learned.items()})
            rec.update({f"{name}/digest/{k}": v for k, v in digests.items()})
            rec.update({f"{name}/metric/{k}": v.cpu().numpy()
                        for k, v in metrics.items()})
        rec["launches"] = np.array([_launches()[k] for k in _COUNTERS])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        M.shutdown()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **rec)


def _fmt_drift(drift) -> str:
    """A ``_p10_drift`` reading: bitwise, or the largest difference, its
    share of the CPU tolerance and where that share is."""
    worst, share, where = drift
    if worst == 0:
        return "bitwise"
    return f"{worst:.3g} ({share:.3g} of the CPU tolerance, at {where})"


def phase_dp(card, unsharded: dict, secs9: dict, tmp):
    """Phase 11a: the sharded learner above one rank (gradients summed in
    float32 at the layers' cast points, then rounded once) on the card.
    Two ranks at (data, model) = (2, 1) over gloo on cuda:0 run 9c's four
    trainers, each rank half of every batch, held to 9c's unsharded runs:
    the gathered state bitwise up to each DQN's first learner update (env
    rows, the ring, the obs; PPO's env rows and obs after its collection;
    ES theta after its generation). After it the learned floats'
    distance, against the CPU tests' tolerance, and the first divergence
    are printed, not held: gloo on one card is not a user's NCCL across
    cards. Returns the ranks' launches."""
    import numpy as np
    t0 = time.perf_counter()
    out = os.path.join(tmp, "p11")
    os.makedirs(out)
    _spawn_ranks("11a", 2, "_p11a_rank", (os.path.join(out, "store"), out))
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(2)]
    t11a = time.perf_counter() - t0
    for k in ranks[0]:
        if not k.endswith(("secs", "launches")) and \
                ranks[0][k].tobytes() != ranks[1][k].tobytes():
            raise PhaseError(f"11a: the two data ranks' gathered {k} differ")
    rec = ranks[0]
    launches = {k: int(sum(r["launches"][i] for r in ranks))
                for i, k in enumerate(_COUNTERS)}
    for r in ranks:
        if r["launches"][0] <= 0:
            raise PhaseError("11a: kernel step was not launched in a rank")
    no_ring = lambda d: {k: v for k, v in d.items()
                         if not k.startswith("replay.")}
    notes, faults = [], []
    for name, steps, first, build in _trainer_runs():
        state, metrics = unsharded[name]
        learned, digests = _p10_split(state)
        got_d = _p10_learned(rec, f"{name}/digest/")
        got_l = _p10_learned(rec, f"{name}/learned/")
        if first:
            init_fn, run = build(None)
            with _deterministic():
                st1, _ = run(init_fn(0), first)
            l1, d1 = _p10_split(_np_state(st1))
            div1 = _p10_first_divergence(
                _p10_learned(rec, f"{name} first/digest/"), d1)
            if div1 is not None:
                faults.append(f"11a {name}: differs from the unsharded run "
                              f"at {div1} by its first learner update")
            held = _p10_drift(_p10_learned(rec, f"{name} first/learned/"),
                              no_ring(l1))
            div = _p10_first_divergence(got_d, digests)
            stream = (f"bitwise up to the first learner update (step "
                      f"{first}); after it " + (
                          "bitwise to the end" if div is None else
                          f"first diverges at {div[0]} slot {div[1]}"))
        else:
            held = None
            div = _p10_first_divergence(got_d, digests)
            if div is not None:
                faults.append(f"11a {name}: differs from the unsharded run "
                              f"at {div}")
            stream = ("env rows and obs of the collection bitwise"
                      if name.startswith("ppo") else "theta bitwise")
        end = _p10_drift(got_l, no_ring(learned))
        m_end = _p10_drift({k: rec[f"{name}/metric/{k}"] for k in metrics},
                           metrics)
        dists = [end[0], end[1], m_end[0]] + ([held[0], held[1]] if held
                                               else [])
        if not all(math.isfinite(d) for d in dists):
            faults.append(f"11a {name}: a non-finite distance {dists}")
        g, ar = (int(x) for x in rec[f"{name}/grad_reduces"])
        reduces = (f"{ar / g:g} gradient all_reduce a learner step ({g} "
                   f"learner steps)" if g else "no learner gradient")
        first_note = (f"after the first learner update {_fmt_drift(held)}, "
                      if held else "")
        notes.append(
            f"{name}: {stream}; learned floats {first_note}at the end "
            f"{_fmt_drift(end)}; metrics {_fmt_drift(m_end)}; "
            f"{float(rec[f'{name}/secs']) / steps:.4f} s a "
            f"step (9c world 1: {secs9[name] / steps:.4f}); {reduces}")
    log(f"phase 11a sharded learner at (data, model) = (2, 1), two ranks "
        f"over gloo on cuda:0 ({card}; gloo on one card, not NCCL across "
        f"cards), against 9c's unsharded runs: " + "; ".join(notes) +
        f"; kernel launches (both ranks) {launches}; {t11a:.1f} s")
    if faults:
        raise PhaseError("; ".join(faults))
    return launches


P11_SOAK = (   # 11b: (what, tools/torch_soak_fuzz.py arguments)
    ("kernel A, every instance", ["--instances", "all", "--configs", "16",
                                  "--batch", "256", "--steps", "512",
                                  "--seed", "11"]),
    ("kernel B at 84 px", ["--pixels", "--configs", "4", "--batch", "256",
                           "--steps", "256", "--seed", "11"]),
    ("kernel B at 512 px", ["--pixels", "--pixel-size", "512", "--configs",
                            "2", "--batch", "32", "--steps", "64", "--seed",
                            "11"]))


def phase_soak(card):
    """Phase 11b: ``tools/torch_soak_fuzz.py`` in this process: random
    configurations (widths to 56, heights to 64, lock delays to 8, every
    flag, six action scripts) replayed on the card bitwise against the
    port's C++ oracle, through every instance of kernel A each board
    admits, and kernel B's images pixel-exact to the host raster. Returns
    its launches."""
    torch_soak_fuzz = _tool("torch_soak_fuzz")
    _reset_counters()
    notes = []
    for what, argv in P11_SOAK:
        res = torch_soak_fuzz.soak(torch_soak_fuzz.parse_args(argv),
                                   out=lambda *a, **k: None)
        inst = ", ".join(f"{k} {v['configs']} configs / {v['launches']} "
                         f"launches" for k, v in sorted(
                             res["instances"].items()))
        notes.append(f"{what} ({' '.join(argv)}): {res['steps']} steps "
                     f"bitwise across {res['configs']} configs, instances "
                     f"{inst}; {res['pixel_steps']} images pixel-exact; "
                     f"{res['seconds']:.1f} s")
    launches = _launches()
    for k in ("step", "raster"):
        if launches[k] <= 0:
            raise PhaseError(f"11b: kernel {k} was not launched")
    log(f"phase 11b soak fuzz against the C++ oracle ({card}): "
        + "; ".join(notes) + f"; kernel launches {launches}")
    return launches


P13_SOAK = ["--configs", "12", "--steps", "300", "--seed", "18"]


def phase_shim_soak(card):
    """Phase 13: ``tools/torch_soak_shim.py`` in this process: the gym shim
    and ``TetrisEngine`` on the card against the port's C++ oracle, and
    ``NativeTetrisEnv`` against the CPU plain path, over random
    configurations at B = 1. Returns its launches."""
    torch_soak_shim = _tool("torch_soak_shim")
    _reset_counters()
    try:
        res = torch_soak_shim.soak(torch_soak_shim.parse_args(P13_SOAK),
                                   out=lambda *a, **k: None)
    except torch_soak_shim.SoakFailure as e:
        raise PhaseError(f"13: {e}") from e
    launches = _launches()
    for k in ("step", "raster"):
        if launches[k] <= 0:
            raise PhaseError(f"13: kernel {k} was not launched")
    per = "; ".join(
        f"{s} {v['configs']} configs, {v['steps']} steps, {v['episodes']} "
        f"episodes, {v['seconds']:.1f} s" for s, v in res["surfaces"].items())
    log(f"phase 13 shim soak against the C++ oracle ({card}; "
        f"{' '.join(P13_SOAK)}): {res['steps']} lockstep steps bitwise "
        f"({per}); {res['renders']} renders at 160 px pixel-exact; "
        f"{res['steps'] / res['seconds']:.1f} steps/s; kernel launches "
        f"{launches}; {res['seconds']:.1f} s")
    return launches


def main() -> int:
    # deterministic cuBLAS for the DQN phases' kernel-against-plain chunk;
    # it must be set before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    secs, t_last = {}, time.perf_counter()

    def took(name):
        nonlocal t_last
        now = time.perf_counter()
        secs[name] = round(now - t_last, 1)
        t_last = now

    try:
        _import_port()
        card = phase_device()
        took("1")
        step_err, board_rows = phase_step_kernel()
        raster_err = phase_raster_kernels(board_rows)
        took("2-3")
        wide_step_err, wide_boards = phase_wide_step_kernel()
        wide_raster_err = phase_wide_raster_kernels(wide_boards)
        took("2w-3w")
        phase_golden()
        launches, envs = phase_main_path({}, "phase 5 main path")
        wide_launches, wide_envs = phase_main_path(
            WIDE_MAIN, "phase 5w wide main path")
        took("4-5w")
        import numpy as np
        from gym_simpletetris_tpu_torch import EnvConfig
        rng = np.random.RandomState(12)
        w40 = EnvConfig(width=40, height=26)
        _, ms, dev = phase_timing(
            envs, {}, "phase 6 timing",
            [(EnvConfig(), _random_rows(EnvConfig(), B_MAIN, rng), 160)],
            STEP_TIMED_B)
        _, wide_ms, wide_dev = phase_timing(
            wide_envs, WIDE_MAIN, "phase 6w wide timing",
            [(w40, _random_rows(w40, 1024, rng), 512)])
        took("6-6w")
        draw = phase_draw_kernel()
        took("6d")
        reset = phase_reset_kernel()
        took("6r")
        noise = phase_noise_kernel()
        took("6n")
        trainer_err = phase_trainer_path()
        took("7a-7e")
        import tempfile
        with tempfile.TemporaryDirectory(prefix=".dqn_smoke_",
                                         dir=ROOT) as tmp:
            dqn_launches = phase_dqn(tmp)
            took("7f-7h")
            ring_launches = phase_frame_rings()
            took("7i-7j")
            es_launches = phase_es(tmp)
            took("7k-7l")
        surface_launches = phase_surfaces()
        took("8a-8f")
        with tempfile.TemporaryDirectory(prefix=".mesh_smoke_",
                                         dir=ROOT) as tmp:
            mesh_launches, unsharded, secs9 = phase_mesh(card, tmp)
        took("9a-9e")
        with tempfile.TemporaryDirectory(prefix=".tp_smoke_",
                                         dir=ROOT) as tmp:
            tp_launches = phase_tp(card, unsharded, secs9, tmp)
        took("10a-10c")
        with tempfile.TemporaryDirectory(prefix=".dp_smoke_",
                                         dir=ROOT) as tmp:
            dp_launches = phase_dp(card, unsharded, secs9, tmp)
        took("11a")
        soak_launches = phase_soak(card)
        took("11b")
        shim_soak_launches = phase_shim_soak(card)
        took("13")
        log(f"seconds by phase: {secs}")
    except Exception as e:   # the run's boundary: report and fail
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    pkg = "gym_simpletetris_tpu_torch/csrc/"
    kernels = []
    total = {k: v + sum(part.get(k, 0) for part in (
        dqn_launches, ring_launches, es_launches, surface_launches,
        mesh_launches, tp_launches, dp_launches, soak_launches,
        shim_soak_launches)) for k, v in launches.items()}
    for suffix, n, err, t, d in (
            ("", total,
             {k: max(v, trainer_err.get(k, 0.0)) for k, v in
              dict(raster_err, step=step_err).items()}, ms, dev),
            ("_wide", wide_launches, dict(wide_raster_err, step=wide_step_err),
             wide_ms, wide_dev)):
        for name, src, replaces in (
                ("step", "step.cu", "pallas_step.py:99"),
                ("raster", "raster.cu", "pallas_raster.py:38"),
                ("raster_accumulate", "raster.cu", "pallas_raster.py:151")):
            kernels.append(dict(
                name=name + suffix, route="cuda", source=pkg + src,
                replaces="gym_simpletetris_tpu/ops/" + replaces,
                launches=n[name], max_abs_err=err[name], ms=t[name][0],
                plain_ms=t[name][1], bound_ms=d[name]["bound_us"] / 1e3,
                bound_by="bytes", library_ms=None, **d[name]))
    kernels.append(dict(
        name="draw", route="cuda", source=pkg + "draw.cu", replaces=None,
        launches=total["draw"], max_abs_err=0.0,
        ms=draw["wrapper_us"] / 1e3, plain_ms=draw["plain_wrapper_us"] / 1e3,
        device_us=draw["device_us"],
        plain_device_us=draw["plain_device_us"], bound_by="launch",
        library_ms=None))
    for B, r in reset.items():
        kernels.append(dict(
            name=f"reset:B={B}", route="cuda", source=pkg + "reset.cu",
            replaces=None, launches=total["reset"], max_abs_err=0.0,
            ms=r["wrapper_us"] / 1e3, plain_ms=r["replaced_wrapper_us"] / 1e3,
            bound_ms=r["bound_us"] / 1e3, bound_by="bytes", library_ms=None,
            **r))
    for layer, r in noise.items():
        kernels.append(dict(
            name="noise:" + layer, route="cuda", source=pkg + "noise.cu",
            replaces=None, launches=total["noise"], max_abs_err=0.0,
            ms=r["wrapper_us"] / 1e3, plain_ms=r["plain_wrapper_us"] / 1e3,
            bound_ms=r["bound_us"] / 1e3, bound_by="bytes", library_ms=None,
            **r))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
