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
beside it), the raster kernels also at 160 and 512 px.
Then the trainer
path: the lookahead heuristic (kernel A at 7 * B), the greedy evaluation of
the line-clear PPO checkpoint (``artifacts/ppo_lineclear_params.npz``; it
must clear at least 4 lines per episode), and PPO updates through
``run_ppo`` for ram and grayscale, with their kernel launches counted; each
is held bitwise to a run on the plain step and raster (heuristic and PPO
collection whole, the evaluation's first 500 steps), and kernels A and B to
their plain versions at the trainer's batch sizes and env flags. One line per phase; then a JSON line of the
kernels, the card's name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure, or no CUDA device, exits nonzero without that line. Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B_MAIN = 4096
STEPS = 256
FLAG_SETS = (
    dict(),
    dict(reward_step=True, advanced_clears=True, penalise_height=True,
         penalise_holes=True),
    dict(high_scoring=True, penalise_height_increase=True,
         penalise_holes_increase=True, lock_delay=2, step_reset=True),
    dict(width=9, height=12, lock_delay=3),
    dict(width=24, reward_step=True, penalise_holes_increase=True),  # bit 31
)
# Wide boards (multi-word rows): (flags, batch sizes). NW = 2, 2, 2, 3, 4, 33.
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
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; kernels built in "
        f"{info['seconds']:.2f} s ({info['path'].name}); ptxas: {regs}")
    return card


def _prefilled_state(cfg, B, rng, device):
    """A cleared state whose lower rows are full but for one hole each, so
    random play clears lines, scores and dies."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.core.state import init_state, rows_shape
    s = init_state(cfg, B, int(rng.randint(0, 2 ** 31)), device)
    s, _ = E.engine_clear(cfg, s, injected_r=torch.as_tensor(
        rng.randint(1, 36, B), device=device))
    H, nw = cfg.height, cfg.num_words
    rows = np.zeros((H, nw, B), np.uint32)
    depth = rng.randint(0, H // 2 + 1, B)
    for b in range(B):
        for y in range(H - depth[b], H):
            full = cfg.valid_mask & ~(1 << (4 + rng.randint(0, cfg.width)))
            rows[y, :, b] = [(full >> (32 * w)) & 0xFFFFFFFF for w in range(nw)]
    rows = rows.reshape(rows_shape(cfg, B))
    return s.replace(rows=torch.from_numpy(rows.view(np.int32)).to(device))


def _diff(a, b):
    """(any difference, max |a - b|) as device tensors, bitwise for floats."""
    import torch
    if a.dtype == torch.float32:
        return (a.view(torch.int32) != b.view(torch.int32)).any(), \
            (a - b).abs().max()
    ai, bi = a.to(torch.int64), b.to(torch.int64)
    return (ai != bi).any(), (ai - bi).abs().max().to(torch.float32)


def _check_step_kernel(cases, steps, seed0):
    """Each (flags, batch sizes) case: ``steps`` steps of the step kernel and
    of the plain step from the same prefilled state, every field compared.
    Returns (max_abs_err, comparisons, {(cfg, B): last emitted rows})."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.api.env import apply_reset_mask
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.core.state import FIELDS
    dev = torch.device("cuda")
    max_err, n_cmp, last = 0.0, 0, {}
    for fi, (flags, batches) in enumerate(cases):
        cfg = EnvConfig(**flags)
        for B in batches:
            rng = np.random.RandomState(seed0 + 1000 * fi + B)
            s_k = s_p = _prefilled_state(cfg, B, rng, dev)
            even = torch.arange(B, device=dev) % 2 == 0
            bad, errs = [], []
            n_done = torch.zeros((), dtype=torch.int64, device=dev)
            n_lines = torch.zeros((), dtype=torch.int64, device=dev)
            for t in range(steps):
                a = torch.as_tensor(rng.randint(0, 7, B), device=dev)
                r = torch.as_tensor(rng.randint(1, 36, B), device=dev)
                o_k = E.engine_step(cfg, s_k, a, injected_r=r)
                o_p = E.engine_step_plain(cfg, s_p, a, injected_r=r)
                pairs = [(getattr(o_k.state, f), getattr(o_p.state, f))
                         for f in FIELDS] + [
                    (o_k.emitted_rows, o_p.emitted_rows),
                    (o_k.reward, o_p.reward), (o_k.done, o_p.done)]
                d = [_diff(x, y) for x, y in pairs]
                bad.append(torch.stack([x for x, _ in d]))
                errs.append(torch.stack([e for _, e in d]).max())
                n_done += o_k.done.sum()
                n_lines += (o_k.state.lines_cleared
                            - s_k.lines_cleared).sum()
                # odd lanes step on past death; even lanes start a new episode
                mask = o_k.done & even
                s_k = apply_reset_mask(cfg, o_k.state, o_k.emitted_rows, mask)[0]
                s_p = apply_reset_mask(cfg, o_p.state, o_p.emitted_rows, mask)[0]
            bad = torch.stack(bad).cpu().numpy()
            max_err = max(max_err, float(torch.stack(errs).max()))
            n_cmp += bad.size
            if bad.any():
                t, f = np.argwhere(bad)[0]
                names = list(FIELDS) + ["emitted", "reward", "done"]
                raise PhaseError(
                    f"step kernel != plain: {flags} B={B} first at step {t}, "
                    f"field {names[f]}")
            last[cfg, B] = o_k.emitted_rows
            log(f"  step kernel == plain: {flags or 'default'} B={B} "
                f"NW={cfg.num_words}: {steps} steps, {int(n_done)} done "
                f"flags, {int(n_lines)} lines")
    return max_err, n_cmp, last


def phase_step_kernel():
    from gym_simpletetris_tpu_torch import EnvConfig
    cases = [(flags, (B_MAIN, 1000)) for flags in FLAG_SETS]
    max_err, n_cmp, last = _check_step_kernel(cases, STEPS, 0)
    log(f"phase 2 step kernel: bitwise equal to the plain step in {n_cmp} "
        f"field comparisons (max_abs_err {max_err})")
    return max_err, last[EnvConfig(), B_MAIN]


def phase_wide_step_kernel():
    max_err, n_cmp, last = _check_step_kernel(WIDE_CASES, WIDE_STEPS, 500)
    log(f"phase 2w wide step kernel: bitwise equal to the plain step at "
        f"widths {[f['width'] for f, _ in WIDE_CASES]} in {n_cmp} field "
        f"comparisons (max_abs_err {max_err})")
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


def _counters():
    from gym_simpletetris_tpu_torch.ops import cuda_raster, cuda_step
    return {"step": cuda_step.step, "raster": cuda_raster.rasterize_rows,
            "raster_accumulate": cuda_raster.raster_accumulate}


def phase_main_path(board: dict, label: str):
    """The main path on ``board`` (EnvConfig width / height): reset, 64
    steps and a T-step rollout for each obs type, the rollout held to the
    same steps taken one at a time. The kernel counts are set to 0 just
    before and read just after; each kernel must have launched."""
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
    dev = torch.device("cuda")
    for fn in _counters().values():
        fn.launches = 0
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
    launches = {k: fn.launches for k, fn in _counters().items()}
    for k, n in launches.items():
        if n <= 0:
            raise PhaseError(f"kernel {k} was not launched on the main path "
                             f"{board or 'default'}")
    log(f"{label}: kernel launches {launches}")
    return launches, envs


def phase_timing(envs, board: dict, label: str, extra=()):
    """For information only: env-steps/s of the rollout and each kernel's
    time at B = 4096 on ``board``: wrapper ms (CUDA events, Python and
    ctypes included) beside its plain version's, and device us
    (CUDA-graph replay) beside its bound, C with L2 evicted
    (``kernel_timing.raster_device_times``). ``extra``: more
    (cfg, rows, size) at which to time the raster kernels' device us."""
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
    step_us = kt.device_us(lambda: cuda_step.step(cfg, s, a, r, key))
    step_bound = kt.bound_us(kt.step_bytes(cfg, B_MAIN))
    dev = {"step": dict(device_us=step_us, bound_us=step_bound,
                        bound_share=step_bound / step_us)}
    dev.update(kt.raster_device_times(cfg, rows, 84))
    log(f"{label} (information only, {cfg.width}x{cfg.height}, B={B_MAIN}, "
        f"T={STEPS}): "
        "env-steps/s of the rollout, 3 runs sorted: "
        + ", ".join(f"{o} {[round(v) for v in r]}" for o, r in rates.items())
        + "; kernel wrapper ms "
        + ", ".join(f"{k} {a:.5f} (plain {p:.5f})" for k, (a, p) in ms.items())
        + f"; device at 84 px: {_fmt_device(dev)}")
    for xcfg, xrows, size in extra:
        log(f"  {label}, raster kernels at {size} px, {xcfg.width}x"
            f"{xcfg.height}, B={xrows.shape[-1]}: "
            + _fmt_device(kt.raster_device_times(xcfg, xrows, size)))
    return rates, ms, dev


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


def _launches() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


@contextlib.contextmanager
def _plain_path():
    """The trainer path on the plain versions, for a comparison run: the env
    step and raster of ``api.env`` and the heuristic's lookahead step."""
    from gym_simpletetris_tpu_torch.api import env as api_env
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.models import heuristic
    from gym_simpletetris_tpu_torch.ops import raster
    saved = E.engine_step, api_env.rasterize_rows, heuristic.engine_step
    E.engine_step = heuristic.engine_step = E.engine_step_plain
    api_env.rasterize_rows = raster.rasterize_rows_plain
    try:
        yield
    finally:
        E.engine_step, api_env.rasterize_rows, heuristic.engine_step = saved


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
    import math
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
    for fn in _counters().values():
        fn.launches = 0
    parts = (phase_heuristic(), phase_greedy_eval(), phase_ppo())
    launches = {k: sum(p[k] for p in parts) for k in parts[0]}
    log(f"phase 7 trainer path: kernel launches {launches}")
    for k in ("step", "raster"):
        if launches[k] <= 0:
            raise PhaseError(f"kernel {k} was not launched on the trainer path")
    return phase_trainer_kernels()


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    try:
        _import_port()
        card = phase_device()
        step_err, board_rows = phase_step_kernel()
        raster_err = phase_raster_kernels(board_rows)
        wide_step_err, wide_boards = phase_wide_step_kernel()
        wide_raster_err = phase_wide_raster_kernels(wide_boards)
        phase_golden()
        launches, envs = phase_main_path({}, "phase 5 main path")
        wide_launches, wide_envs = phase_main_path(
            WIDE_MAIN, "phase 5w wide main path")
        import numpy as np
        from gym_simpletetris_tpu_torch import EnvConfig
        rng = np.random.RandomState(12)
        w40 = EnvConfig(width=40, height=26)
        _, ms, dev = phase_timing(
            envs, {}, "phase 6 timing",
            [(EnvConfig(), _random_rows(EnvConfig(), B_MAIN, rng), 160)])
        _, wide_ms, wide_dev = phase_timing(
            wide_envs, WIDE_MAIN, "phase 6w wide timing",
            [(w40, _random_rows(w40, 1024, rng), 512)])
        trainer_err = phase_trainer_path()
    except Exception as e:   # the run's boundary: report and fail
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    pkg = "gym_simpletetris_tpu_torch/csrc/"
    kernels = []
    for suffix, n, err, t, d in (
            ("", launches, {k: max(v, trainer_err.get(k, 0.0)) for k, v in
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
