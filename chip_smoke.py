#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gym_simpletetris_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gym_simpletetris_tpu_torch/csrc`` with
nvcc, holds each kernel bitwise against its plain PyTorch version on the card,
replays the golden reference traces through the CUDA path, drives the main
path (``TetrisVectorEnv`` reset / step / rollout with auto_reset at B = 4096
for ram, grayscale and rgb) and times the kernels beside their plain
versions. One line per phase; then a JSON line of the kernels, the card's
name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure, or no CUDA device, exits nonzero without that line. Imports
nothing of JAX.
"""

from __future__ import annotations

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
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_traces.json")


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


def _sync_time(fn, n: int) -> float:
    """Milliseconds per call of ``fn`` on the card, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


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
    from gym_simpletetris_tpu_torch.core.state import init_state
    s = init_state(cfg, B, int(rng.randint(0, 2 ** 31)), device)
    s, _ = E.engine_clear(cfg, s, injected_r=torch.as_tensor(
        rng.randint(1, 36, B), device=device))
    H = cfg.height
    rows = np.zeros((H, B), np.uint32)
    depth = rng.randint(0, H // 2 + 1, B)
    for b in range(B):
        for y in range(H - depth[b], H):
            hole = np.uint32(1 << (4 + rng.randint(0, cfg.width)))
            rows[y, b] = np.uint32(cfg.valid_mask) & ~hole
    return s.replace(rows=torch.from_numpy(rows.view(np.int32)).to(device))


def _diff(a, b):
    """(any difference, max |a - b|) as device tensors, bitwise for floats."""
    import torch
    if a.dtype == torch.float32:
        return (a.view(torch.int32) != b.view(torch.int32)).any(), \
            (a - b).abs().max()
    ai, bi = a.to(torch.int64), b.to(torch.int64)
    return (ai != bi).any(), (ai - bi).abs().max().to(torch.float32)


def phase_step_kernel():
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.api.env import apply_reset_mask
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.core.state import FIELDS
    dev = torch.device("cuda")
    max_err, n_cmp, last = 0.0, 0, {}
    for fi, flags in enumerate(FLAG_SETS):
        cfg = EnvConfig(**flags)
        for B in (B_MAIN, 1000):
            rng = np.random.RandomState(1000 * fi + B)
            s_k = s_p = _prefilled_state(cfg, B, rng, dev)
            even = torch.arange(B, device=dev) % 2 == 0
            bad, errs = [], []
            n_done = torch.zeros((), dtype=torch.int64, device=dev)
            n_lines = torch.zeros((), dtype=torch.int64, device=dev)
            for t in range(STEPS):
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
            if cfg == EnvConfig():
                last[B] = o_k.emitted_rows
            log(f"  step kernel == plain: {flags or 'default'} B={B}: "
                f"{STEPS} steps, {int(n_done)} done flags, {int(n_lines)} lines")
    log(f"phase 2 step kernel: bitwise equal to the plain step in {n_cmp} "
        f"field comparisons (max_abs_err {max_err})")
    return max_err, last


def phase_raster_kernels(boards):
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.ops import cuda_raster, raster
    dev = torch.device("cuda")
    rng = np.random.RandomState(7)
    err = {"raster": 0.0, "raster_accumulate": 0.0}
    cases = [(EnvConfig(), boards[B_MAIN], "phase-2 boards")]
    for w, h in ((10, 20), (9, 12), (4, 5), (24, 20)):
        cfg = EnvConfig(width=w, height=h)
        words = rng.randint(0, 2 ** 32, (h, B_MAIN), dtype=np.uint64)
        rows = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
        cases.append((cfg, rows, f"random {w}x{h}"))
    for size in (84, 160):
        for cfg, rows, what in cases:
            if size != 84 and what != "phase-2 boards":
                continue
            got = cuda_raster.rasterize_rows(cfg, rows, size)
            want = raster.rasterize_rows_plain(cfg, rows, size)
            e = (got.int() - want.int()).abs().max().item()
            err["raster"] = max(err["raster"], e)
            if e:
                raise PhaseError(f"raster kernel != plain: {what} at {size}px")
            acc = torch.as_tensor(rng.randint(0, 256, got.shape, dtype=np.uint8),
                                  device=dev)
            acc_k, acc_p = acc.clone(), acc.clone()
            for _ in range(3):    # three folds: every pixel value wraps
                cuda_raster.raster_accumulate(cfg, rows, acc_k, size)
                raster.raster_accumulate_plain(cfg, rows, acc_p, size)
            e = (acc_k.int() - acc_p.int()).abs().max().item()
            err["raster_accumulate"] = max(err["raster_accumulate"], e)
            if e:
                raise PhaseError(
                    f"raster-accumulate kernel != plain: {what} at {size}px")
    # an odd batch whose image bytes do not end on a word
    cfg = EnvConfig(width=4, height=5)
    rows = cases[3][1][:, :3].contiguous()
    got = cuda_raster.rasterize_rows(cfg, rows, 83)
    if not torch.equal(got, raster.rasterize_rows_plain(cfg, rows, 83)):
        raise PhaseError("raster kernel != plain at B=3, 83 px")
    log(f"phase 3 raster kernels: bitwise equal to the plain raster and "
        f"raster-accumulate on {len(cases)} board sets at B={B_MAIN}, 84 px "
        f"(and 160 px on the phase-2 boards)")
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


def phase_main_path():
    import numpy as np
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
    dev = torch.device("cuda")
    for fn in _counters().values():
        fn.launches = 0
    envs = {}
    for o in ("ram", "grayscale", "rgb"):
        cfg = EnvConfig(obs_type=o, auto_reset=True)
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
        log(f"  main path {o}: reset + 64 steps + rollout T={STEPS} at "
            f"B={B_MAIN}; rollout == step loop; {int(don.sum())} episodes ended, "
            f"mean reward {float(rew.mean()):.4f}")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in _counters().items()}
    for k, n in launches.items():
        if n <= 0:
            raise PhaseError(f"kernel {k} was not launched on the main path")
    log(f"phase 5 main path: kernel launches {launches}")
    return launches, envs


def phase_timing(envs):
    """For information only: env-steps/s of the rollout and each kernel's time
    beside its plain version's, at B = 4096."""
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.ops import cuda_raster, cuda_step, raster
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
    cfg = EnvConfig()
    env, s, acts = envs["grayscale"]
    key, r = E.spawn_draw(s, None)
    a = acts[0].to(torch.int32).contiguous()
    out = E.transition_plain(cfg, s, a, r, key)
    rows = out.emitted_rows
    acc = torch.zeros((B_MAIN, 84, 84), dtype=torch.uint8, device=rows.device)
    ms = {
        "step": (_sync_time(lambda: cuda_step.step(cfg, s, a, r, key), 200),
                 _sync_time(lambda: E.transition_plain(cfg, s, a, r, key), 50)),
        "raster": (_sync_time(lambda: cuda_raster.rasterize_rows(cfg, rows), 200),
                   _sync_time(lambda: raster.rasterize_rows_plain(cfg, rows), 50)),
        "raster_accumulate": (
            _sync_time(lambda: cuda_raster.raster_accumulate(cfg, rows, acc), 200),
            _sync_time(lambda: raster.raster_accumulate_plain(cfg, rows, acc), 50)),
    }
    log(f"phase 6 timing (information only, B={B_MAIN}, T={STEPS}): "
        "env-steps/s of the rollout, 3 runs sorted: "
        + ", ".join(f"{o} {[round(v) for v in r]}" for o, r in rates.items())
        + "; kernel ms "
        + ", ".join(f"{k} {a:.5f} (plain {p:.5f})" for k, (a, p) in ms.items()))
    return rates, ms


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
        step_err, boards = phase_step_kernel()
        raster_err = phase_raster_kernels(boards)
        phase_golden()
        launches, envs = phase_main_path()
        rates, ms = phase_timing(envs)
    except Exception as e:   # the run's boundary: report and fail
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    pkg = "gym_simpletetris_tpu_torch/csrc/"
    kernels = [
        dict(name="step", route="cuda", source=pkg + "step.cu",
             replaces="gym_simpletetris_tpu/ops/pallas_step.py:99",
             launches=launches["step"], max_abs_err=step_err,
             ms=ms["step"][0], plain_ms=ms["step"][1]),
        dict(name="raster", route="cuda", source=pkg + "raster.cu",
             replaces="gym_simpletetris_tpu/ops/pallas_raster.py:38",
             launches=launches["raster"], max_abs_err=raster_err["raster"],
             ms=ms["raster"][0], plain_ms=ms["raster"][1]),
        dict(name="raster_accumulate", route="cuda", source=pkg + "raster.cu",
             replaces="gym_simpletetris_tpu/ops/pallas_raster.py:151",
             launches=launches["raster_accumulate"],
             max_abs_err=raster_err["raster_accumulate"],
             ms=ms["raster_accumulate"][0], plain_ms=ms["raster_accumulate"][1]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
