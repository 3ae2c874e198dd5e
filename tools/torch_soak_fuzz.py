#!/usr/bin/env python3
"""Randomized soak fuzz of the PyTorch port against its C++ oracle: the
port's counterpart of ``tools/soak_fuzz.py``.

Draws random configurations (widths 4..56, so rows of one and two words;
heights 4..64; lock delays 0..8; every scoring flag) and one of six action
scripts per configuration, with ``tools/soak_fuzz.py``'s sampler: the same
draws from ``np.random.RandomState(seed)`` in the same order, so a seed
fuzzes the same games in both tools and each configuration's summary line
(width, height, lock delay, script, flags, deaths) is the same string.

  uniform       all 7 actions equally
  drop-heavy    ~43% hard drops: a lock every ~2 steps
  rotate-drop   rotations and hard drops: rotated masks at lock time
  stack-clear   soft drops and laterals: dense rows, many line clears
  ledge-slide   rest / slide / rest under a forced lock delay 1..8: the
                stale lock counter of a piece that slides off a ledge
  spawn-overlap hard drops on forced 4-5 wide boards: the spawn-overlap
                erase

Each configuration runs B games of T steps in the port's C++ oracle
(``native.drive_many``), which also records its spawn draws. The port then
replays them on its device: ``init_state``, ``engine_clear`` on the first
draws, and per step ``engine_step`` on the step's draws and
``api.env.apply_reset_mask`` on the reset's. The emitted boards, rewards,
dones and the final deaths and shape counts must equal the oracle's bit
for bit. On a CUDA card the step is kernel A (``csrc/step.cu``); the clear
and the selects are plain torch on the card. ``--instances all`` runs each
configuration once through every instance of kernel A that its board
admits (``ops.cuda_step.instances_for``, forced through
``cuda_step._launch``), so the thread instances meet fuzzed boards at any
batch. ``--pixels`` also holds kernel B's image of every step pixel-exact
to the host raster (``ops.raster``) of the oracle's boards: at 84 px
through ``api.env.build_observation_storage`` (the rgb channel triple on
the first chunk too), at 160 / 512 px through
``ops.cuda_raster.rasterize_rows``; widths and heights are capped so that
a cell stays at least a pixel (84: 40, 160: 50, 512: 56).

The first mismatch stops the run with exit code 1 and names the
configuration, the script, the instance, the env and the step. Without
``--cpu`` the tool needs a CUDA card and exits 2 where there is none.

    python3 tools/torch_soak_fuzz.py --cpu --configs 6 --batch 8 --steps 64
    python3 tools/torch_soak_fuzz.py --instances all --configs 200 \\
        --batch 1024 --steps 256 --seed 1
    python3 tools/torch_soak_fuzz.py --pixels --pixel-size 512 --configs 8

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLAG_KEYS = ("lock_delay", "step_reset", "reward_step", "penalise_height",
             "penalise_height_increase", "advanced_clears", "high_scoring",
             "penalise_holes", "penalise_holes_increase")

# L, R, HARD, SOFT, ROTL, ROTR, IDLE = 0..6
SCRIPTS = {
    "uniform": None,
    "drop-heavy": [0, 1, 2, 2, 2, 4, 5],
    "rotate-drop": [2, 4, 5, 4, 5, 2, 3],
    "stack-clear": [3, 3, 3, 0, 1, 2, 6],
    "ledge-slide": [6, 6, 3, 0, 0, 1, 1, 6, 3, 2],
    "spawn-overlap": [2, 2, 2, 2, 0, 1, 4],
}
PIXEL_CAPS = {84: 40, 160: 50, 512: 56}


class SoakFailure(AssertionError):
    """A replay that differs from the oracle."""


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="replay on the CPU (the plain engine); by default "
                         "on the CUDA card, through the kernels")
    ap.add_argument("--max-width", type=int, default=56,
                    help="widths 4..N; above 24 a row takes two words")
    ap.add_argument("--max-height", type=int, default=64)
    ap.add_argument("--max-lock-delay", type=int, default=8)
    ap.add_argument("--instances", choices=("plan", "all"), default="plan",
                    help="plan: kernel A's instance by its launch plan; "
                         "all: every instance the board admits (card only)")
    ap.add_argument("--pixels", action="store_true",
                    help="also hold the image of every step to the host "
                         "raster (uint8, pixel-exact)")
    ap.add_argument("--pixel-size", type=int, default=84,
                    choices=sorted(PIXEL_CAPS))
    ap.add_argument("--chunk-bytes", type=int, default=1 << 24,
                    help="--pixels: images compared at a time, in bytes")
    args = ap.parse_args(argv)
    if args.pixels:
        cap = PIXEL_CAPS[args.pixel_size]
        args.max_width = min(args.max_width, cap)
        args.max_height = min(args.max_height, cap)
    return args


def sample(args, rng):
    """The configurations, scripts, actions and oracle seeds, drawn as
    ``tools/soak_fuzz.py`` draws them: yields (index, EnvConfig, script,
    actions int32[T, B], seeds uint64[B])."""
    from gym_simpletetris_tpu_torch import EnvConfig
    B, T = args.batch, args.steps
    for ci in range(args.configs):
        cfg = EnvConfig(
            width=int(rng.randint(4, args.max_width + 1)),
            height=int(rng.randint(4, args.max_height + 1)),
            lock_delay=int(rng.choice(
                [0, 0, 1, 2, 5] + list(range(args.max_lock_delay + 1)))),
            step_reset=bool(rng.randint(2)),
            reward_step=bool(rng.randint(2)),
            penalise_height=bool(rng.randint(2)),
            penalise_height_increase=bool(rng.randint(2)),
            advanced_clears=bool(rng.randint(2)),
            high_scoring=bool(rng.randint(2)),
            penalise_holes=bool(rng.randint(2)),
            penalise_holes_increase=bool(rng.randint(2)),
        )
        script = list(SCRIPTS)[int(rng.randint(len(SCRIPTS)))]
        if script == "ledge-slide":
            cfg = cfg.replace(
                lock_delay=int(rng.randint(1, args.max_lock_delay + 1)),
                step_reset=bool(rng.randint(2)))
        elif script == "spawn-overlap":
            cfg = cfg.replace(width=int(rng.randint(4, 6)),
                              height=int(rng.randint(5, 10)))
        menu = SCRIPTS[script]
        if menu is None:
            actions = rng.randint(0, 7, size=(T, B)).astype(np.int32)
        else:
            actions = np.asarray(menu, np.int32)[
                rng.randint(0, len(menu), size=(T, B))]
        seeds = rng.randint(1, 1 << 31, B).astype(np.uint64)
        yield ci, cfg, script, actions, seeds


def summary_line(ci, n, cfg, script, deaths) -> str:
    """A configuration's line up to its verdict, as ``tools/soak_fuzz.py``
    prints it."""
    return (f"[{ci + 1}/{n}] w{cfg.width} h{cfg.height} ld{cfg.lock_delay} "
            f"{script:11s} flags="
            f"{''.join(str(int(getattr(cfg, k))) for k in FLAG_KEYS[1:])} "
            f"deaths={deaths}")


def replay(cfg, oracle, actions, device, instance=None):
    """The oracle's games on the port: (emitted rows [T, *rows], rewards
    [T, B], dones [T, B], final state). ``instance`` forces kernel A's."""
    import torch
    from gym_simpletetris_tpu_torch.api import env as api_env
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.core.state import init_state, rows_shape
    from gym_simpletetris_tpu_torch.ops import cuda_step
    T, B = actions.shape
    on = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    acts, r_step, r_clear = (on(actions), on(oracle["r_step"].T),
                             on(oracle["r_clear"].T))
    state = init_state(cfg, B, 0, device)
    state, _ = E.engine_clear(cfg, state, injected_r=on(oracle["r0"]))
    em = torch.empty((T,) + rows_shape(cfg, B), dtype=torch.int32,
                     device=device)
    rew = torch.empty((T, B), dtype=torch.float32, device=device)
    done = torch.empty((T, B), dtype=torch.bool, device=device)
    for t in range(T):
        if instance is None:
            o = E.engine_step(cfg, state, acts[t], injected_r=r_step[t])
        else:
            key, r = E.spawn_draw(state, r_step[t])
            o = cuda_step._launch(cfg, state, acts[t], r, key, instance)
        state, _ = api_env.apply_reset_mask(cfg, o.state, o.emitted_rows,
                                            o.done, injected_r=r_clear[t])
        em[t], rew[t], done[t] = o.emitted_rows, o.reward, o.done
    return em, rew, done, state


def _as_batch(em):
    """Emitted rows [T, H, (NW,) B] -> [H, (NW,) T * B], step-major."""
    rows = em.movedim(0, -2)
    return rows.reshape(rows.shape[:-2] + (-1,))


def _first_bad(bad, B):
    """(step, env) of the first True of ``bad`` [T, B] in step order."""
    i = int(bad.reshape(-1).nonzero()[0, 0])
    return divmod(i, B)


def check(cfg, script, instance, oracle, em, rew, done, state):
    """The replay against the oracle, bit for bit; raises SoakFailure at
    the first step and env that differ."""
    import torch
    from gym_simpletetris_tpu_torch.ops.bitops import unpack_board
    T, B = rew.shape
    dev = rew.device
    boards = unpack_board(cfg, _as_batch(em), dtype=torch.uint8)
    want = torch.as_tensor(oracle["boards"], device=dev).transpose(0, 1)
    fields = {
        "board": (boards.reshape(want.shape) != want).flatten(2).any(-1),
        "reward": rew != torch.as_tensor(oracle["rewards"].T, device=dev),
        "done": done != torch.as_tensor(oracle["dones"].T.astype(bool),
                                        device=dev)}
    bad = fields["board"] | fields["reward"] | fields["done"]
    where = f"cfg={cfg} script={script} instance={instance or 'plan'}"
    if bool(bad.any()):
        t, b = _first_bad(bad, B)
        which = [k for k, v in fields.items() if bool(v[t, b])]
        raise SoakFailure(f"{where} env={b} step={t}: {', '.join(which)}")
    for name, got, ref in (("deaths", state.deaths, oracle["deaths"]),
                           ("shape_counts", state.shape_counts.T,
                            oracle["counts"])):
        off = (got.cpu().numpy() != ref).reshape(B, -1).any(-1)
        if off.any():
            raise SoakFailure(f"{where} env={int(off.argmax())} "
                              f"step={T} (final): {name}")


def check_pixels(cfg, script, oracle, em, size, chunk_bytes) -> int:
    """Kernel B's image of every step against the host raster of the
    oracle's boards, ``chunk_bytes`` of images at a time; returns the
    images compared."""
    import torch
    from gym_simpletetris_tpu_torch.api import env as api_env
    from gym_simpletetris_tpu_torch.ops import cuda_raster
    from gym_simpletetris_tpu_torch.ops.raster import rasterize_host
    T, B = em.shape[0], em.shape[-1]
    H, W = cfg.height, cfg.width
    gray, rgb = cfg.replace(obs_type="grayscale"), cfg.replace(obs_type="rgb")
    boards = np.transpose(oracle["boards"], (1, 0, 3, 2))      # [T, B, H, W]
    ck = max(1, chunk_bytes // (B * size * size))
    for t0 in range(0, T, ck):
        rows = _as_batch(em[t0:t0 + ck])
        if size == api_env.OBS_SIZE:
            img = api_env.build_observation_storage(gray, rows)
        else:
            img = cuda_raster.rasterize_rows(cfg, rows, size)
        want = torch.as_tensor(rasterize_host(
            boards[t0:t0 + ck].reshape(-1, H, W), H, W, size),
            device=img.device)
        bad = (img != want).flatten(1).any(-1)
        if t0 == 0 and size == api_env.OBS_SIZE:
            obs = api_env.obs_from_storage(rgb, img)
            bad |= (obs != want[..., None].to(obs.dtype)).flatten(1).any(-1)
        if bool(bad.any()):
            t, b = _first_bad(bad.reshape(-1, B), B)
            raise SoakFailure(f"pixels {size} cfg={cfg} script={script} "
                              f"env={b} step={t0 + t}")
    return T * B


def soak(args, out=print) -> dict:
    """Run the soak ``args`` (``parse_args``) describes; raises SoakFailure
    at the first mismatch. Returns the steps, configurations, instances
    (configurations and kernel A launches each), kernel B launches, pixel
    steps and seconds."""
    import torch
    from gym_simpletetris_tpu_torch.native import drive_many
    from gym_simpletetris_tpu_torch.ops import cuda_step
    from gym_simpletetris_tpu_torch.utils.profiling import counters
    if args.cpu:
        if args.instances != "plan":
            raise ValueError("--instances all forces kernel A's instances: "
                             "a CUDA card only")
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: this soak replays through "
                               "the kernels on the card (pass --cpu for the "
                               "plain engine)")
        device = torch.device("cuda")
    rng = np.random.RandomState(args.seed)
    B, T = args.batch, args.steps
    total = pixel_steps = 0
    reached: dict = {}
    b0 = counters()["kernel.raster.launches"]
    t0 = time.time()
    for ci, cfg, script, actions, seeds in sample(args, rng):
        oracle = drive_many(actions.T, seeds, width=cfg.width,
                            height=cfg.height,
                            **{k: getattr(cfg, k) for k in FLAG_KEYS})
        runs = [None]
        if args.instances == "all":
            runs = list(cuda_step.instances_for(cfg.height, cfg.num_words))
        names = []
        for inst in runs:
            a0 = counters()["kernel.step.launches"]
            em, rew, done, state = replay(cfg, oracle, actions, device, inst)
            check(cfg, script, inst, oracle, em, rew, done, state)
            name = inst
            if name is None:
                name = ("plain" if device.type == "cpu" else
                        cuda_step.launch_plan(cfg.height, cfg.num_words,
                                              B).instance)
            got = reached.setdefault(name, {"configs": 0, "launches": 0})
            got["configs"] += 1
            got["launches"] += counters()["kernel.step.launches"] - a0
            names.append(name)
            total += B * T
        if args.pixels:
            pixel_steps += check_pixels(cfg, script, oracle, em,
                                        args.pixel_size, args.chunk_bytes)
        out(f"{summary_line(ci, args.configs, cfg, script, int(oracle['deaths'].sum()))} "
            f"OK ({total / 1e6:.2f}M steps, {time.time() - t0:.0f}s) "
            f"[{' '.join(names)}]", flush=True)
    return {"steps": total, "configs": args.configs, "instances": reached,
            "raster_launches": counters()["kernel.raster.launches"] - b0,
            "pixel_steps": pixel_steps, "seconds": time.time() - t0}


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        res = soak(args)
    except SoakFailure as e:
        print(f"SOAK FAIL: {e}", flush=True)
        return 1
    except RuntimeError as e:
        print(f"torch_soak_fuzz: {e}", file=sys.stderr, flush=True)
        return 2
    print(f"SOAK PASS: {res['steps'] / 1e6:.2f}M steps bitwise across "
          f"{res['configs']} random configs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
