#!/usr/bin/env python3
"""Shim-surface soak of the PyTorch port against its C++ oracle: the port's
counterpart of ``tools/soak_shim.py``.

Random-configuration lockstep of the three single-env user surfaces at soak
depth. Each configuration is drawn as ``tools/soak_shim.py`` draws it
(``random_env_kwargs``: the same draws from ``np.random.RandomState(seed)``
in the same order, so a seed samples the same configurations in both tools
and each configuration's line gives the same index, surface, width, height,
lock delay and obs type): widths 4-16, heights 5-24, lock delays 0-4, every
scoring and step flag, every obs type and ``extend_dims``. The surfaces
rotate gym -> engine -> native by configuration index, and image
observations run ``max(60, steps // 4)`` steps, as in the JAX tool.

  gym     ``make("SimpleTetris-v0", backend="cuda")`` (kernel A at B = 1
          every step and reset, kernel B on every image observation)
          against ``api.native_env.NativeTetrisEnv``, whose C++ engine
          (``native/oracle.cc``) and host raster (``ops.raster``) are the
          oracle. Obs (dtype, shape, values), reward, done and the full info
          dict at every step and reset; every ``--render-every`` steps of an
          image configuration also ``render("rgb_array")`` at 160 px (kernel
          B at B = 1) against the host raster of the oracle's board.
  engine  ``api.engine.TetrisEngine`` on the card against
          ``native.NativeTetrisEngine``: the board's occupancy, reward, done
          and ``get_info()`` against ``info()`` at every step and clear;
          also the attribute surface both expose: the anchor, the piece's
          name, its offsets and the lock counter (``piece_state()``),
          ``shape_counts``, ``valid_action_count()`` and ``render()``
          (occupancy). The JAX tool compares anchor, shape_name, shape,
          shape_counts and render; the C++ engine exposes all of them, so
          none is left out here.
  native  ``NativeTetrisEnv`` against the port's gym shim on the CPU plain
          path (``make(..., backend="cpu")``): the same fields and renders
          as the gym surface. With the gym surface this closes the
          triangle of card, C++ oracle and plain torch.

The JAX tool's oracle is the reference loaded in place; this one is the
port's C++ engine, a byte-identical copy of the JAX package's
``native/oracle.cc``, which that package's tests hold to the reference.

Both sides of a configuration see the same spawn draws: at every reset and
step, ``randint(1, sum(5 + max(c) - c) + 1)`` over the oracle's last info's
``statistics`` c, from a ``RandomState`` seeded per configuration, injected
into the surface under test and into its oracle (``injected_r``). Actions
are uniform over 0-6 from a per-configuration policy seed, as in the JAX
tool.

The first mismatch stops the run with exit code 1 and names the
configuration, the surface, the step and the field. Without ``--cpu`` the
tool needs a CUDA card and exits 2 where there is none; with ``--cpu`` the
gym and engine surfaces run the plain-torch path on the CPU.

    python3 tools/torch_soak_shim.py --cpu --configs 6 --steps 40
    python3 tools/torch_soak_shim.py --configs 120 --steps 400 --seed 1

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SURFACES = ("gym", "engine", "native")


class SoakFailure(AssertionError):
    """A surface that differs from its oracle."""


class NoCard(RuntimeError):
    """A run on the card asked for where there is none."""


def random_env_kwargs(rng, with_obs=True) -> dict:
    """A random shim configuration, drawn as the JAX package's shim fuzz
    draws it (``tests/test_shim_fuzz.random_env_kwargs``)."""
    kw = dict(
        width=int(rng.randint(4, 17)),
        height=int(rng.randint(5, 25)),
        lock_delay=int(rng.choice([0, 0, 1, 2, 4])),
        step_reset=bool(rng.randint(2)),
        reward_step=bool(rng.randint(2)),
        penalise_height=bool(rng.randint(2)),
        penalise_height_increase=bool(rng.randint(2)),
        advanced_clears=bool(rng.randint(2)),
        high_scoring=bool(rng.randint(2)),
        penalise_holes=bool(rng.randint(2)),
        penalise_holes_increase=bool(rng.randint(2)),
    )
    if with_obs:
        kw["obs_type"] = str(rng.choice(["ram", "grayscale", "rgb"]))
        kw["extend_dims"] = bool(rng.randint(2))
    return kw


def sample(args):
    """The configurations ``tools/soak_shim.py`` draws for ``args``: yields
    (index, surface, kwargs, steps)."""
    rng = np.random.RandomState(args.seed)
    for ci in range(args.configs):
        surface = SURFACES[ci % len(SURFACES)]
        kw = random_env_kwargs(rng, with_obs=(surface != "engine"))
        steps = args.steps
        if surface != "engine" and kw["obs_type"] != "ram":
            steps = max(60, args.steps // 4)
        yield ci, surface, kw, steps


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", type=int, default=30)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--render-every", type=int, default=50,
                    help="image configurations of the gym and native "
                         "surfaces: compare render('rgb_array') every N "
                         "steps")
    ap.add_argument("--cpu", action="store_true",
                    help="run the gym and engine surfaces on the CPU (the "
                         "plain engine and raster); by default on the CUDA "
                         "card, through the kernels")
    return ap.parse_args(argv)


def draw(rng, info) -> int:
    """A spawn draw valid for the piece counts of ``info``."""
    c = np.array(list(info["statistics"].values()))
    return int(rng.randint(1, int((5 + c.max() - c).sum()) + 1))


class _Lockstep:
    """One configuration's comparisons: raises SoakFailure at the first
    field that differs."""

    def __init__(self, ci, surface, kw):
        self.where = f"config {ci} surface={surface}"
        self.kw = kw
        self.at = "reset"

    def fail(self, field, got, want):
        raise SoakFailure(f"{self.where} step={self.at} field={field}: "
                          f"{got!r} != {want!r} (oracle); {self.kw}")

    def same(self, field, got, want):
        if type(got) is not type(want) or got != want:
            self.fail(field, got, want)

    def same_array(self, field, got, want):
        got, want = np.asarray(got), np.asarray(want)
        if got.dtype != want.dtype or got.shape != want.shape:
            self.fail(field, (got.dtype, got.shape), (want.dtype, want.shape))
        if got.tobytes() != want.tobytes():
            bad = np.argwhere(got != want)
            self.fail(field, f"{len(bad)} values differ, first at "
                      f"{tuple(bad[0])}", "equal")

    def same_env_out(self, got, want):
        """(obs, reward, done, info) of a step, or (obs, info) of a reset."""
        self.same_array("obs", got[0], want[0])
        for field, g, w in zip(("reward", "done"), got[1:-1], want[1:-1]):
            self.same(field, g, w)
        self.same("info", got[-1], want[-1])


def _run_env(ci, surface, kw, steps, args, device):
    """The gym or native surface: a shim and a ``NativeTetrisEnv`` in
    lockstep. Returns (episodes ended, renders compared)."""
    from gym_simpletetris_tpu_torch import make
    from gym_simpletetris_tpu_torch.api.native_env import NativeTetrisEnv
    nat = NativeTetrisEnv(**kw)
    shim = make("SimpleTetris-v0",
                backend=device if surface == "gym" else "cpu", **kw)
    # the surface under test, then its oracle
    env, ref = (shim, nat) if surface == "gym" else (nat, shim)
    check = _Lockstep(ci, surface, kw)
    draws = np.random.RandomState(args.seed * 1000 + ci)
    policy = np.random.RandomState(ci)
    images = kw["obs_type"] != "ram"

    def reset(info):
        r = draw(draws, info)
        want = ref.reset(return_info=True, injected_r=r)
        check.same_env_out(env.reset(return_info=True, injected_r=r), want)
        return want[1]

    info = reset({"statistics": dict.fromkeys("TJLZSIO", 0)})
    episodes = renders = 0
    for t in range(steps):
        check.at = t
        a, r = int(policy.randint(0, 7)), draw(draws, info)
        want = ref.step(a, injected_r=r)
        check.same_env_out(env.step(a, injected_r=r), want)
        info = want[3]
        if images and t % args.render_every == 0:
            check.same_array("render", env.render("rgb_array"),
                             ref.render("rgb_array"))
            renders += 1
        if want[2]:
            episodes += 1
            check.at = f"{t}+reset"
            info = reset(info)
    return episodes, renders


def _run_engine(ci, kw, steps, args, device):
    """The engine surface: ``TetrisEngine`` against ``NativeTetrisEngine``.
    Returns (episodes ended, 0 renders compared)."""
    from gym_simpletetris_tpu_torch import TetrisEngine
    from gym_simpletetris_tpu_torch.native import (NativeTetrisEngine,
                                                   PIECE_NAMES)
    flags = {k: v for k, v in kw.items() if k not in ("width", "height")}
    eng = TetrisEngine(kw["width"], kw["height"], device=device, **flags)
    ref = NativeTetrisEngine(**kw)
    check = _Lockstep(ci, "engine", kw)
    draws = np.random.RandomState(args.seed * 1000 + ci)
    policy = np.random.RandomState(ci)
    occupied = lambda b: (np.asarray(b) != 0).astype(np.uint8)

    def clear():
        r = draw(draws, ref.info())
        ref.clear(r)
        check.same_array("board", occupied(eng.clear(injected_r=r)),
                         occupied(ref.board))
        check.same("info", eng.get_info(), ref.info())

    def attributes():
        anchor, piece, lock, shape = ref.piece_state()
        check.same("anchor", eng.anchor, anchor)
        check.same("shape_name", eng.shape_name, PIECE_NAMES[piece])
        check.same("shape", sorted(eng.shape), sorted(shape))
        check.same("lock", eng._lock_delay, lock)
        check.same("shape_counts", eng.shape_counts, ref.info()["statistics"])
        check.same("valid_action_count", eng.valid_action_count(),
                   ref.valid_action_count())
        check.same_array("render", occupied(eng.render()),
                         occupied(ref.render()))

    clear()
    episodes = 0
    for t in range(steps):
        check.at = t
        a, r = int(policy.randint(0, 7)), draw(draws, ref.info())
        (rboard, rrew, rdone), _ = ref.step(a, r)
        board, rew, done = eng.step(a, injected_r=r)
        check.same_array("board", occupied(board), occupied(rboard))
        check.same("reward", rew, float(rrew))
        check.same("done", done, rdone)
        check.same("info", eng.get_info(), ref.info())
        attributes()
        if rdone:
            episodes += 1
            check.at = f"{t}+reset"
            clear()
    return episodes, 0


def soak(args, out=print) -> dict:
    """Run the soak ``args`` (``parse_args``) describes; raises SoakFailure
    at the first mismatch. Returns the steps, configurations, steps,
    episodes and seconds per surface, the renders compared, kernel A's and
    kernel B's launches and the seconds."""
    import torch
    from gym_simpletetris_tpu_torch.utils.profiling import counters
    if args.cpu:
        device = "cpu"
    else:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device: this soak drives the surfaces "
                         "through the kernels on the card (pass --cpu for "
                         "the plain engine)")
        device = "cuda"
    c = counters()
    a0, b0 = c["kernel.step.launches"], c["kernel.raster.launches"]
    per = {s: {"configs": 0, "steps": 0, "episodes": 0, "seconds": 0.0}
           for s in SURFACES}
    total = episodes = renders = 0
    t0 = time.time()
    for ci, surface, kw, steps in sample(args):
        t1 = time.time()
        if surface == "engine":
            ended, n = _run_engine(ci, kw, steps, args, device)
        else:
            ended, n = _run_env(ci, surface, kw, steps, args, device)
        got = per[surface]
        got["configs"] += 1
        got["steps"] += steps
        got["episodes"] += ended
        got["seconds"] += time.time() - t1
        total += steps
        episodes += ended
        renders += n
        out(f"[{ci + 1}/{args.configs}] {surface:6s} "
            f"w{kw['width']} h{kw['height']} ld{kw['lock_delay']} "
            f"{kw.get('obs_type', '-'):9s} OK "
            f"({total} steps, {time.time() - t0:.0f}s)", flush=True)
    return {"steps": total, "surfaces": per, "episodes": episodes,
            "renders": renders,
            "step_launches": counters()["kernel.step.launches"] - a0,
            "raster_launches": counters()["kernel.raster.launches"] - b0,
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        res = soak(args)
    except SoakFailure as e:
        print(f"SHIM SOAK FAIL: {e}", flush=True)
        return 1
    except NoCard as e:
        print(f"torch_soak_shim: {e}", file=sys.stderr, flush=True)
        return 2
    print(f"SHIM SOAK PASS: {res['steps']} lockstep steps bitwise across "
          f"{args.configs} random configs x 3 surfaces "
          f"({res['episodes']} episodes ended, {res['renders']} renders; "
          f"kernel launches A {res['step_launches']}, B "
          f"{res['raster_launches']}; {res['seconds']:.1f} s)")
    for s, v in res["surfaces"].items():
        print(f"  {s:6s} {v['configs']} configs, {v['steps']} steps, "
              f"{v['episodes']} episodes ended, {v['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
