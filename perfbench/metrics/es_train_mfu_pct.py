"""The ES trainer's model FLOP utilisation in the traced window: the FLOPs
of the population forwards whose ``es.forward`` spans the window holds
(``train/es.py``, each step's ``member_forward``, recorded by
``utils/profiling.py``; ``perfbench/es_flops.py``: 2 x 6,888,960 x the
envs a forward), over the window's seconds times the card's dense BF16
peak (989.4 TFLOP/s; bf16 is the configuration's compute dtype). The share
of the whole generation.

``phases`` splits the window's device work by stream order, since a
generation never waits for the card and its host spans run ahead of the
work they launch: a generation's perturbation is the device work before
its first env kernel (the reset's spawn draw), each step's forward the
work between the env kernels (kernel A, the draw, reset and raster
kernels) of one step and those of the next, with the step's argmax, its
info's subtraction and the return's sum, a few µs, in it."""

import re

from perfbench import es_flops
from perfbench import trace as tr

LAYER = "device"
UNIT = "%"
MOVES = "env_steps_per_s"
PERTURB, FORWARD = "es.perturb", "es.forward"
ENV = re.compile(r"spawn_draw_kernel|reset_kernel|step_(warp|thread)_kernel"
                 r"|raster_kernel")
STEP = re.compile(r"step_(warp|thread)_kernel")
RASTER = re.compile(r"raster_kernel")


def spans(trace):
    """{name: the ES trainer's spans of that name} in the traced window;
    None where it holds no forward (a port without them) or the card ran
    nothing."""
    if not trace.kernels and not trace.copies:
        return None
    try:
        from gym_simpletetris_tpu_torch.utils.profiling import spans_between
    except ImportError:
        return None
    got = {}
    for s in spans_between(trace.start, trace.end):
        got.setdefault(s.name, []).append(s)
    return got if got.get(FORWARD) and got.get(PERTURB) else None


def phases(trace, generations: int, forwards: int):
    """(perturbation ops, forward ops) of the window's device ops by
    stream order (module docstring); None where the window does not hold
    ``generations`` whole generations of ``forwards`` steps in all. A
    rollout ends with the image of its last step (the reset's image and
    one a step: horizon + 1 launches of the raster kernel); what follows
    the window's last rollout, its update, is neither."""
    if forwards % generations:
        return None
    horizon = forwards // generations
    perturb, forward, pending, gens, steps, images = [], [], [], 0, 0, None
    for ev in sorted(trace.kernels + trace.copies, key=lambda e: e.start):
        env = bool(ENV.search(ev.name))
        if images is None:                      # before a rollout
            if not env:
                pending.append(ev)
                continue
            gens, images = gens + 1, 0
            perturb += pending
            pending = []
        if env:
            steps += bool(STEP.search(ev.name))
            images += bool(RASTER.search(ev.name))
        elif images <= horizon:
            forward.append(ev)
        else:                                   # the update, then the next
            images = None
            pending.append(ev)
    if gens != generations or steps != forwards or images not in (
            None, horizon + 1):
        return None
    return perturb, forward


def busy_s(events, trace) -> float:
    return sum(e - s for s, e in tr.busy_intervals(
        events, trace.start, trace.end)) / 1e9


def read(trace):
    got = spans(trace)
    if got is None:
        return None
    flops = len(got[FORWARD]) * es_flops.step_flops(trace.config["agent"],
                                                    trace.batch)
    return 100.0 * flops / (trace.window_s * es_flops.H100_BF16_FLOPS)
