"""Device milliseconds of the perturbation a generation in the traced
window: the card's busy time in the device work before each generation's
first env kernel (``es_train_mfu_pct`` ``phases``, by stream order: the
draw of eps on the threefry, the antithetic negation, the members'
parameters ``theta + sigma eps`` and their layout, the env state's zeros),
over the window's ``es.perturb`` spans (``train/es.py``). A generation
after the window's first holds the previous one's update, which runs
before it; the cell traces one generation a window."""

from pathlib import Path

from perfbench import harness

LAYER = "device"
UNIT = "ms"
MOVES = "env_steps_per_s"
_MFU = harness.reader("metrics", "es_train_mfu_pct",
                      Path(__file__).resolve().parents[2])


def read(trace):
    got = _MFU.spans(trace)
    if got is None:
        return None
    gens = len(got[_MFU.PERTURB])
    split = _MFU.phases(trace, gens, len(got[_MFU.FORWARD]))
    if split is None or not split[0]:
        return None
    return 1e3 * _MFU.busy_s(split[0], trace) / gens
