"""Step kernel A's share of its HBM bound, in place: the bytes it must move
at the cell's batch and board (``perfbench/roofline.py``, 397 B per env at
10 x 20) at 3.35 TB/s, over the mean device time of its launches in the
traced window (``ops/cuda_step.py``, ``csrc/step.cu``)."""

from perfbench import roofline

LAYER = "step kernel A (ops/cuda_step.py, csrc/step.cu)"
UNIT = "%"
MOVES = "env_steps_per_s"
KERNEL = r"step_(warp|thread)_kernel"


def read(trace):
    launches = trace.matching(KERNEL)
    if not launches:
        return None
    mean_us = sum(e.end - e.start for e in launches) / len(launches) / 1e3
    width, height = trace.config.get("width", 10), trace.config.get("height", 20)
    nbytes = roofline.step_bytes(height, roofline.num_words(width), trace.batch)
    return 100.0 * roofline.bound_us(nbytes) / mean_us
