"""Raster kernel C's device microseconds per batched step, in place: the
rollout's accumulation of every step's image (``ops/cuda_raster.py``
``raster_accumulate``, ``csrc/raster.cu``). A time and no share of the HBM
bound: at B = 4096 the 28.9 MB accumulator stays in the 50 MB L2."""

LAYER = "raster kernels (ops/cuda_raster.py, csrc/raster.cu)"
UNIT = "us/step"
MOVES = "env_steps_per_s"
KERNEL = r"raster_kernel<\d+, true"


def read(trace):
    launches = trace.matching(KERNEL)
    if not launches:
        return None
    return sum(e.end - e.start for e in launches) / 1e3 / trace.steps
