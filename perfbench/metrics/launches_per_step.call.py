"""Kernels the card ran per user call (one batched step) in the traced
window, under the user surfaces (``api/gym_compat.py``,
``api/gymnasium_vector.py``): the step, its draws, the resets, the
observation and the copy out."""

LAYER = "rollout loop and draws (api/env.py, core/engine.py, core/threefry.py)"
UNIT = "launches/step"
MOVES = "step_p95_ms"


def read(trace):
    if not trace.kernels:
        return None
    return len(trace.kernels) / trace.steps
