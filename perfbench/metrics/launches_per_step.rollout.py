"""Kernels the card ran per batched step of the rollout, in the traced
window: the launches of the rollout loop and its two threefry draws a step
(``api/env.py`` ``build_rollout``, ``core/engine.py`` ``spawn_draw`` and
``engine_clear``, ``core/threefry.py``), kernels A and C, and the rest."""

LAYER = "rollout loop and draws (api/env.py, core/engine.py, core/threefry.py)"
UNIT = "launches/step"
MOVES = "env_steps_per_s"


def read(trace):
    if not trace.kernels:
        return None
    return len(trace.kernels) / trace.steps
