"""Host self time of the threefry spawn draws per user call (one batched
step) in the traced window of the user surfaces (``api/gym_compat.py``):
the step's draw and, where it ended the episode, the reset's. The
arithmetic of ``draw_host_us_per_step.rollout`` over the window's calls."""

from pathlib import Path

from perfbench import harness

LAYER = "rollout loop and draws (api/env.py, core/engine.py, core/threefry.py)"
UNIT = "us/step"
MOVES = "step_p95_ms"
_ROLLOUT = harness.reader("metrics", "draw_host_us_per_step.rollout",
                          Path(__file__).resolve().parents[2])


def read(trace):
    got = _ROLLOUT.spans(trace)
    if got is None:
        return None
    return _ROLLOUT.self_ns(got, _ROLLOUT.DRAW) / 1e3 / trace.calls
