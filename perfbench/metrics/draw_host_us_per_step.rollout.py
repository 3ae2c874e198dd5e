"""Host self time of the threefry spawn draws per batched step of the
rollout, in the traced window: the ``engine.draw`` spans that the port
records while a profiler runs (``core/engine.py`` ``spawn_draw``: the key's
split and ``draw_spawn_r``; ``utils/profiling.py``), each less the time of
the spans inside it, clipped to the window, in microseconds over the
window's batched steps. A traced time: CUPTI's cost of each launch is in
it, so it compares from commit to commit, not with an untraced step."""

LAYER = "rollout loop and draws (api/env.py, core/engine.py, core/threefry.py)"
UNIT = "us/step"
MOVES = "env_steps_per_s"
DRAW = "engine.draw"


def spans(trace):
    """The port's spans in the traced window, clipped to it; None where it
    recorded none (a port without spans, or its tracing broken)."""
    try:
        from gym_simpletetris_tpu_torch.utils.profiling import spans_between
    except ImportError:
        return None
    return spans_between(trace.start, trace.end) or None


def self_ns(spans, name: str) -> int:
    """The time of the spans called ``name``, less that of their children
    (which lie inside them)."""
    own = {s.index for s in spans if s.name == name}
    return (sum(s.end - s.start for s in spans if s.index in own)
            - sum(s.end - s.start for s in spans if s.parent in own))


def read(trace):
    got = spans(trace)
    if got is None:
        return None
    return self_ns(got, DRAW) / 1e3 / trace.steps
