"""The trainer's model FLOP utilisation in the traced window: the model
FLOPs (``perfbench/model_flops.py``: convolutions and matrix products of the
configuration's widths) of the actor steps and learner updates whose
``dqn.actor`` / ``dqn.learn`` spans the window holds (``train/dqn.py``,
recorded by ``utils/profiling.py`` on the profiler's clock), over the
window's seconds times the card's dense BF16 peak (989.4 TFLOP/s; bf16 is
the configuration's compute dtype)."""

from perfbench import model_flops

LAYER = "device"
UNIT = "%"
MOVES = "env_steps_per_s"
ACTOR, LEARN = "dqn.actor", "dqn.learn"


def spans(trace):
    """The port's trainer spans in the traced window, clipped to it; None
    where it holds none (a port without them) or the card ran nothing."""
    if not trace.kernels and not trace.copies:
        return None
    try:
        from gym_simpletetris_tpu_torch.utils.profiling import spans_between
    except ImportError:
        return None
    got = [s for s in spans_between(trace.start, trace.end)
           if s.name in (ACTOR, LEARN)]
    return got or None


def flops(trace, got) -> tuple:
    """(actor FLOPs, learner FLOPs) of the spans ``got``."""
    agent = model_flops.at_batch(trace.config["agent"], trace.batch)
    n = lambda name: sum(s.name == name for s in got)
    return (n(ACTOR) * model_flops.actor_step_flops(agent),
            n(LEARN) * model_flops.learner_update_flops(agent))


def read(trace):
    got = spans(trace)
    if got is None:
        return None
    return model_flops.bf16_peak_share(sum(flops(trace, got)),
                                       trace.window_s)
