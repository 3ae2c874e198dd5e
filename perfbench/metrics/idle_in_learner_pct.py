"""The share of the traced window in which the card ran no kernel, copy or
set while the host was inside a learner update: the exact overlap of the
device's idle gaps with the port's ``dqn.learn`` spans (``train/dqn.py``
``learner_half``, recorded by ``utils/profiling.py`` on the profiler's
clock), over the window; as ``idle_in_draws_pct`` reads the draws."""

from pathlib import Path

from perfbench import harness
from perfbench import trace as tr

LAYER = "device"
UNIT = "%"
MOVES = "env_steps_per_s"
_ROOT = Path(__file__).resolve().parents[2]
_TRAIN = harness.reader("metrics", "train_mfu_pct", _ROOT)
_overlap_ns = harness.reader("metrics", "idle_in_draws_pct.rollout",
                             _ROOT).overlap_ns


def read(trace):
    got = _TRAIN.spans(trace)
    learn = tr.busy_intervals([s for s in got or () if s.name == _TRAIN.LEARN],
                              trace.start, trace.end)
    if not learn:
        return None
    gaps = tr.idle_gaps(trace.kernels + trace.copies, trace.start, trace.end)
    return 100.0 * _overlap_ns(gaps, learn) / (trace.end - trace.start)
