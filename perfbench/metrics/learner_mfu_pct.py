"""The learner's share of its compute roofline in the traced window: the
model FLOPs of the learner updates whose ``dqn.learn`` spans the window holds
(``perfbench/model_flops.py``), over the card's busy time inside those
spans (the union of its kernels, copies and sets, clipped to each span)
times the dense BF16 peak (989.4 TFLOP/s)."""

from pathlib import Path

from perfbench import harness, model_flops
from perfbench import trace as tr

LAYER = "device"
UNIT = "%"
MOVES = "env_steps_per_s"
_TRAIN = harness.reader("metrics", "train_mfu_pct",
                        Path(__file__).resolve().parents[2])


def read(trace):
    got = _TRAIN.spans(trace)
    learn = [s for s in got or () if s.name == _TRAIN.LEARN]
    if not learn:
        return None
    busy = sum(e - s for span in learn for s, e in tr.busy_intervals(
        trace.kernels + trace.copies, span.start, span.end))
    if busy == 0:
        return None
    return model_flops.bf16_peak_share(_TRAIN.flops(trace, learn)[1],
                                       busy / 1e9)
