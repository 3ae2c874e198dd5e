"""The population forward's share of its HBM roofline in the traced
window: the bytes a step's forward must move (``perfbench/es_flops.py``:
every member's parameters in the bf16 compute dtype and every env's
float32 frame, 1.78 GB at 512 x 4 envs) times the window's ``es.forward``
spans, at 3.35 TB/s, over the card's busy time in the forwards' device
work (``es_train_mfu_pct`` ``phases``: the work between a step's env
kernels and the next step's kernel A, found by stream order). Bound by bytes: at 6.9M multiply-adds a
frame the forward's FLOPs at the BF16 peak take 0.03 ms of its 0.53 ms of
bytes."""

from pathlib import Path

from perfbench import es_flops, harness

LAYER = "device"
UNIT = "%"
MOVES = "env_steps_per_s"
_MFU = harness.reader("metrics", "es_train_mfu_pct",
                      Path(__file__).resolve().parents[2])


def read(trace):
    got = _MFU.spans(trace)
    if got is None:
        return None
    n = len(got[_MFU.FORWARD])
    split = _MFU.phases(trace, len(got[_MFU.PERTURB]), n)
    if split is None:
        return None
    busy = _MFU.busy_s(split[1], trace)
    if busy == 0:
        return None
    nbytes = n * es_flops.step_bytes(trace.config["agent"], trace.batch)
    return 100.0 * nbytes / es_flops.HBM_BYTES_PER_S / busy
