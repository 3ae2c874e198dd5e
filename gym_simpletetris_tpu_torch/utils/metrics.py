"""Metric sinks: stdout / JSONL / TensorBoard (port of
``gym_simpletetris_tpu.utils.metrics``, stdlib only and unchanged).

The reference's only observability is the ``info`` dict (tetris_env.py:232-241).
Here training loops emit flat scalar dicts; sinks fan them out. TensorBoard is
optional: tensorboardX is imported only when a ``tensorboard_dir`` is given.
"""

from __future__ import annotations

import json
from typing import Optional


class MetricLogger:
    """Fan-out scalar logger: ``log({"loss": ..}, step=n)``."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 stdout: bool = True):
        self._stdout = stdout
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        if tensorboard_dir:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(tensorboard_dir)

    def log(self, scalars: dict, step: int):
        rec = {k: float(v) for k, v in scalars.items()}
        rec["step"] = int(step)
        if self._stdout:
            print(json.dumps(rec), flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
