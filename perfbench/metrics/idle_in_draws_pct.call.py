"""The share of the traced window of user calls (``api/gym_compat.py``) in
which the card ran no kernel, copy or set while the host was inside a
threefry spawn draw: ``idle_in_draws_pct.rollout``'s reading of the
window."""

from pathlib import Path

from perfbench import harness

LAYER = "device"
UNIT = "%"
MOVES = "step_p95_ms"
read = harness.reader("metrics", "idle_in_draws_pct.rollout",
                      Path(__file__).resolve().parents[2]).read
