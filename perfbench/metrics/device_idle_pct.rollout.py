"""The share of the traced rollout window in which the card ran no kernel,
copy or set."""

LAYER = "device"
UNIT = "%"
MOVES = "env_steps_per_s"


def read(trace):
    if not trace.kernels and not trace.copies:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
