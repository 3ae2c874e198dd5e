"""Env transitions completed per second over the whole measured window: the
cell's entry's env steps per call (B x T for a rollout call, B for a step
call) times the calls completed, over the seconds from the window's start to
the end of its last call, synchronised with the card."""

UNIT = "steps/s"


def read(window):
    return window.calls * window.steps_per_call / window.seconds
