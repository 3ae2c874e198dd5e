"""Seconds from the start of the process's benchmark code (before torch is
imported) to the start of the measured window: the imports, the card's
context, loading (or, in a fresh checkout, building) the kernels, the env
and its reset, the inputs made from the seed, and the warm-up calls."""

UNIT = "s"


def read(window):
    return window.setup_s
