"""The 95th percentile, over every step() call in the window, of the time
from the user's call until its results are on the host (the call returns
numpy arrays or Python values), by the host clock. numpy's linear
interpolation between order statistics."""

import numpy as np

UNIT = "ms"


def read(window):
    if not window.latencies:
        return None
    return float(np.percentile(np.asarray(window.latencies), 95)) * 1e3
