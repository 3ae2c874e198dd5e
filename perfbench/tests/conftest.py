"""The benchmark's CPU tests: the repo root on the path, JAX on the CPU."""

import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
_ROOT = str(Path(__file__).resolve().parents[2])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
