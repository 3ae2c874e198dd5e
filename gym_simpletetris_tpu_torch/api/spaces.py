"""Minimal gym-compatible space descriptions (duck-typed).

The reference declares ``spaces.Discrete(7)`` and ``Box`` observation spaces
(tetris_env.py:377-392). We avoid a hard dependency on gym/gymnasium: these
lightweight classes mirror the attribute surface user code relies on
(``n``, ``shape``, ``dtype``, ``low``, ``high``, ``sample``, ``contains``),
and ``gym_compat`` converts them to real gymnasium spaces when it is installed.

Note the reference's declared grayscale/rgb Boxes claim range [0, 1] while the
actual pixels are {0,128,190} (SURVEY.md §2.4 quirk) — replicated verbatim.
"""

from __future__ import annotations

import numpy as np


class Space:
    def to_gymnasium(self):
        raise NotImplementedError


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64

    def sample(self, rng=None):
        rng = rng if rng is not None else np.random
        if hasattr(rng, "integers"):   # numpy Generator API
            return int(rng.integers(0, self.n))
        return int(rng.randint(0, self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"

    def to_gymnasium(self):
        import gymnasium
        return gymnasium.spaces.Discrete(self.n)


class Box(Space):
    def __init__(self, low, high, shape, dtype):
        self.low, self.high = low, high
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def sample(self, rng=None):
        rng = rng or np.random
        return rng.uniform(self.low, self.high, self.shape).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape
                and bool(np.all(x >= self.low))
                and bool(np.all(x <= self.high)))

    def __repr__(self):
        return f"Box({self.low}, {self.high}, {self.shape}, {self.dtype})"

    def to_gymnasium(self):
        import gymnasium
        return gymnasium.spaces.Box(self.low, self.high, self.shape, self.dtype)


def observation_space(cfg) -> Box:
    """Spaces as declared by the reference (tetris_env.py:381-392) for the
    float32 parity mode — including its Box(0,1)-vs-actual-{0,128,190} quirk.
    The uint8 native-palette mode is a framework extension with no reference
    quirk to replicate, so its image Boxes declare the honest (0, 255)."""
    w, h = cfg.width, cfg.height
    if cfg.obs_type == "ram":
        shape = (w, h, 1) if cfg.extend_dims else (w, h)
    elif cfg.obs_type == "grayscale":
        shape = (84, 84, 1) if cfg.extend_dims else (84, 84)
    else:  # rgb — extend_dims is ignored by the reference here (:391-392)
        shape = (84, 84, 3)
    if cfg.obs_dtype == "float32":
        return Box(0, 1, shape, np.float32)
    high = 1 if cfg.obs_type == "ram" else 255
    return Box(0, high, shape, np.uint8)


def action_space() -> Discrete:
    return Discrete(7)
