"""Frozen, hashable environment configuration (PyTorch port).

Same surface as ``gym_simpletetris_tpu.core.config.EnvConfig``: the 14
constructor kwargs of the reference's ``TetrisEnv`` plus ``auto_reset`` and
``obs_dtype``. The JAX package's ``raster_impl`` / ``step_impl`` knobs are gone:
in the port the device of the state picks the implementation — the hand-written
CUDA kernels for CUDA tensors, the plain PyTorch versions for CPU tensors.

Boards up to MAX_WIDTH_1W columns pack a row into one 32-bit word ([H, B]);
wider boards, up to MAX_WIDTH, split a row over ``num_words`` words
([H, NW, B]), the JAX package's multi-word layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np

OBS_TYPES = ("ram", "grayscale", "rgb")

# Bit layout of a packed board row: column x lives at bit (x + XSHIFT). XSHIFT
# guard bits below bit 0 and 4 above bit (width-1 + XSHIFT) absorb piece
# offsets (|dx| <= 3, candidate anchors reach x = width), so anchor-shifted
# masks never wrap. Widths up to MAX_WIDTH_1W pack into one 32-bit word a row;
# wider rows hold global bit (x + XSHIFT) in word (x + XSHIFT) // 32.
XSHIFT = 4
MAX_WIDTH_1W = 32 - XSHIFT - 4
MAX_WIDTH = 1024          # the JAX package's sanity bound


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """All reference knobs (1:1) plus ``auto_reset`` and ``obs_dtype``.

    Reference kwargs (TetrisEnv.__init__):
      width, height, obs_type, extend_dims, render_mode (unused there too),
      reward_step, penalise_height, penalise_height_increase, advanced_clears,
      high_scoring, penalise_holes, penalise_holes_increase, lock_delay,
      step_reset.
    """

    width: int = 10
    height: int = 20
    obs_type: str = "ram"
    extend_dims: bool = False
    render_mode: str = "rgb_array"
    reward_step: bool = False
    penalise_height: bool = False
    penalise_height_increase: bool = False
    advanced_clears: bool = False
    high_scoring: bool = False
    penalise_holes: bool = False
    penalise_holes_increase: bool = False
    lock_delay: int = 0
    step_reset: bool = False
    auto_reset: bool = False
    obs_dtype: str = "float32"   # "float32" (reference parity) | "uint8"

    def __post_init__(self):
        if not (2 <= self.width <= MAX_WIDTH):
            raise ValueError(
                f"width={self.width} unsupported: requires 2 <= width <= "
                f"{MAX_WIDTH}")
        if self.height < 2:
            raise ValueError(f"height={self.height} must be >= 2")
        if self.obs_type not in OBS_TYPES:
            raise ValueError(f"obs_type={self.obs_type!r} not in {OBS_TYPES}")
        if self.obs_dtype not in ("float32", "uint8"):
            raise ValueError(f"obs_dtype={self.obs_dtype!r}")

    @property
    def num_words(self) -> int:
        """32-bit words per packed board row: bits XSHIFT .. width-1+XSHIFT+4
        (the guard for candidate anchors at x = width) must fit."""
        return (self.width + XSHIFT + 4 + 31) // 32

    @property
    def valid_mask(self) -> int:
        """Mask of in-board column bits: [XSHIFT, XSHIFT + width), as a Python
        int (wider than 32 bits for wide boards; see ``valid_words``)."""
        return ((1 << self.width) - 1) << XSHIFT

    def valid_words(self) -> np.ndarray:
        """int32[NW]: word w's slice of ``valid_mask``, uint32 bits (a full
        word is -1), ready to meet int32 row tensors."""
        return np.array([(self.valid_mask >> (32 * w)) & 0xFFFFFFFF
                         for w in range(self.num_words)],
                        dtype=np.uint32).view(np.int32)

    @property
    def spawn_x(self) -> int:
        """The reference spawns at float width/2 and truncates per cell, which
        for every reachable position equals floor(width/2)."""
        return self.width // 2

    @property
    def lock_modulus(self) -> int:
        # _lock_delay_fn = (x+1) % (max(lock_delay,0)+1)
        return max(self.lock_delay, 0) + 1

    def scoring_dict(self) -> dict:
        """The reference's ``_scoring`` dict (tetris_env.py:141-149), for
        introspection."""
        return {
            "reward_step": self.reward_step,
            "penalise_height": self.penalise_height,
            "penalise_height_increase": self.penalise_height_increase,
            "advanced_clears": self.advanced_clears,
            "high_scoring": self.high_scoring,
            "penalise_holes": self.penalise_holes,
            "penalise_holes_increase": self.penalise_holes_increase,
        }

    def replace(self, **kw) -> "EnvConfig":
        return dataclasses.replace(self, **kw)
