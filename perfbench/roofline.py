"""The bytes the port's kernels must move, and the least time to move them:
a frozen copy of ``gym_simpletetris_tpu_torch/utils/kernel_timing.py``'s
``step_bytes``, ``raster_bytes`` and ``bound_us``, so that the yardstick
does not move with the program.

Board rows pack a row of ``width`` columns into ``num_words`` 32-bit words:
column x at global bit ``x + 4``, 4 guard bits above the last column.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # one H100 SXM's HBM3 (NVIDIA's data sheet)


def num_words(width: int) -> int:
    return (width + 4 + 4 + 31) // 32


def step_bytes(height: int, words: int, batch: int) -> int:
    """Step kernel A's bytes: rows read, rows and emitted rows written (4 *
    H * NW each), 11 scalars and 7 counts read and written, the action and
    the draw read, the reward written (4 bytes each), done written (1
    byte), per env: 397 B at 10 x 20."""
    return batch * (12 * height * words + 157)


def raster_bytes(height: int, words: int, batch: int, size: int,
                 bands: int, accumulate: bool) -> int:
    """Raster kernels B and C's bytes: the image written (and read, for C),
    the rows, the two pixel maps and the table of ``bands`` work bands
    read."""
    return (batch * size * size * (2 if accumulate else 1)
            + 4 * height * words * batch + 8 * size + 4 * (bands + 1))


def bound_us(nbytes: int) -> float:
    """The least time to move ``nbytes`` at the HBM rate, microseconds."""
    return nbytes / HBM_BYTES_PER_S * 1e6
