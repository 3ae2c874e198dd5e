"""The port's plain-PyTorch raster equals the JAX package's pixel for pixel:
the Pallas raster and raster-accumulate kernels in interpret mode, and the
XLA gather raster. Plus the bit (un)packing it reads, and the CPU dispatch
of the kernel wrappers. csrc/raster.cu is held to the same plain versions
on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu.ops import bitops as jax_bitops
from gym_simpletetris_tpu.ops.pallas_raster import (
    rasterize_rows_pallas, raster_accumulate as jax_raster_accumulate)
from gym_simpletetris_tpu.ops.raster import (
    build_raster_maps, rasterize_gather, rasterize_host,
    grayscale_to_rgb as jax_grayscale_to_rgb)
from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.ops import bitops, cuda_raster, raster
from gym_simpletetris_tpu_torch.utils.profiling import counters
import port_harness  # noqa: F401 (torch on one CPU thread)

SHAPES = [(10, 20), (4, 5), (16, 8), (9, 12), (24, 20)]


def _boards(w, h, b, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, w, h) < rng.rand(b, 1, 1)).astype(np.uint8)


def _rows(w, h, b, seed):
    """(dense boards [B, W, H], JAX packed rows, port packed rows)."""
    boards = _boards(w, h, b, seed)
    packed = jax_bitops.pack_board(JaxConfig(width=w, height=h), boards)
    return boards, jnp.asarray(packed), torch.from_numpy(packed.view(np.int32))


@pytest.mark.parametrize("w,h", SHAPES)
def test_plain_raster_matches_pallas(w, h):
    _, jrows, trows = _rows(w, h, 6, w * h)
    want = np.asarray(rasterize_rows_pallas(JaxConfig(width=w, height=h),
                                            jrows, 84, interpret=True))
    got = raster.rasterize_rows_plain(EnvConfig(width=w, height=h), trows, 84)
    assert got.dtype == torch.uint8 and got.shape == (6, 84, 84)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", [84, 160])
@pytest.mark.parametrize("w,h", SHAPES)
def test_plain_raster_matches_gather(w, h, size):
    boards, _, trows = _rows(w, h, 5, w + h + size)
    cells = jnp.asarray(boards.transpose(0, 2, 1))            # [B, H, W]
    want = np.asarray(rasterize_gather(cells, h, w, size))
    got = raster.rasterize_rows_plain(EnvConfig(width=w, height=h), trows, size)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,h", [(10, 20), (6, 8), (24, 20)])
def test_plain_accumulate_matches_pallas(w, h):
    """Three folds into a random uint8 accumulator: every value wraps."""
    jcfg, cfg = JaxConfig(width=w, height=h), EnvConfig(width=w, height=h)
    acc0 = np.random.RandomState(1).randint(0, 256, (8, 84, 84), dtype=np.uint8)
    jacc, tacc = jnp.asarray(acc0), torch.from_numpy(acc0.copy())
    for k in range(3):
        _, jrows, trows = _rows(w, h, 8, 10 * k + w)
        jacc = jax_raster_accumulate(jcfg, jrows, jacc, interpret=True)
        out = raster.raster_accumulate_plain(cfg, trows, tacc)
        assert out is tacc                                     # in place
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))


def test_cpu_wrappers_take_the_plain_versions():
    cfg = EnvConfig()
    _, _, trows = _rows(10, 20, 4, 3)
    c = counters()
    n_r, n_a = c["kernel.raster.launches"], c["kernel.raster_acc.launches"]
    img = cuda_raster.rasterize_rows(cfg, trows)
    assert torch.equal(img, raster.rasterize_rows_plain(cfg, trows))
    acc = torch.full((4, 84, 84), 200, dtype=torch.uint8)
    cuda_raster.raster_accumulate(cfg, trows, acc)
    assert torch.equal(acc, torch.full_like(acc, 200) + img)
    c = counters()
    assert (c["kernel.raster.launches"],
            c["kernel.raster_acc.launches"]) == (n_r, n_a)
    with pytest.raises(ValueError, match="device"):
        cuda_raster.rasterize_rows(cfg, trows.to("meta"))


@pytest.mark.parametrize("w,h", [(10, 20), (9, 12), (24, 6)])
def test_bitops_match_jax(w, h):
    jcfg, cfg = JaxConfig(width=w, height=h), EnvConfig(width=w, height=h)
    boards, jrows, trows = _rows(w, h, 7, 5 * w + h)
    for fn in ("unpack_cells", "unpack_rows", "unpack_board"):
        want = np.asarray(getattr(jax_bitops, fn)(jcfg, jrows, dtype=jnp.uint8))
        got = getattr(bitops, fn)(cfg, trows, dtype=torch.uint8)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn)
    np.testing.assert_array_equal(bitops.pack_board(cfg, boards),
                                  jax_bitops.pack_board(jcfg, boards))
    np.testing.assert_array_equal(bitops.pack_board(cfg, boards[0]),
                                  jax_bitops.pack_board(jcfg, boards[0]))


def test_grayscale_to_rgb_matches_jax():
    img = np.random.RandomState(0).randint(0, 256, (3, 84, 84), dtype=np.uint8)
    np.testing.assert_array_equal(
        raster.grayscale_to_rgb(torch.from_numpy(img)).numpy(),
        np.asarray(jax_grayscale_to_rgb(jnp.asarray(img))))


@pytest.mark.parametrize("size", [84, 160, 512])
@pytest.mark.parametrize("d0,d1", [(20, 10), (26, 40)])
def test_kernel_bands_cover_the_maps(d0, d1, size):
    """The raster kernel's work split (``cuda_raster.raster_bands``) against
    the JAX package's ``build_raster_maps``: the bands tile the image's
    pixel rows, band k's rows read only cell rows [k * R, (k + 1) * R), and
    composing the image the kernel's way (one pattern per cell row of the
    band, the gap pattern, the border's zeros, copied to each pixel row)
    gives ``rasterize_host``."""
    R, starts = cuda_raster.raster_bands(d0, d1, size)
    base, cell = build_raster_maps(d0, d1, size)
    assert starts[0] == 0 and starts[-1] == size
    assert (np.diff(starts) > 0).all() and len(starts) - 1 == -(-d0 // R)
    if size <= 160:
        assert R == d0                        # one band: the whole image
    cells = _boards(d1, d0, 1, size)[0].T     # [d0, d1]
    gap_row = np.where(base[size // 2] == 0, 0, 128).astype(np.uint8)
    col = np.where(cell.max(axis=0) >= 0, cell.max(axis=0) % d1, -1)
    img = np.empty((size, size), np.uint8)
    for k in range(len(starts) - 1):
        lo, hi = starts[k], starts[k + 1]
        band_rows = cell[lo:hi].max(axis=1)   # cell index or -1 per pixel row
        used = np.unique(band_rows[band_rows >= 0] // d1)
        assert used.min() >= k * R and used.max() < min((k + 1) * R, d0)
        assert len(used) == min(R, d0 - k * R)
        pats = {r: gap_row + np.uint8(62) * np.where(
            col >= 0, cells[r, np.maximum(col, 0)], 0).astype(np.uint8)
            for r in used}
        for p in range(lo, hi):
            if band_rows[p - lo] >= 0:
                img[p] = pats[band_rows[p - lo] // d1]
            else:                             # gap or border row
                img[p] = gap_row if base[p].any() else 0
    np.testing.assert_array_equal(img, rasterize_host(cells, d0, d1, size))
