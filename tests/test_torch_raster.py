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
    rasterize_gather, grayscale_to_rgb as jax_grayscale_to_rgb)
from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.ops import bitops, cuda_raster, raster

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
    n_r, n_a = cuda_raster.rasterize_rows.launches, \
        cuda_raster.raster_accumulate.launches
    img = cuda_raster.rasterize_rows(cfg, trows)
    assert torch.equal(img, raster.rasterize_rows_plain(cfg, trows))
    acc = torch.full((4, 84, 84), 200, dtype=torch.uint8)
    cuda_raster.raster_accumulate(cfg, trows, acc)
    assert torch.equal(acc, torch.full_like(acc, 200) + img)
    assert (cuda_raster.rasterize_rows.launches,
            cuda_raster.raster_accumulate.launches) == (n_r, n_a)
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
