"""The PyTorch port's static tables equal the JAX package's: piece tables,
the step kernel's compiled-in copy of them, config-derived constants, raster
geometry and the PRNG key of a seed."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest

from gym_simpletetris_tpu.core import config as jax_config
from gym_simpletetris_tpu.core import pieces as jax_pieces
from gym_simpletetris_tpu.core.engine import _valid_words
from gym_simpletetris_tpu.ops import raster as jax_raster
from gym_simpletetris_tpu_torch.core import config, pieces
from gym_simpletetris_tpu_torch.core.state import key_data
from gym_simpletetris_tpu_torch.ops import cuda_step, raster
import port_harness  # noqa: F401 (torch on one CPU thread)

CSRC = Path(__file__).resolve().parent.parent / "gym_simpletetris_tpu_torch" / "csrc"


def test_piece_tables_match_jax():
    for name in ("OFFSETS", "ROWMASKS", "ROWMASKS_FLAT"):
        a, b = getattr(pieces, name), getattr(jax_pieces, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("PIECE_NAMES", "NROWS", "DY_OFF", "DX_OFF", "NUM_PIECES"):
        assert getattr(pieces, name) == getattr(jax_pieces, name), name
    assert (config.XSHIFT, config.MAX_WIDTH_1W) == (
        jax_config.XSHIFT, jax_config.MAX_WIDTH_1W)


def test_step_kernel_table_matches_jax():
    """The __constant__ mask table compiled into csrc/step.cu."""
    src = (CSRC / "step.cu").read_text()
    body = re.search(r"c_rowmasks\[28\]\[kNRows\] = \{(.*?)\n\};", src, re.S)
    rows = re.findall(r"\{([\d,\s]+)\}", body.group(1))
    table = np.array([[int(v) for v in r.split(",")] for r in rows])
    np.testing.assert_array_equal(table, jax_pieces.ROWMASKS_FLAT)
    scores = re.search(r"c_nes_scores\[5\] = \{([\d,\s]+)\}", src).group(1)
    assert [int(v) for v in scores.split(",")] == [0, 40, 100, 300, 1200]


def test_step_kernel_flag_bits():
    """ops/cuda_step.config_flags packs the flags as csrc/step.cu reads them."""
    src = (CSRC / "step.cu").read_text()
    names = {"kRewardStep": "reward_step", "kPenHeight": "penalise_height",
             "kPenHeightInc": "penalise_height_increase",
             "kAdvClears": "advanced_clears", "kHighScoring": "high_scoring",
             "kPenHoles": "penalise_holes",
             "kPenHolesInc": "penalise_holes_increase",
             "kStepReset": "step_reset"}
    for cname, field in names.items():
        bit = int(re.search(rf"{cname} = (\d+)", src).group(1))
        assert cuda_step.config_flags(config.EnvConfig(**{field: True})) == bit
    assert cuda_step.config_flags(config.EnvConfig()) == 0


@pytest.mark.parametrize("kw", [
    dict(), dict(width=9, height=12, lock_delay=3), dict(width=24, height=8),
    dict(width=2, height=2, lock_delay=-1), dict(width=17, lock_delay=5),
    dict(width=25), dict(width=32, height=20), dict(width=56, height=10),
    dict(width=57, height=6), dict(width=1024, height=3)])
def test_config_constants_match_jax(kw):
    a, b = config.EnvConfig(**kw), jax_config.EnvConfig(**kw)
    for prop in ("num_words", "valid_mask", "spawn_x", "lock_modulus"):
        assert getattr(a, prop) == getattr(b, prop), prop
    words = a.valid_words()
    assert words.dtype == np.int32 and words.shape == (a.num_words,)
    np.testing.assert_array_equal(words.view(np.uint32), _valid_words(b))


def test_config_rejects():
    assert config.EnvConfig(width=25).num_words == 2      # wide boards exist
    for kw in (dict(width=1), dict(width=1025), dict(height=1),
               dict(obs_type="rgba"), dict(obs_dtype="float16")):
        with pytest.raises(ValueError):
            config.EnvConfig(**kw)


@pytest.mark.parametrize("d0,d1,size", [
    (20, 10, 84), (12, 9, 84), (5, 4, 84), (8, 16, 84), (20, 24, 84),
    (20, 10, 160), (12, 9, 83)])
def test_raster_maps_match_jax(d0, d1, size):
    assert raster.raster_geometry(d0, d1, size) == \
        jax_raster.raster_geometry(d0, d1, size)
    for a, b in zip(raster.build_raster_maps(d0, d1, size),
                    jax_raster.build_raster_maps(d0, d1, size)):
        np.testing.assert_array_equal(a, b)
    g = raster.raster_geometry(d0, d1, size)
    a0, a1 = raster.axis_maps(d0, d1, size)
    np.testing.assert_array_equal(
        a0, jax_raster._axis_cells(d0, size, g[0], g[1], g[2], g[4]))
    np.testing.assert_array_equal(
        a1, jax_raster._axis_cells(d1, size, g[0], g[1], g[3], g[5]))
    cells = np.random.RandomState(d0 * d1).rand(d0, d1) < 0.4
    np.testing.assert_array_equal(raster.rasterize_host(cells, d0, d1, size),
                                  jax_raster.rasterize_host(cells, d0, d1, size))


@pytest.mark.parametrize("seed", [0, 1, 42, 123456, -1, 2 ** 31 - 1, -2 ** 31])
def test_key_data_matches_prngkey(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    got = key_data(seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
