"""The byte counts behind each kernel's bound (``utils.kernel_timing``): they
are the bytes of the operands the wrappers hand the kernels, each read once
and each output written once. The timers themselves need the card and run in
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.core.state import FIELDS, init_state
from gym_simpletetris_tpu_torch.ops import cuda_raster
from gym_simpletetris_tpu_torch.ops.raster import device_axis_maps
from gym_simpletetris_tpu_torch.utils import kernel_timing as kt
import port_harness  # noqa: F401 (torch on one CPU thread)

CPU = torch.device("cpu")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("w,h,B", [(10, 20, 4096), (32, 20, 4096),
                                   (9, 12, 7), (100, 6, 3), (10, 20, 512),
                                   (10, 20, 3584), (10, 20, 16384),
                                   (10, 20, 65536), (10, 32, 33),
                                   (1024, 32, 5)])
def test_step_bytes_are_its_operands(w, h, B):
    """Kernel A reads the state and writes it back, with the emitted rows,
    reads an action and a draw per env and writes a reward and a done."""
    cfg = EnvConfig(width=w, height=h)
    s = init_state(cfg, B, 0, device="cpu")
    state = _nbytes(*(getattr(s, f) for f in FIELDS if f != "key"))
    io = B * (4 + 4) + B * (4 + 1)      # action, draw; reward, done
    assert kt.step_bytes(cfg, B) == 2 * state + s.rows.numel() * 4 + io
    if (w, h) == (10, 20):
        assert kt.step_bytes(cfg, 1) == 397


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("w,h,size,B", [(10, 20, 84, 4096), (32, 20, 84, 256),
                                        (10, 20, 160, 4096),
                                        (40, 26, 512, 1024), (4, 5, 83, 3)])
def test_raster_bytes_are_its_operands(w, h, size, B, accumulate):
    """Kernels B and C read the rows, the two pixel maps and the band table,
    write the image once, and C reads it once more."""
    cfg = EnvConfig(width=w, height=h)
    rows = init_state(cfg, B, 0, device="cpu").rows
    a0, a1 = device_axis_maps(h, w, size, CPU)
    _, bands = cuda_raster._device_bands(h, w, size, CPU)
    image = B * size * size * (2 if accumulate else 1)
    assert kt.raster_bytes(cfg, B, size, accumulate) == (
        image + _nbytes(rows, a0, a1, bands))


def test_bound_is_bytes_at_the_hbm_rate():
    assert kt.bound_us(int(kt.HBM_BYTES_PER_S)) == pytest.approx(1e6)
    # C at 84 px, B = 4096 on 10 x 20: 58.1 MB, 17.35 us
    assert kt.bound_us(kt.raster_bytes(EnvConfig(), 4096, 84, True)) == \
        pytest.approx(17.3526, abs=1e-4)


@pytest.mark.parametrize("in_f,features,rows", [(3136, 512, 512),
                                                (512, 357, 357), (512, 51, 51),
                                                (3136, 512, 256)])
def test_noise_bytes_are_its_operands(in_f, features, rows):
    """The noise kernel reads mu and sigma of its rows and the biases and
    the key, and writes the noisy weight, the bias and the two noise
    vectors (csrc/noise.cu)."""
    f32 = lambda *s: torch.zeros(s)
    reads = (f32(rows, in_f), f32(rows, in_f), f32(features), f32(features),
             torch.zeros(2, dtype=torch.int32))
    writes = (f32(rows, in_f), f32(features), f32(in_f + features))
    assert kt.noise_bytes(in_f, features, rows) == _nbytes(*reads, *writes)


@pytest.mark.parametrize("B,mb,us", [(4096, 1.626, 0.4854),
                                     (16384, 6.505, 1.9416),
                                     (65536, 26.018, 7.7665)])
def test_step_bound_at_the_timed_batches(B, mb, us):
    """Kernel A's bytes bound on 10 x 20: 397 bytes an env."""
    n = kt.step_bytes(EnvConfig(), B)
    assert n / 1e6 == pytest.approx(mb, abs=1e-3)
    assert kt.bound_us(n) == pytest.approx(us, abs=1e-4)


@pytest.mark.parametrize("w,h,B", [(10, 20, 64), (32, 20, 9), (57, 12, 5)])
def test_prefilled_state_leaves_one_open_cell_a_filled_row(w, h, B):
    cfg = EnvConfig(width=w, height=h)
    s = kt.prefilled_state(cfg, B, np.random.RandomState(1), "cpu")
    words = s.rows.reshape(h, cfg.num_words, B).numpy().view(np.uint32)
    valid = cfg.valid_words().view(np.uint32)[None, :, None]
    popcount = np.vectorize(lambda v: bin(int(v)).count("1"))
    cells = popcount(words & valid).sum(axis=1)                # [H, B]
    filled = cells > 0
    assert set(np.unique(cells)) <= {0, w - 1}           # full but one cell
    assert not (words & ~valid).any()                    # no guard bits
    depth = filled.sum(axis=0)
    assert (depth <= h // 2).all() and depth.max() > 0
    assert (filled == (np.arange(h)[:, None] >= h - depth[None, :])).all()


def test_step_inputs_come_from_play():
    cfg = EnvConfig()
    s, a, r, key = kt.step_inputs(cfg, 32, np.random.RandomState(2), "cpu")
    assert a.dtype == r.dtype == torch.int32 and a.shape == r.shape == (32,)
    assert ((a >= 0) & (a < 7)).all() and (r >= 1).all()
    assert (s.time == 8).all() and key.shape == (2,)


def test_action_mixes():
    rng = np.random.RandomState(3)
    B = 1000
    assert set(kt.mix_actions("random", B, rng)) == set(range(7))
    assert (kt.mix_actions("hard", B, rng) == 2).all()
    a = kt.mix_actions("walls", B, rng)
    pushes = a[(a == 0) | (a == 1)]
    assert set(a) == {0, 1, 2, 4, 5}
    assert (pushes == np.arange(B)[(a == 0) | (a == 1)] % 2).all()
    assert 0.5 < len(pushes) / B < 0.9
