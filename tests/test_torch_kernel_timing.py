"""The byte counts behind each kernel's bound (``utils.kernel_timing``): they
are the bytes of the operands the wrappers hand the kernels, each read once
and each output written once. The timers themselves need the card and run in
``chip_smoke.py``."""

import pytest
import torch

from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.core.state import FIELDS, init_state
from gym_simpletetris_tpu_torch.ops import cuda_raster
from gym_simpletetris_tpu_torch.ops.raster import device_axis_maps
from gym_simpletetris_tpu_torch.utils import kernel_timing as kt

CPU = torch.device("cpu")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("w,h,B", [(10, 20, 4096), (32, 20, 4096),
                                   (9, 12, 7), (100, 6, 3)])
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
