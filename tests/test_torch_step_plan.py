"""Kernel A's launch plan (``ops/cuda_step.launch_plan``) and the wrapper
around the kernel, on the CPU.

The plan is Python, so these hold it here for every board the port takes
(H 2-64, NW 1-33): the warp instance takes H <= 32 and a thread instance
the taller boards (staged in shared memory where its tile fits), the grid
covers the batch, and a block's shared memory fits the H100's 232,448
bytes (48 KB for the staged thread instance). The wrapper is run against a
stand-in for the library that writes a known pattern into the two output
buffers the way ``csrc/step.cu`` lays them out, so the views the wrapper
hands back, the pointers it passes and the rejections are checked without a
card.
"""

import ctypes

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.core import engine as E
from gym_simpletetris_tpu_torch.core.state import (
    FIELDS, SCALAR_FIELDS, init_state)
from gym_simpletetris_tpu_torch.ops import _build, cuda_step
from gym_simpletetris_tpu_torch.utils import profiling
import port_harness  # noqa: F401 (torch on one CPU thread)

BATCHES = (1, 2, 31, 32, 33, 333, 512, 1000, 3584, 4096, 4097, 16384, 65536)
NWS = (1, 2, 3, 4, 17, 32, 33)


def _smem_words(H, NW, E):
    """The tile of csrc/step.cu: E records of 37 words, E boards at an odd
    stride of H * NW words."""
    return E * (37 + (H * NW | 1))


@pytest.mark.parametrize("NW", NWS)
def test_warp_instance_takes_boards_up_to_32_rows(NW):
    """Up to 32 rows the warp instance, but for batches from the crossover
    measured for the board's NW on where the staged tile fits; the rest a
    thread per env, staged where its tile fits."""
    from_b = cuda_step.THREAD_FROM_B[min(NW, 3) - 1]
    for H in range(2, 65):
        staged = 4 * 32 * H * NW <= cuda_step.STAGED_SMEM_MAX
        for B in BATCHES:
            p = cuda_step.launch_plan(H, NW, B)
            if H <= 32 and (B < from_b or not staged):
                assert p.instance == "warp", (H, B)
            else:
                assert p.instance == ("thread" if staged
                                      else "thread_global"), (H, B)


@pytest.mark.parametrize("NW", NWS)
def test_grid_covers_the_batch(NW):
    for H in range(2, 65):
        for B in BATCHES:
            p = cuda_step.launch_plan(H, NW, B)
            if p.instance == "warp":
                E = 1 << p.log_e
                assert p.threads == 32 * E and E in (8, 32), (H, B, p)
                assert p.blocks * E >= B > (p.blocks - 1) * E, (H, B, p)
            else:
                assert p.blocks * p.threads >= B > (p.blocks - 1) * p.threads
            assert p.threads <= 1024


@pytest.mark.parametrize("NW", NWS)
def test_shared_memory_fits_a_block(NW):
    for H in range(2, 65):
        for B in BATCHES:
            p = cuda_step.launch_plan(H, NW, B)
            if p.instance == "thread_global":
                assert p.smem == 0
            elif p.instance == "thread":
                assert p.smem == 4 * p.threads * H * NW <= 48 * 1024
            else:
                assert p.smem == 4 * _smem_words(H, NW, 1 << p.log_e)
                assert p.smem <= cuda_step.SMEM_MAX == 232448, (H, NW, B)


@pytest.mark.parametrize("B,sms,E", [(512, 132, 8), (1024, 132, 8),
                                     (2111, 132, 8), (2112, 132, 32),
                                     (3584, 132, 32), (4096, 132, 32),
                                     (8192, 132, 32), (1000, 62, 32),
                                     (100, 1, 32)])
def test_tile_follows_the_batch(B, sms, E):
    """E = 32 envs a block once the batch gives each SM 16 envs, else 8."""
    p = cuda_step.launch_plan(20, 1, B, sms)
    assert 1 << p.log_e == E


def test_thread_instance_from_the_crossover():
    """The crossovers read at 10 x 20, 32 x 20 and 100 x 20 on the H100."""
    assert cuda_step.THREAD_FROM_B == (9000, 16000, 13000)
    assert cuda_step.launch_plan(20, 1, 8192).instance == "warp"
    assert cuda_step.launch_plan(20, 1, 9000).instance == "thread"
    assert cuda_step.launch_plan(32, 1, 16384).instance == "thread"
    assert cuda_step.launch_plan(20, 2, 15999).instance == "warp"
    assert cuda_step.launch_plan(20, 2, 16000).instance == "thread"
    assert cuda_step.launch_plan(20, 4, 12999).instance == "warp"
    assert cuda_step.launch_plan(20, 4, 13000).instance == "thread"
    assert cuda_step.launch_plan(20, 3, 13000).instance == "thread"


@pytest.mark.parametrize("H,NW", [(20, 33), (32, 13), (12, 33), (25, 16)])
def test_warp_instance_keeps_boards_without_a_staged_tile(H, NW):
    """Where the staged tile does not fit at H <= 32, the warp instance at
    every batch: at 1024 x 20, B = 16384 it took 115 us, the global thread
    instance 608 (the H100, PERF.md)."""
    assert cuda_step.instances_for(H, NW) == ("warp", "thread_global")
    for B in BATCHES:
        assert cuda_step.launch_plan(H, NW, B).instance == "warp", B


@pytest.mark.parametrize("H,NW,threads", [(20, 1, 64), (32, 2, 64),
                                           (64, 3, 64), (20, 10, 32),
                                           (6, 33, 32), (12, 33, 0),
                                           (64, 33, 0)])
def test_staged_threads_halve_until_the_tile_fits(H, NW, threads):
    """64 threads a block, halved down to 32 while the tile passes 48 KB;
    past that the thread instance reads global memory, and boards up to
    32 rows keep the warp instance."""
    p = cuda_step.launch_plan(H, NW, 40000)
    if threads:
        assert p == cuda_step.StepPlan("thread", 0, threads,
                                       -(-40000 // threads),
                                       4 * threads * H * NW)
    else:
        assert p.instance == ("warp" if H <= 32 else "thread_global")
        assert cuda_step.launch_plan(H, NW, 40000, instance="thread_global") \
            == cuda_step.StepPlan("thread_global", 0, 128, 313, 0)
        with pytest.raises(ValueError, match="does not fit"):
            cuda_step.launch_plan(H, NW, 64, instance="thread")


def test_forced_instances():
    assert cuda_step.launch_plan(20, 1, 4096, instance="thread") == \
        cuda_step.StepPlan("thread", 0, 64, 64, 4 * 64 * 20)
    assert cuda_step.launch_plan(20, 1, 4096, instance="thread_global") == \
        cuda_step.StepPlan("thread_global", 0, 128, 32, 0)
    assert cuda_step.launch_plan(31, 10, 64, instance="thread") == \
        cuda_step.StepPlan("thread", 0, 32, 2, 4 * 32 * 31 * 10)
    assert cuda_step.launch_plan(20, 1, 65536, instance="warp") == \
        cuda_step.StepPlan("warp", 5, 1024, 2048, 4 * 32 * (37 + 21))
    assert cuda_step.launch_plan(32, 33, 7, instance="warp").instance == "warp"
    with pytest.raises(ValueError, match="H <= 32"):
        cuda_step.launch_plan(33, 1, 64, instance="warp")
    with pytest.raises(ValueError, match="instance"):
        cuda_step.launch_plan(20, 1, 64, instance="block")


@pytest.mark.parametrize("H,NW,B", [(20, 1, 4096), (20, 2, 7), (6, 33, 5),
                                    (40, 2, 1)])
def test_out_sizes_hold_every_output(H, NW, B):
    board_rows, small = cuda_step.out_sizes(H, NW, B)
    assert board_rows == (H * NW, H * NW, 7)
    assert small[:len(SCALAR_FIELDS) + 1] == (B,) * (len(SCALAR_FIELDS) + 1)
    assert small[-1] * 4 >= B > (small[-1] - 1) * 4        # done, as bytes


class _FakeLibrary:
    """Stands in for the kernels' library: records the launch and fills the
    two output buffers as csrc/step.cu lays them out (boards: rows_out,
    emitted, counts; small: 11 scalars, reward, done), each output with its
    own pattern."""

    def __init__(self):
        self.calls = []

    def tetris_step_launch(self, args):
        v = cuda_step._ARGS.unpack(args)
        in_ptrs, (boards, small, stream), (H, NW, B, *rest) = (
            list(v[:15]), v[15:18], v[18:])
        self.calls.append((in_ptrs, boards, small, stream, H, NW, B,
                           tuple(rest)))
        n = H * NW * B
        words = np.concatenate([np.full(n, 1), np.full(n, 2),
                                np.repeat(np.arange(30, 37), B)]).astype(
                                    np.int32)
        ctypes.memmove(boards, words.ctypes.data, words.nbytes)
        words = np.concatenate([np.repeat(np.arange(10, 21), B),
                                np.full(B, np.float32(1.5).view(np.int32))
                                ]).astype(np.int32)
        ctypes.memmove(small, words.ctypes.data, words.nbytes)
        done = (np.arange(B) % 3 == 0).astype(np.uint8)
        ctypes.memmove(small + 4 * words.size, done.ctypes.data, B)
        return 0


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_step, "_stream", lambda index: 0)
    monkeypatch.setattr(cuda_step, "_sm_count", lambda index: 132)
    # the fake launches count; restore the counters other files hold at 0
    monkeypatch.setattr(profiling, "_counts", profiling.counters())
    return lib


def _inputs(cfg, B):
    s, _ = E.engine_clear(cfg, init_state(cfg, B, 0, device="cpu"))
    a = torch.arange(B, dtype=torch.int32) % 7
    key, r = E.spawn_draw(s, None)
    return s, a, r, key


@pytest.mark.parametrize("w,h,B", [(10, 20, 4096), (10, 20, 333),
                                   (32, 20, 6), (1024, 6, 3)])
def test_wrapper_views_follow_the_kernel_layout(fake_library, w, h, B):
    cfg = EnvConfig(width=w, height=h)
    s, a, r, key = _inputs(cfg, B)
    n = profiling.counters()["kernel.step.launches"]
    out = cuda_step._launch(cfg, s, a, r, key)
    assert profiling.counters()["kernel.step.launches"] == n + 1
    (ptrs, boards, small, stream, H, NW, B_, rest), = fake_library.calls
    assert (H, NW, B_, stream) == (h, cfg.num_words, B, 0)
    ins = [s.rows] + [getattr(s, f) for f in SCALAR_FIELDS] + [
        s.shape_counts, a, r]
    assert ptrs == [t.data_ptr() for t in ins]
    plan = cuda_step.launch_plan(h, cfg.num_words, B, 132)
    assert rest == (w, cfg.lock_modulus, cfg.spawn_x,
                    cuda_step.config_flags(cfg), 1, plan.log_e, plan.threads,
                    plan.blocks, plan.smem, -1, 0)
    assert cuda_step._ARGS.size == 200                  # csrc/step.cu LaunchArgs
    st = out.state
    assert st.rows.shape == s.rows.shape and st.rows.data_ptr() == boards
    assert st.piece.data_ptr() == small
    assert (st.rows == 1).all() and (out.emitted_rows == 2).all()
    assert out.emitted_rows.shape == s.rows.shape
    for i, f in enumerate(SCALAR_FIELDS):
        t = getattr(st, f)
        assert t.shape == (B,) and t.dtype == torch.int32 and (t == 10 + i).all()
    assert st.shape_counts.shape == (7, B)
    assert (st.shape_counts == torch.arange(30, 37)[:, None]).all()
    assert out.reward.dtype == torch.float32 and (out.reward == 1.5).all()
    assert out.done.dtype == torch.bool and out.done.shape == (B,)
    assert torch.equal(out.done, torch.arange(B) % 3 == 0)
    assert st.key is key
    for f in FIELDS:
        assert getattr(st, f).is_contiguous(), f


def test_wrapper_rejects_what_the_kernel_does_not_take(fake_library):
    cfg = EnvConfig()
    s, a, r, key = _inputs(cfg, 8)
    with pytest.raises(TypeError, match="action"):
        cuda_step._launch(cfg, s, a.to(torch.int64), r, key)
    with pytest.raises(ValueError, match="r_draw has shape"):
        cuda_step._launch(cfg, s, a, r[:4], key)
    with pytest.raises(ValueError, match="score is not contiguous"):
        cuda_step._launch(cfg, s.replace(score=torch.zeros(
            (8, 2), dtype=torch.int32)[:, 0]), a, r, key)
    with pytest.raises(ValueError, match="shape_counts has shape"):
        cuda_step._launch(cfg, s.replace(shape_counts=s.shape_counts[:6]),
                          a, r, key)
    with pytest.raises(ValueError, match="rows has shape"):
        wide = EnvConfig(width=32)
        cuda_step._launch(wide, s, a, r, key)
    assert fake_library.calls == []
