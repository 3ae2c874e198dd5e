"""The engine transition: CUDA step kernel (``csrc/step.cu``) or plain PyTorch.

``step`` takes the state, the actions, this step's spawn draws and the
advanced key (``core.engine.spawn_draw`` makes both outside the kernel, so
injected and threefry draws go through one kernel). A CPU state goes to
``core.engine.transition_plain``; a CUDA state launches the kernel, which
replaces the Pallas TPU kernel ``gym_simpletetris_tpu/ops/pallas_step.py``;
any other device raises. ``step.launches`` counts kernel launches. One
kernel serves every width: rows are [H, B] for single-word boards and
[H, NW, B] for wide ones, and the kernel takes NW.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.config import EnvConfig
from ..core.engine import StepOut, transition_plain
from ..core.state import EnvState, SCALAR_FIELDS, rows_shape

_FLAGS = ("reward_step", "penalise_height", "penalise_height_increase",
          "advanced_clears", "high_scoring", "penalise_holes",
          "penalise_holes_increase", "step_reset")


def config_flags(cfg: EnvConfig) -> int:
    """The EnvConfig flags as the kernel's bit set (csrc/step.cu)."""
    return sum(1 << i for i, f in enumerate(_FLAGS) if getattr(cfg, f))


def check_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def step(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
         r_draw: torch.Tensor, key: torch.Tensor) -> StepOut:
    """One transition with draws ``r_draw`` int32[B]; ``key`` becomes the
    new state's key."""
    dev = state.rows.device
    if dev.type == "cpu":
        return transition_plain(cfg, state, action, r_draw, key)
    if dev.type != "cuda":
        raise ValueError(f"no step implementation for device {dev}")
    return _launch(cfg, state, action, r_draw, key)


step.launches = 0


def _launch(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
            r_draw: torch.Tensor, key: torch.Tensor) -> StepOut:
    from ._build import load_library
    dev = state.rows.device
    H, NW, B = cfg.height, cfg.num_words, state.batch_size
    i32 = torch.int32
    shape = rows_shape(cfg, B)
    check_tensor("rows", state.rows, shape, i32, dev)
    scalars = [getattr(state, f) for f in SCALAR_FIELDS]
    for f, t in zip(SCALAR_FIELDS, scalars):
        check_tensor(f, t, (B,), i32, dev)
    check_tensor("shape_counts", state.shape_counts, (7, B), i32, dev)
    check_tensor("action", action, (B,), i32, dev)
    check_tensor("r_draw", r_draw, (B,), i32, dev)

    rows = torch.empty(shape, dtype=i32, device=dev)
    scal = torch.empty((len(SCALAR_FIELDS), B), dtype=i32, device=dev)
    counts = torch.empty((7, B), dtype=i32, device=dev)
    emitted = torch.empty(shape, dtype=i32, device=dev)
    reward = torch.empty((B,), dtype=torch.float32, device=dev)
    done = torch.empty((B,), dtype=torch.bool, device=dev)

    ins = [state.rows, *scalars, state.shape_counts, action, r_draw]
    outs = [rows, scal, counts, emitted, reward, done]
    in_ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load_library().tetris_step_launch(
        in_ptrs, out_ptrs, H, NW, B, cfg.width, cfg.lock_modulus, cfg.spawn_x,
        config_flags(cfg), dev.index if dev.index is not None
        else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(f"step kernel launch failed: CUDA error {err}")
    step.launches += 1
    new_state = state.replace(
        rows=rows, shape_counts=counts, key=key,
        **{f: scal[i] for i, f in enumerate(SCALAR_FIELDS)})
    return StepOut(new_state, emitted, reward, done)
