"""The episode-reset kernel (``csrc/reset.cu``, ``ops/cuda_reset.py``)
against the plain reset (``api.env.apply_reset_mask_plain``,
``core.engine.engine_clear_plain``), on the card; and the CPU path, which
launches nothing and is the plain body.

The card's tests need a CUDA device and nvcc; without them they skip. On a
machine with a card (``--noconftest``: tests/conftest.py sets up JAX, which
the port and this file do not use):

    python -m pytest --noconftest tests/test_torch_reset.py -q -m cuda
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.api import env as api_env
from gym_simpletetris_tpu_torch.core import engine as E
from gym_simpletetris_tpu_torch.core.state import FIELDS, SCALAR_FIELDS
from gym_simpletetris_tpu_torch.ops import cuda_reset
from gym_simpletetris_tpu_torch.utils.kernel_timing import (
    mix_actions, prefilled_state)
from gym_simpletetris_tpu_torch.utils.profiling import counters
import port_harness  # noqa: F401 (torch on one CPU thread)

# the env flags of the benchmark's configurations (perfbench/configs)
V0_RAM = dict()
FLAGSHIP_GRAY = dict(obs_type="grayscale", reward_step=True,
                     penalise_height=True)
FLAG_SETS = pytest.mark.parametrize("flags", [V0_RAM, FLAGSHIP_GRAY],
                                    ids=["v0_ram", "flagship_gray"])
WIDTHS = pytest.mark.parametrize("width", [10, 32, 80])   # NW = 1, 2, 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _ints(rng, lo, hi, shape, device):
    return torch.as_tensor(rng.randint(lo, hi, shape).astype(np.int32),
                           device=device)


def _inputs(cfg, B, offset, rng, device):
    """(stepped state, its emitted rows, the pre-step state) as a rollout
    meets them after a few random steps, every per-env field then made
    random (so a field taken from the wrong state or env shows) and the
    pre-step state given its own lock, deaths and counts."""
    pre = prefilled_state(cfg, B, rng, device).replace(env_offset=offset)
    pre = pre.replace(shape_counts=_ints(rng, 0, 400, (7, B), device))
    s = pre
    for _ in range(4):
        out = E.engine_step_plain(cfg, s, torch.as_tensor(
            mix_actions("random", B, rng), device=device))
        s = out.state
    s = s.replace(**{f: _ints(rng, -9, 1000, B, device)
                     for f in SCALAR_FIELDS if f != "piece"})
    pre = pre.replace(lock=_ints(rng, 0, 9, B, device),
                      deaths=_ints(rng, 0, 99, B, device))
    return s, out.emitted_rows, pre


def _masks(B, rng, device):
    return {"none": None,
            "all": torch.ones(B, dtype=torch.bool, device=device),
            "random": torch.as_tensor(rng.rand(B) < 0.5, device=device)}


def _held(*xs):
    """Copies of the tensors of states and tensors, to find a write."""
    out = []
    for x in xs:
        if x is None:
            continue
        ts = [getattr(x, f) for f in FIELDS] if hasattr(x, "rows") else [x]
        out += [(t, t.clone()) for t in ts]
    return out


def _assert_same(got, want, what):
    (gs, ge), (ws, we) = got, want
    for f in FIELDS:
        a, b = getattr(gs, f), getattr(ws, f)
        assert a.shape == b.shape and torch.equal(a, b), f"{f} {what}"
    assert gs.env_offset == ws.env_offset, what
    assert ge.shape == we.shape and torch.equal(ge, we), f"emitted {what}"


def _reset_both(cfg, state, emitted, pre, mask, injected, cleared):
    """(the reset on the main path, the plain reset): with no mask
    ``engine_clear`` of the cleared-from state, else ``apply_reset_mask``."""
    src = pre if cleared else state
    if mask is None:
        return (E.engine_clear(cfg, src, injected),
                E.engine_clear_plain(cfg, src, injected))
    cleared_from = pre if cleared else None
    return (api_env.apply_reset_mask(cfg, state, emitted, mask, injected,
                                     cleared_from),
            api_env.apply_reset_mask_plain(cfg, state, emitted, mask,
                                           injected, cleared_from))


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
@FLAG_SETS
@WIDTHS
@pytest.mark.parametrize("offset", [0, 2048])
@pytest.mark.parametrize("B", [1, 31, 33, 4096])
def test_reset_kernel_matches_plain(dev, B, offset, width, flags):
    """Bitwise the plain reset for masks none, all and random, with and
    without injected draws and a cleared-from state; one reset kernel
    launch a call; no input written."""
    cfg = EnvConfig(width=width, **flags)
    rng = np.random.RandomState(B + offset + width)
    state, emitted, pre = _inputs(cfg, B, offset, rng, dev)
    for (kind, mask), injected, cleared in itertools.product(
            _masks(B, rng, dev).items(), (False, True), (False, True)):
        r = _ints(rng, -2, 3000, B, dev) if injected else None
        what = f"mask {kind}, injected {injected}, cleared_from {cleared}"
        held = _held(state, emitted, pre, mask, r)
        n = counters()["kernel.reset.launches"]
        got, want = _reset_both(cfg, state, emitted, pre, mask, r, cleared)
        assert counters()["kernel.reset.launches"] == n + 1, what
        _assert_same(got, want, what)
        assert all(torch.equal(t, c) for t, c in held), what


@pytest.mark.cuda
def test_step_and_reset_returns_the_stepped_lines(dev):
    """``_step_and_reset`` on the card: the stepped ``lines_cleared`` it
    returns is the step's, for the envs the reset zeroed too; the state it
    was given is unchanged."""
    cfg = EnvConfig(auto_reset=True)
    B = 512
    rng = np.random.RandomState(3)
    s = prefilled_state(cfg, B, rng, dev)
    seen = 0
    for t in range(60):
        a = torch.as_tensor(mix_actions("hard", B, rng), device=dev)
        r = _ints(rng, 1, 36, B, dev)
        held = _held(s)
        stepped = E.engine_step(cfg, s, a, injected_r=r)
        new, _, _, done, lines = api_env._step_and_reset(cfg, s, a, r)
        assert all(torch.equal(x, c) for x, c in held), t
        assert torch.equal(lines, stepped.state.lines_cleared), t
        assert not new.lines_cleared[done].any(), t
        seen += int((done & (lines > 0)).sum())
        s = new
    assert seen > 0      # envs that cleared lines and died were compared


@pytest.mark.cuda
@pytest.mark.parametrize("obs_type", ["ram", "grayscale"])
def test_reset_launches_over_a_rollout(dev, obs_type, monkeypatch):
    """Every reset of the main path is one reset kernel launch after one
    draw: over a reset, a step and an auto-reset rollout
    ``kernel.reset.launches`` counts them and ``kernel.draw.launches``
    equals ``engine.draws``; the rollout equals the same steps on the
    plain reset, which launches no reset kernel."""
    cfg = EnvConfig(obs_type=obs_type, auto_reset=True)
    B, T = 512, 64
    env = TetrisVectorEnv(cfg, B, device=dev)
    rng = np.random.RandomState(1)
    acts = torch.as_tensor(rng.randint(0, 7, (T, B)), device=dev)
    n = counters()
    _, s = env.reset(4)
    _, s, _, _, _ = env.step(s, acts[0])
    final, acc, rew, done = env.rollout(s, acts)
    m = counters()
    assert m["kernel.reset.launches"] - n["kernel.reset.launches"] == 2 + T
    draws = m["engine.draws"] - n["engine.draws"]
    assert draws == 1 + 2 + 2 * T
    assert m["kernel.draw.launches"] - n["kernel.draw.launches"] == draws
    assert int(done.sum()) > 0

    monkeypatch.setattr(api_env, "apply_reset_mask",
                        api_env.apply_reset_mask_plain)
    final_p, acc_p, rew_p, done_p = env.rollout(s, acts)
    assert counters()["kernel.reset.launches"] == m["kernel.reset.launches"]
    for f in FIELDS:
        assert torch.equal(getattr(final, f), getattr(final_p, f)), f
    assert torch.equal(acc, acc_p)
    assert torch.equal(rew, rew_p) and torch.equal(done, done_p)


@pytest.mark.cuda
def test_reset_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg = EnvConfig()
    rng = np.random.RandomState(2)
    state, emitted, _ = _inputs(cfg, 64, 0, rng, dev)
    key, r = E.spawn_draw(state)
    mask = torch.zeros(64, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="mask"):
        cuda_reset.reset(cfg, state, r, key, emitted, mask.to(torch.int32))
    with pytest.raises(ValueError, match="mask"):
        cuda_reset.reset(cfg, state, r, key, emitted, mask[:32])
    with pytest.raises(ValueError, match="emitted"):
        cuda_reset.reset(cfg, state, r, key, emitted[:, :32], mask)
    with pytest.raises(TypeError, match="r has dtype"):
        cuda_reset.reset(cfg, state, r.to(torch.int64), key)
    with pytest.raises(ValueError, match="mask is on cpu"):
        cuda_reset.reset(cfg, state, r, key, emitted, mask.cpu())


# ------------------------------------------------------------------ the CPU

@FLAG_SETS
@WIDTHS
def test_cpu_reset_is_the_plain_body(width, flags):
    """On the CPU ``apply_reset_mask`` and ``engine_clear`` equal their
    plain bodies for every mask, with and without injected draws and a
    cleared-from state, and launch no kernel."""
    cfg = EnvConfig(width=width, **flags)
    B = 37
    rng = np.random.RandomState(width)
    state, emitted, pre = _inputs(cfg, B, 2048, rng, "cpu")
    masks = dict(_masks(B, rng, "cpu"), empty=torch.zeros(B, dtype=torch.bool))
    n = counters()
    for (kind, mask), injected, cleared in itertools.product(
            masks.items(), (False, True), (False, True)):
        r = _ints(rng, -2, 3000, B, "cpu") if injected else None
        held = _held(state, emitted, pre, mask, r)
        got, want = _reset_both(cfg, state, emitted, pre, mask, r, cleared)
        what = f"mask {kind}, injected {injected}, cleared_from {cleared}"
        _assert_same(got, want, what)
        assert all(torch.equal(t, c) for t, c in held), what
    m = counters()
    assert m["kernel.reset.launches"] == n["kernel.reset.launches"]
    assert m["kernel.draw.launches"] == n["kernel.draw.launches"]


@pytest.mark.parametrize("obs_type", ["ram", "grayscale"])
def test_cpu_rollout_launches_no_reset_kernel(obs_type):
    """An auto-reset rollout on the CPU resets on the plain body: every
    draw counted, no kernel launched."""
    cfg = EnvConfig(obs_type=obs_type, auto_reset=True)
    B, T = 16, 40
    env = TetrisVectorEnv(cfg, B, device="cpu")
    acts = torch.as_tensor(np.random.RandomState(4).randint(0, 7, (T, B)))
    n = counters()
    _, s = env.reset(2)
    _, _, _, done = env.rollout(s, acts)
    m = counters()
    assert m["engine.draws"] - n["engine.draws"] == 1 + 2 * T
    for k in ("kernel.reset.launches", "kernel.draw.launches",
              "kernel.step.launches"):
        assert m[k] == n[k], k


@WIDTHS
def test_reset_launch_record_and_buffers(width):
    """The packed record is the size ``csrc/reset.cu`` asserts, and the
    state's buffer is cut as the kernel writes it: rows, counts, then the
    11 scalars (the emitted rows are a buffer of their own)."""
    src = (Path(cuda_reset.__file__).parent.parent / "csrc" / "reset.cu")
    size, = re.findall(r"sizeof\(ResetArgs\) == (\d+)", src.read_text())
    assert cuda_reset._ARGS.size == int(size)
    cfg = EnvConfig(width=width)
    H, NW, B = cfg.height, cfg.num_words, 333
    call = cuda_reset._call(cfg, B, 0)
    assert call.state_sizes == (H * NW * B, 7 * B) + (B,) * len(SCALAR_FIELDS)
    assert call.state_total == (H * NW + 7 + len(SCALAR_FIELDS)) * B
    assert call.ints == (H, NW, B, cfg.spawn_x, 0, 0)
    assert call.rows_shape == ((H, B) if NW == 1 else (H, NW, B))
    assert call.in_shapes[0] == call.in_shapes[16] == call.rows_shape
    assert call.counts_shape == (7, B)
