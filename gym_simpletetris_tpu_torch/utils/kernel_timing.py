"""Device time of the port's CUDA kernels, and the bound each is held to.

- ``device_us``: one launch's device time, by CUDA events around the replay
  of a CUDA graph of launches, so no host time falls between them;
- ``sync_ms``: one wrapper call as its caller sees it (Python and ctypes
  included), by CUDA events over back-to-back calls;
- ``step_bytes`` / ``raster_bytes`` / ``noise_bytes`` / ``reset_bytes``:
  the bytes kernel A, kernels B, C, the noise kernel and the reset kernel
  must move; ``bound_us`` turns bytes into the least time at the H100's
  HBM rate;
- ``step_device_times``: kernel A at one state, for two action mixes, with
  its bound and a plain-stream yardstick; ``prefilled_state``,
  ``step_inputs`` and ``mix_actions`` make the states and actions it is
  timed and checked on;
- ``raster_device_times``: kernels B and C at one shape, each beside its
  bound, with plain-stream yardsticks.

``chip_smoke.py``, ``tools/torch_step_abba.py`` and
``tools/torch_raster_abba.py`` time the kernels with these. The timers need
a CUDA card; ``bound_us``, the byte counts and the states do not.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA's data sheet)


def sync_ms(fn, n: int) -> float:
    """Milliseconds per call of ``fn`` on the card, by CUDA events around
    ``n`` back-to-back calls (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def device_us(fn, n: int = 20, flush=None) -> float:
    """Mean device microseconds of one call of ``fn`` (one kernel launch):
    CUDA events around the replay of a CUDA graph of ``n`` calls, so no
    host time falls between the launches (the median of 3 replays).
    ``flush``, where given, runs before each call to evict the L2 cache, and
    the time of a graph of the flushes alone is taken off."""

    def graph(calls):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for c in calls:
                c()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                for c in calls:
                    c()
        return g

    def replay_ms(g):
        g.replay()
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            g.replay()
            t1.record()
            torch.cuda.synchronize()
            runs.append(t0.elapsed_time(t1))
        return statistics.median(runs)

    ms = replay_ms(graph([flush, fn] if flush else [fn]))
    if flush is not None:
        ms -= replay_ms(graph([flush]))
    return ms * 1e3 / n


def l2_flush():
    """A function that evicts the card's 50 MB L2 cache by writing 128 MB."""
    buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    return buf.zero_


def bound_us(nbytes: int) -> float:
    """The least time to move ``nbytes`` at the HBM rate, in microseconds."""
    return nbytes / HBM_BYTES_PER_S * 1e6


def noise_bytes(in_f: int, features: int, rows: int) -> int:
    """The noise kernel's bytes for one layer (rows of its features):
    mu and sigma read and the noisy weight written (12 * rows * in_f), the
    biases read and written (12 * features), the noise vectors written
    (4 * (in_f + features)) and the key read (8)."""
    return 12 * rows * in_f + 16 * features + 4 * in_f + 8


def step_bytes(cfg, B: int) -> int:
    """Kernel A's bytes: rows read, rows and emitted rows written (4 * H *
    NW each), 11 scalars and 7 counts read and written, action and draw
    read, reward written (4 bytes each), done written (1 byte), per env:
    397 B at 10 x 20."""
    return B * (12 * cfg.height * cfg.num_words + 157)


def reset_bytes(cfg, B: int, resets: int, masked: bool = True) -> int:
    """The reset kernel's bytes for ``resets`` of B envs resetting: every
    env writes its rows and emitted rows (4 * H * NW each), 11 scalars and
    7 counts; a carried env reads as much, a reset env its draw, lock,
    deaths and counts (40 bytes); with a mask, its byte an env. Per env
    with few resets: 465 B at 10 x 20."""
    carried = 8 * cfg.height * cfg.num_words + 72
    return (B * carried + (B - resets) * carried + 40 * resets
            + (B if masked else 0))


def prefilled_state(cfg, B: int, rng, device):
    """A cleared state whose lower rows (a random depth, up to half the
    board) are full but for one open cell each, so random play clears
    lines, scores and dies. Made from ``rng`` (numpy)."""
    from ..core import engine as E
    from ..core.state import init_state, rows_shape
    s = init_state(cfg, B, int(rng.randint(0, 2 ** 31)), device)
    s, _ = E.engine_clear(cfg, s, injected_r=torch.as_tensor(
        rng.randint(1, 36, B), device=device))
    H, nw = cfg.height, cfg.num_words
    depth = rng.randint(0, H // 2 + 1, B)
    filled = np.arange(H)[:, None] >= H - depth[None, :]       # [H, B]
    hole = 4 + rng.randint(0, cfg.width, (H, B))     # the open cell's bit
    rows = np.zeros((H, nw, B), np.uint32)
    for w in range(nw):
        valid = np.uint64((cfg.valid_mask >> (32 * w)) & 0xFFFFFFFF)
        bit = np.where(hole >> 5 == w, np.uint64(1) << (hole & 31).astype(
            np.uint64), np.uint64(0))
        rows[:, w, :] = np.where(filled, valid & ~bit, 0).astype(np.uint32)
    rows = rows.reshape(rows_shape(cfg, B))
    return s.replace(rows=torch.from_numpy(rows.view(np.int32)).to(device))


def mix_actions(mix: str, B: int, rng):
    """A step's actions (numpy, made from ``rng``): "random"; "hard", every
    env hard-drops, so every step locks; "walls", even envs push left and
    odd ones right, a few rotate or hard-drop."""
    if mix == "random":
        return rng.randint(0, 7, B)
    if mix == "hard":
        return np.full(B, 2)
    u = rng.rand(B)
    a = np.where(np.arange(B) % 2 == 0, 0, 1)
    return np.where(u > 0.9, 2, np.where(u < 0.15, rng.randint(4, 6, B), a))


def step_inputs(cfg, B: int, rng, device, steps: int = 8):
    """Kernel A's inputs as a rollout meets them: a prefilled state after
    ``steps`` random steps, this step's random actions, the threefry draws
    and the advanced key: (state, action, r_draw, key)."""
    from ..core import engine as E
    s = prefilled_state(cfg, B, rng, device)
    for _ in range(steps):
        s = E.engine_step(cfg, s, torch.as_tensor(rng.randint(0, 7, B),
                                                  device=device)).state
    key, r = E.spawn_draw(s, None)
    a = torch.as_tensor(rng.randint(0, 7, B), dtype=torch.int32,
                        device=device)
    return s, a, r, key


def step_device_times(cfg, state, action, r_draw, key, n: int = 20,
                      runs=None) -> dict:
    """Device us of kernel A on ``state`` beside its bytes bound, for two
    action mixes: ``action`` (a rollout's random actions) and all hard drops
    (every env locks, at lock_delay 0). ``runs`` maps instance names to
    functions of the actions that launch the step; by default the port's
    instances, the one its launch plan picks first. ``step`` times the
    first of them; ``others`` the rest, to place the crossovers. Beside
    them, as the yardstick of a plain stream over the same bytes (no PyTorch
    call computes the step): ``copy_`` between two int32 buffers that
    together hold the kernel's bytes."""
    B = state.batch_size
    if runs is None:
        from ..ops import cuda_step
        sms = torch.cuda.get_device_properties(
            state.device).multi_processor_count
        first = cuda_step.launch_plan(cfg.height, cfg.num_words, B,
                                      sms).instance
        names = [first] + [i for i in cuda_step.instances_for(
            cfg.height, cfg.num_words) if i != first]
        runs = {i: (lambda a, i=i: cuda_step._launch(cfg, state, a, r_draw,
                                                     key, i))
                for i in names}
    nbytes = step_bytes(cfg, B)
    src = torch.zeros(nbytes // 8, dtype=torch.int32, device=state.device)
    dst = torch.empty_like(src)
    out = {"copy_stream": dict(device_us=device_us(lambda: dst.copy_(src), n)),
           "others": []}
    hard = torch.full_like(action, 2)
    bound = bound_us(nbytes)
    for k, (inst, fn) in enumerate(runs.items()):
        us = device_us(lambda: fn(action), n)
        rec = dict(instance=inst, device_us=us, bound_us=bound,
                   bound_share=bound / us,
                   hard_drop_device_us=device_us(lambda: fn(hard), n))
        if k == 0:
            out["step"] = rec
        else:
            out["others"].append(rec)
    return out


def raster_bytes(cfg, B: int, size: int, accumulate: bool) -> int:
    """Kernels B and C's bytes: the image written (and read, for C), the
    rows, the two pixel maps and the band table read."""
    from ..ops.cuda_raster import raster_bands
    n_bands = len(raster_bands(cfg.height, cfg.width, size)[1])
    return (B * size * size * (2 if accumulate else 1)
            + 4 * cfg.height * cfg.num_words * B + 8 * size + 4 * n_bands)


def raster_device_times(cfg, rows, size: int, n: int = 20,
                        cuda_raster=None) -> dict:
    """Device us of kernels B and C on ``rows`` at ``size`` px, each beside
    its bytes bound. C is timed with L2 evicted before each launch, so that
    ``acc`` comes from HBM and the HBM bound is a lower limit; its time with
    ``acc`` warm in L2 (back-to-back launches on one ``acc``, as in a
    rollout) is given beside it as ``l2_warm_device_us``, with no bound:
    its reads come from L2. Beside them, as yardsticks of what a plain
    stream over the same bytes reaches (no PyTorch call computes the
    raster): ``zero_`` of the image (stores, as B) and ``add_(1)`` on it in
    place (loads and stores, as C, warm in L2). ``cuda_raster`` is the
    wrapper module to time, the port's by default."""
    if cuda_raster is None:
        from ..ops import cuda_raster
    B = rows.shape[-1]
    acc = torch.zeros((B, size, size), dtype=torch.uint8, device=rows.device)
    out = {name: dict(device_us=device_us(fn, n)) for name, fn in (
        ("store_stream", acc.zero_), ("rmw_stream", lambda: acc.add_(1)))}
    for name, fn, acc_on, flush in (
            ("raster", lambda: cuda_raster.rasterize_rows(cfg, rows, size),
             False, None),
            ("raster_accumulate",
             lambda: cuda_raster.raster_accumulate(cfg, rows, acc, size),
             True, l2_flush())):
        us = device_us(fn, n, flush)
        bound = bound_us(raster_bytes(cfg, B, size, acc_on))
        out[name] = dict(device_us=us, bound_us=bound, bound_share=bound / us)
    out["raster_accumulate"]["l2_warm_device_us"] = device_us(
        lambda: cuda_raster.raster_accumulate(cfg, rows, acc, size), n)
    return out
