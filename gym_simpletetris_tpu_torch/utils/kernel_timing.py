"""Device time of the port's CUDA kernels, and the bound each is held to.

- ``device_us``: one launch's device time, by CUDA events around the replay
  of a CUDA graph of launches, so no host time falls between them;
- ``sync_ms``: one wrapper call as its caller sees it (Python and ctypes
  included), by CUDA events over back-to-back calls;
- ``step_bytes`` / ``raster_bytes``: the bytes kernel A and kernels B, C
  must move; ``bound_us`` turns bytes into the least time at the H100's HBM
  rate;
- ``raster_device_times``: kernels B and C at one shape, each beside its
  bound, with plain-stream yardsticks.

``chip_smoke.py`` and ``tools/torch_raster_abba.py`` time the kernels with
these. Everything here needs a CUDA card but ``bound_us`` and the byte
counts.
"""

from __future__ import annotations

import statistics

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


def step_bytes(cfg, B: int) -> int:
    """Kernel A's bytes: rows read, rows and emitted rows written (4 * H *
    NW each), 11 scalars and 7 counts read and written, action and draw
    read, reward written (4 bytes each), done written (1 byte), per env:
    397 B at 10 x 20."""
    return B * (12 * cfg.height * cfg.num_words + 157)


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
