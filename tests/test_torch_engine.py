"""The port's plain-PyTorch engine equals the JAX engine bit for bit — the JAX
``engine_step`` and the Pallas step kernel in interpret mode — over the flag
matrix, odd and full (24) widths, lock delay, stepping past death, and
injected and threefry spawn draws. On the CPU, ``engine_step`` takes the
plain body; csrc/step.cu is held to the same body on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu.api import env as jax_env
from gym_simpletetris_tpu.core import engine as JE
from gym_simpletetris_tpu.core.state import init_state as jax_init_state
from gym_simpletetris_tpu.ops.pallas_step import engine_step_pallas
from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.api import env as port_env
from gym_simpletetris_tpu_torch.core import engine as E
from gym_simpletetris_tpu_torch.utils.profiling import counters
from port_harness import assert_state_equal, to_port

FLAG_SETS = {
    "default": dict(),
    "advanced": dict(reward_step=True, advanced_clears=True,
                     penalise_height=True, penalise_holes=True),
    "high_lock2": dict(high_scoring=True, penalise_height_increase=True,
                       penalise_holes_increase=True, lock_delay=2,
                       step_reset=True),
    "w9_lock3": dict(width=9, height=12, lock_delay=3),
    "w24": dict(width=24, height=10, reward_step=True,
                penalise_holes_increase=True),        # masks reach bit 31
    "w6_h8": dict(width=6, height=8, lock_delay=1, step_reset=True,
                  penalise_height=True),
}


def assert_out_equal(jo, to, msg=""):
    assert_state_equal(jo.state, to.state, msg)
    np.testing.assert_array_equal(to.emitted_rows.numpy().view(np.uint32),
                                  np.asarray(jo.emitted_rows), err_msg=msg)
    # bitwise: every reward is an exact small integer or half-integer
    np.testing.assert_array_equal(to.reward.numpy().view(np.int32),
                                  np.asarray(jo.reward).view(np.int32),
                                  err_msg=msg)
    np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done),
                                  err_msg=msg)


def word_rows(jcfg, ints):
    """Python-int rows [H][B] (bit x + 4 is column x) -> the JAX state
    layout: uint32 [H, B], or [H, NW, B] for wide boards."""
    nw = jcfg.num_words
    rows = np.array([[[(v >> (32 * w)) & 0xFFFFFFFF for v in row]
                      for w in range(nw)] for row in ints], dtype=np.uint32)
    return rows[:, 0] if nw == 1 else rows


def prefilled_jax_state(jcfg, B, rng):
    """A cleared JAX state whose lower rows are full but for one hole each,
    so random play clears lines, scores and dies."""
    s = jax_init_state(jcfg, B, jax.random.PRNGKey(int(rng.randint(1 << 30))))
    s, _ = JE.engine_clear(jcfg, s, injected_r=jnp.asarray(
        rng.randint(1, 36, B), jnp.int32))
    H = jcfg.height
    rows = [[0] * B for _ in range(H)]
    for b in range(B):
        for y in range(H - rng.randint(0, H // 2 + 1), H):
            hole = 1 << (4 + rng.randint(0, jcfg.width))
            rows[y][b] = jcfg.valid_mask & ~hole
    return s.replace(rows=jnp.asarray(word_rows(jcfg, rows)))


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_engine_step_matches_jax(name):
    """80 steps at B = 16, injected and drawn spawns alternating. Even lanes
    start a new episode when they die; odd lanes step on past death."""
    flags = FLAG_SETS[name]
    jcfg, cfg = JaxConfig(**flags), EnvConfig(**flags)
    B = 16
    rng = np.random.RandomState(len(name))
    js = prefilled_jax_state(jcfg, B, rng)
    ts = to_port(js)
    j_inj = jax.jit(lambda s, a, r: JE.engine_step(jcfg, s, a, injected_r=r))
    j_drawn = jax.jit(lambda s, a: JE.engine_step(jcfg, s, a))
    j_reset = jax.jit(lambda s, e, m: jax_env.apply_reset_mask(jcfg, s, e, m))
    even = np.arange(B) % 2 == 0
    deaths = lines = 0
    for t in range(80):
        a = rng.randint(0, 7, B)
        if t % 2:
            r = rng.randint(1, 36, B)
            jo = j_inj(js, jnp.asarray(a), jnp.asarray(r))
            to = E.engine_step(cfg, ts, torch.from_numpy(a), torch.from_numpy(r))
        else:
            jo = j_drawn(js, jnp.asarray(a))
            to = E.engine_step(cfg, ts, torch.from_numpy(a))
        assert_out_equal(jo, to, f"{name} t={t}")
        deaths += int(np.asarray(jo.done).sum())
        lines += int((np.asarray(jo.state.lines_cleared)
                      - np.asarray(js.lines_cleared)).sum())
        mask = np.asarray(jo.done) & even
        js, je = j_reset(jo.state, jo.emitted_rows, jnp.asarray(mask))
        ts, te = port_env.apply_reset_mask(cfg, to.state, to.emitted_rows,
                                           torch.from_numpy(mask))
        assert_state_equal(js, ts, f"{name} reset t={t}")
        np.testing.assert_array_equal(te.numpy().view(np.uint32), np.asarray(je))
    assert deaths > 0, deaths
    # CPU tensors never launch
    assert counters()["kernel.step.launches"] == 0


def line_clear_jax_state(jcfg, B, rng):
    """Env b holds a random piece at the top over a board whose bottom rows
    are full but for the piece's footprint when it rests on the floor, and
    for the shaft above that footprint: a hard drop clears up to 4 lines."""
    from gym_simpletetris_tpu.core.pieces import OFFSETS
    H, W = jcfg.height, jcfg.width
    piece, rot = rng.randint(0, 7, B), rng.randint(0, 4, B)
    ax = np.zeros(B, np.int32)
    rows = [[0] * B for _ in range(H)]
    for b in range(B):
        cells = OFFSETS[piece[b], rot[b]].astype(int)        # (dx, dy)
        ax[b] = rng.randint(-cells[:, 0].min(), W - cells[:, 0].max())
        ay_rest = H - 1 - cells[:, 1].max()
        fill = np.ones((H, W), bool)
        fill[:ay_rest + cells[:, 1].min()] = False            # above the piece
        for dx, dy in cells:
            fill[:ay_rest + dy + 1, ax[b] + dx] = False       # footprint + shaft
        for y in range(H):
            rows[y][b] = sum(1 << (4 + x) for x in range(W) if fill[y, x])
    s = jax_init_state(jcfg, B, jax.random.PRNGKey(int(rng.randint(1 << 30))))
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    return s.replace(rows=jnp.asarray(word_rows(jcfg, rows)), piece=i32(piece), rot=i32(rot),
                     ax=i32(ax), ay=i32(np.zeros(B)), time=i32(np.zeros(B)),
                     score=i32(np.zeros(B)))


@pytest.mark.parametrize("name", ["default", "advanced", "high_lock2",
                                  "w9_lock3", "w24"])
def test_line_clears_match_jax(name):
    """Hard drops into prepared wells: 1-4 line clears and their scoring,
    then idles (for the lock delay) and random play."""
    flags = FLAG_SETS[name]
    jcfg, cfg = JaxConfig(**flags), EnvConfig(**flags)
    B = 28
    rng = np.random.RandomState(200 + len(name))
    js = line_clear_jax_state(jcfg, B, rng)
    ts = to_port(js)
    j_inj = jax.jit(lambda s, a, r: JE.engine_step(jcfg, s, a, injected_r=r))
    cleared = []
    for t in range(12):
        a = np.full(B, JE.A_HARD if t == 0 else JE.A_IDLE)
        if t >= 5:
            a = rng.randint(0, 7, B)
        r = rng.randint(1, 36, B)
        jo = j_inj(js, jnp.asarray(a, jnp.int32), jnp.asarray(r, jnp.int32))
        to = E.engine_step(cfg, ts, torch.from_numpy(a), torch.from_numpy(r))
        assert_out_equal(jo, to, f"{name} t={t}")
        cleared.append(np.asarray(jo.state.lines_cleared)
                       - np.asarray(js.lines_cleared))
        js, ts = jo.state, to.state
    per_env = np.stack(cleared).max(axis=0)
    assert per_env.max() >= 3 and (per_env > 0).sum() >= B // 3, per_env


@pytest.mark.parametrize("name", ["default", "advanced", "high_lock2",
                                  "w9_lock3"])
def test_engine_step_matches_pallas_interpret(name):
    """The port against the Pallas step kernel itself (interpret mode)."""
    flags = FLAG_SETS[name]
    jcfg, cfg = JaxConfig(**flags), EnvConfig(**flags)
    B = 8
    rng = np.random.RandomState(100 + len(name))
    js = prefilled_jax_state(jcfg, B, rng)
    ts = to_port(js)
    pallas = jax.jit(lambda s, a, r: engine_step_pallas(
        jcfg, s, a, injected_r=r, block_b=B, interpret=True))
    for t in range(30):
        a, r = rng.randint(0, 7, B), rng.randint(1, 36, B)
        jo = pallas(js, jnp.asarray(a, jnp.int32), jnp.asarray(r, jnp.int32))
        to = E.engine_step(cfg, ts, torch.from_numpy(a), torch.from_numpy(r))
        assert_out_equal(jo, to, f"{name} t={t}")
        js, ts = jo.state, to.state


@pytest.mark.parametrize("injected", [False, True])
def test_engine_clear_matches_jax(injected):
    jcfg, cfg = JaxConfig(lock_delay=2), EnvConfig(lock_delay=2)
    rng = np.random.RandomState(5)
    js = prefilled_jax_state(jcfg, 12, rng)
    js = js.replace(lock=jnp.arange(12, dtype=jnp.int32) % 3,
                    deaths=jnp.arange(12, dtype=jnp.int32))
    ts = to_port(js)
    r = rng.randint(1, 36, 12) if injected else None
    js2, je = JE.engine_clear(jcfg, js, None if r is None else jnp.asarray(r))
    ts2, te = E.engine_clear(cfg, ts, None if r is None else torch.from_numpy(r))
    assert_state_equal(js2, ts2)
    np.testing.assert_array_equal(te.numpy().view(np.uint32), np.asarray(je))


def test_board_queries_match_jax():
    """clear_lines, count_holes, nonempty_rows, render_rows,
    valid_action_count and the sampler on random boards and poses."""
    rng = np.random.RandomState(9)
    for w, h in ((10, 20), (9, 12), (24, 6)):
        jcfg, cfg = JaxConfig(width=w, height=h), EnvConfig(width=w, height=h)
        B = 64
        cells = rng.rand(h, w, B) < rng.rand(1, 1, B)
        cells |= (rng.rand(h, B) < 0.3)[:, None, :]          # full rows
        rows = (cells.astype(np.uint32)
                << (np.arange(w, dtype=np.uint32) + 4)[None, :, None]).sum(
                    axis=1, dtype=np.uint32)
        jr, tr = jnp.asarray(rows), torch.from_numpy(rows.view(np.int32))
        jc, jn = JE.clear_lines(jcfg, jr)
        tc, tn = E.clear_lines(cfg, tr)
        np.testing.assert_array_equal(tc.numpy().view(np.uint32), np.asarray(jc))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        for fn in ("count_holes", "nonempty_rows"):
            np.testing.assert_array_equal(
                getattr(E, fn)(cfg, tr).numpy(),
                np.asarray(getattr(JE, fn)(jcfg, jr)), err_msg=fn)
        js = jax_init_state(jcfg, B, jax.random.PRNGKey(0)).replace(
            rows=jc, piece=jnp.asarray(rng.randint(0, 7, B), jnp.int32),
            rot=jnp.asarray(rng.randint(0, 4, B), jnp.int32),
            ax=jnp.asarray(rng.randint(0, w, B), jnp.int32),
            ay=jnp.asarray(rng.randint(0, h, B), jnp.int32))
        ts = to_port(js)
        np.testing.assert_array_equal(
            E.render_rows(cfg, ts).numpy().view(np.uint32),
            np.asarray(JE.render_rows(jcfg, js)))
        np.testing.assert_array_equal(
            E.valid_action_count(cfg, ts).numpy(),
            np.asarray(JE.valid_action_count(jcfg, js)))
    counts = rng.randint(0, 50, (7, 200)).astype(np.int32)
    s = np.asarray(JE.piece_weight_sum(jnp.asarray(counts)))
    np.testing.assert_array_equal(
        E.piece_weight_sum(torch.from_numpy(counts)).numpy(), s)
    r = (rng.randint(0, 1 << 30, 200) % s + 1).astype(np.int32)
    np.testing.assert_array_equal(
        E.sample_piece(torch.from_numpy(counts), torch.from_numpy(r)).numpy(),
        np.asarray(JE.sample_piece(jnp.asarray(counts), jnp.asarray(r))))


def test_piece_masks_match_jax():
    """Every (piece, rotation, rotation step, anchor) the engine can form,
    word form [NROWS, NW, B] as in the JAX engine."""
    cfg, jcfg = EnvConfig(width=24), JaxConfig(width=24)
    p, r, x = np.meshgrid(np.arange(7), np.arange(4), np.arange(-1, 26),
                          indexing="ij")
    p, r, x = (v.reshape(-1).astype(np.int32) for v in (p, r, x))
    for delta in (-1, 0, 1):
        want = np.asarray(JE.piece_masks(jcfg, jnp.asarray(p), jnp.asarray(r),
                                         jnp.asarray(x), delta))
        got = E.piece_masks(cfg, torch.from_numpy(p), torch.from_numpy(r),
                            torch.from_numpy(x), delta)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
