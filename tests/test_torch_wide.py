"""Wide boards (width > 24, multi-word rows) in the PyTorch port, bit for bit
against the JAX package: bitops, piece masks across the word seam, the board
queries, ``engine_step`` over the flag sets with prefilled boards, line
clears, deaths, stepping past death and both kinds of spawn draw, the env's
reset / step / rollout for ram, grayscale and rgb with auto_reset, and the
plain raster and raster-accumulate against the host raster and the Pallas
raster-accumulate kernel in interpret mode. Every value is an exact integer
or half-integer, so every comparison is exact. csrc/step.cu and
csrc/raster.cu are held to the same plain versions on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import (FLAG_SETS, assert_out_equal, assert_state_equal,
                               line_clear_jax_state, prefilled_jax_state,
                               to_port)
from test_torch_env import assert_bitwise
from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu import TetrisVectorEnv as JaxEnv
from gym_simpletetris_tpu.api import env as jax_env
from gym_simpletetris_tpu.api import spaces as jax_spaces
from gym_simpletetris_tpu.core import engine as JE
from gym_simpletetris_tpu.core.state import init_state as jax_init_state
from gym_simpletetris_tpu.ops import bitops as jax_bitops
from gym_simpletetris_tpu.ops import raster as jax_raster
from gym_simpletetris_tpu.ops.pallas_raster import (
    raster_accumulate as pallas_raster_accumulate)
from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.api import env as port_env
from gym_simpletetris_tpu_torch.api import spaces
from gym_simpletetris_tpu_torch.core import engine as E
from gym_simpletetris_tpu_torch.core.state import (
    FIELDS, init_state, state_from_numpy, state_to_numpy)
from gym_simpletetris_tpu_torch.ops import bitops, raster
from gym_simpletetris_tpu_torch.utils.profiling import counters
import port_harness  # noqa: F401 (torch on one CPU thread)


def _pair_cfg(**kw):
    return JaxConfig(**kw), EnvConfig(**kw)


def _random_rows(cfg, B, rng, full_rows=True):
    """Random word-form rows (uint32 [H, NW, B], in-board bits only), with
    some rows full, as the JAX and the port state layouts."""
    h, w = cfg.height, cfg.width
    cells = rng.rand(B, w, h) < rng.rand(B, 1, 1)
    if full_rows:
        cells |= (rng.rand(B, h) < 0.3)[:, None, :]
    rows = jax_bitops.pack_board(JaxConfig(width=w, height=h), cells)
    return jnp.asarray(rows), torch.from_numpy(rows.view(np.int32))


@pytest.mark.parametrize("w,h", [(25, 8), (32, 20), (48, 12), (56, 10),
                                 (57, 6), (100, 5)])
def test_bitops_match_jax(w, h):
    jcfg, cfg = _pair_cfg(width=w, height=h)
    boards = (np.random.RandomState(w * h).rand(6, w, h) < 0.5).astype(np.uint8)
    packed = bitops.pack_board(cfg, boards)
    np.testing.assert_array_equal(packed, jax_bitops.pack_board(jcfg, boards))
    np.testing.assert_array_equal(bitops.pack_board(cfg, boards[0]),
                                  jax_bitops.pack_board(jcfg, boards[0]))
    assert packed.shape == (h, cfg.num_words, 6)
    trows = torch.from_numpy(packed.view(np.int32))
    for fn in ("unpack_cells", "unpack_rows", "unpack_board"):
        want = np.asarray(getattr(jax_bitops, fn)(jcfg, jnp.asarray(packed),
                                                  dtype=jnp.uint8))
        got = getattr(bitops, fn)(cfg, trows, dtype=torch.uint8)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn)
    np.testing.assert_array_equal(
        bitops.unpack_board(cfg, trows, dtype=torch.uint8).numpy(), boards)


@pytest.mark.parametrize("w", [48, 57])
def test_piece_masks_match_jax(w):
    """Every (piece, rotation, rotation step) at every anchor -1 .. W: the
    funnel shift across each word seam."""
    jcfg, cfg = _pair_cfg(width=w, height=6)
    p, r, x = np.meshgrid(np.arange(7), np.arange(4), np.arange(-1, w + 1),
                          indexing="ij")
    p, r, x = (v.reshape(-1).astype(np.int32) for v in (p, r, x))
    for delta in (-1, 0, 1):
        want = np.asarray(JE.piece_masks(jcfg, jnp.asarray(p), jnp.asarray(r),
                                         jnp.asarray(x), delta))
        got = E.piece_masks(cfg, torch.from_numpy(p), torch.from_numpy(r),
                            torch.from_numpy(x), delta)
        assert got.shape == (7, cfg.num_words, p.size)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _queries(E, cfg, rows, piece, rot, ax, ay, state):
    """The board queries of one engine module (JAX or the port), in the
    state layout: a dict of outputs."""
    cleared, n_full = E.clear_lines(cfg, rows)
    m = E.piece_masks(cfg, piece, rot, ax)
    win = E.extract_window(cfg, cleared, ay)
    return dict(
        cleared=cleared, n_full=n_full, holes=E.count_holes(cfg, rows),
        nonempty=E.nonempty_rows(cfg, rows), place=E.place_bits(cfg, m, ay),
        profile=E.collide_profile(cfg, E.pad_rows(cleared), m), window=win,
        collide=E.collide_window(cfg, win, m[None], ay),
        render=E.render_rows(cfg, state),
        valid_actions=E.valid_action_count(cfg, state))


@pytest.mark.parametrize("w,h", [(25, 6), (57, 5), (100, 4)])
def test_board_queries_match_jax(w, h):
    """clear_lines across the word seam, count_holes, nonempty_rows,
    place_bits, collide_profile, extract_window / collide_window,
    render_rows and valid_action_count on random word-form boards, at
    poses that reach past both sides of the board."""
    jcfg, cfg = _pair_cfg(width=w, height=h)
    rng = np.random.RandomState(w + h)
    B = 48
    jr, tr = _random_rows(cfg, B, rng)
    pose = [rng.randint(0, 7, B), rng.randint(0, 4, B),
            rng.randint(-1, w + 1, B), rng.randint(-3, h + 3, B)]
    js = jax_init_state(jcfg, B, jax.random.PRNGKey(0)).replace(
        rows=jr, piece=jnp.asarray(pose[0], jnp.int32),
        rot=jnp.asarray(pose[1], jnp.int32),
        ax=jnp.asarray(rng.randint(0, w, B), jnp.int32),
        ay=jnp.asarray(rng.randint(0, h, B), jnp.int32))
    want = jax.jit(lambda *a: _queries(JE, jcfg, *a))(
        jr, *(jnp.asarray(v, jnp.int32) for v in pose), js)
    got = _queries(E, cfg, tr, *(torch.from_numpy(v.astype(np.int32))
                                 for v in pose), to_port(js))
    assert int(np.asarray(want["n_full"]).sum()) > 0
    for k, v in want.items():
        g = got[k].numpy()
        np.testing.assert_array_equal(
            g.view(np.uint32) if g.dtype == np.int32 and v.dtype == jnp.uint32
            else g, np.asarray(v), err_msg=k)


def test_word_seam_line_clear_and_holes():
    """The port of tests/test_wide_boards.py's seam case: a full row across
    both words clears, and holes count across words."""
    cfg = EnvConfig(width=40, height=6)
    full = np.zeros((cfg.width, cfg.height), np.uint8)
    full[:, 5] = 1
    full[3, 4] = 1
    full[30, 3] = 1
    rows = torch.from_numpy(bitops.pack_board(cfg, full).view(np.int32))[..., None]
    cleared, n = E.clear_lines(cfg, rows)
    assert int(n[0]) == 1
    back = bitops.unpack_board(cfg, cleared, dtype=torch.uint8)[0]
    assert back[3, 5] == 1 and back[30, 4] == 1 and int(back.sum()) == 2
    assert int(E.count_holes(cfg, rows)[0]) == 1
    assert int(E.nonempty_rows(cfg, rows)[0]) == 3


# Each flag set of tests/test_torch_engine.py at one of the wide widths (its
# own width replaced, its height kept); each width appears at least once.
STEP_CASES = [("default", 25), ("advanced", 32), ("high_lock2", 40),
              ("w9_lock3", 57), ("w24", 32), ("w6_h8", 57)]


@pytest.mark.parametrize("name,width", STEP_CASES)
def test_engine_step_matches_jax(name, width):
    """80 steps at B = 16 from prefilled word-form boards, injected and
    threefry draws alternating. Even lanes start a new episode when they
    die; odd lanes step on past death."""
    flags = dict(FLAG_SETS[name], width=width)
    jcfg, cfg = _pair_cfg(**flags)
    assert cfg.num_words > 1
    B = 16
    rng = np.random.RandomState(width + len(name))
    js = prefilled_jax_state(jcfg, B, rng)
    ts = to_port(js)
    assert tuple(ts.rows.shape) == (cfg.height, cfg.num_words, B)
    j_inj = jax.jit(lambda s, a, r: JE.engine_step(jcfg, s, a, injected_r=r))
    j_drawn = jax.jit(lambda s, a: JE.engine_step(jcfg, s, a))
    j_reset = jax.jit(lambda s, e, m: jax_env.apply_reset_mask(jcfg, s, e, m))
    even = np.arange(B) % 2 == 0
    deaths = 0
    for t in range(80):
        a = rng.randint(0, 7, B)
        if t % 2:
            r = rng.randint(1, 36, B)
            jo = j_inj(js, jnp.asarray(a), jnp.asarray(r))
            to = E.engine_step(cfg, ts, torch.from_numpy(a), torch.from_numpy(r))
        else:
            jo = j_drawn(js, jnp.asarray(a))
            to = E.engine_step(cfg, ts, torch.from_numpy(a))
        assert_out_equal(jo, to, f"{name} w={width} t={t}")
        deaths += int(np.asarray(jo.done).sum())
        mask = np.asarray(jo.done) & even
        js, je = j_reset(jo.state, jo.emitted_rows, jnp.asarray(mask))
        ts, te = port_env.apply_reset_mask(cfg, to.state, to.emitted_rows,
                                           torch.from_numpy(mask))
        assert_state_equal(js, ts, f"{name} w={width} reset t={t}")
        np.testing.assert_array_equal(te.numpy().view(np.uint32), np.asarray(je))
    assert deaths > 0, deaths
    # CPU tensors never launch
    assert counters()["kernel.step.launches"] == 0


@pytest.mark.parametrize("width", [25, 40, 57])
def test_line_clears_match_jax(width):
    """Hard drops into prepared wells on word-form boards: 1-4 line clears
    and their NES scoring, then idles and random play."""
    jcfg, cfg = _pair_cfg(width=width, height=12, advanced_clears=True,
                          penalise_holes=True)
    B = 28
    rng = np.random.RandomState(300 + width)
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
        assert_out_equal(jo, to, f"w={width} t={t}")
        cleared.append(np.asarray(jo.state.lines_cleared)
                       - np.asarray(js.lines_cleared))
        js, ts = jo.state, to.state
    per_env = np.stack(cleared).max(axis=0)
    assert per_env.max() == 4 and (per_env > 0).sum() >= B // 2, per_env


@pytest.mark.parametrize("injected", [False, True])
def test_engine_clear_matches_jax(injected):
    jcfg, cfg = _pair_cfg(width=40, height=10, lock_delay=2)
    rng = np.random.RandomState(6)
    js = prefilled_jax_state(jcfg, 12, rng)
    js = js.replace(lock=jnp.arange(12, dtype=jnp.int32) % 3,
                    deaths=jnp.arange(12, dtype=jnp.int32))
    ts = to_port(js)
    r = rng.randint(1, 36, 12) if injected else None
    js2, je = JE.engine_clear(jcfg, js, None if r is None else jnp.asarray(r))
    ts2, te = E.engine_clear(cfg, ts, None if r is None else torch.from_numpy(r))
    assert_state_equal(js2, ts2)
    np.testing.assert_array_equal(te.numpy().view(np.uint32), np.asarray(je))


def test_init_state_layout():
    for w, nw in ((24, 1), (25, 2), (57, 3), (1024, 33)):
        jcfg, cfg = _pair_cfg(width=w, height=4)
        want = np.asarray(jax_init_state(jcfg, 3, jax.random.PRNGKey(0)).rows)
        got = init_state(cfg, 3, 0, device="cpu").rows
        assert cfg.num_words == nw and tuple(got.shape) == want.shape


@pytest.mark.parametrize("obs_type", ["ram", "grayscale", "rgb"])
def test_env_reset_step_matches_jax(obs_type):
    """TetrisVectorEnv at w32/h20 with auto_reset: reset, 40 steps, the info
    dict; a wide JAX state carried across mid-episode continues the same."""
    kw = dict(width=32, height=20, obs_type=obs_type, auto_reset=True)
    B = 8
    jenv = JaxEnv(JaxConfig(**kw), B)
    tenv = TetrisVectorEnv(EnvConfig(**kw), B, device="cpu")
    jobs, js = jenv.reset(jax.random.PRNGKey(7))
    tobs, ts = tenv.reset(7)
    assert_bitwise(tobs, jobs, "reset obs")
    assert_state_equal(js, ts, "reset")
    rng = np.random.RandomState(8)
    dones = 0
    for t in range(40):
        a = rng.randint(0, 7, B)
        jobs, js, jr, jd, jinfo = jenv.step(js, jnp.asarray(a))
        tobs, ts, tr, td, tinfo = tenv.step(ts, a)
        assert_bitwise(tobs, jobs, f"obs t={t}")
        assert_bitwise(tr, jr, f"reward t={t}")
        assert_bitwise(td, jd, f"done t={t}")
        for k in jinfo:
            assert_bitwise(tinfo[k], jinfo[k], f"info[{k}] t={t}")
        assert_state_equal(js, ts, f"t={t}")
        dones += int(np.asarray(jd).sum())
    assert dones > 0
    assert tobs.shape == (B,) + tenv.observation_space.shape
    d = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    back = state_to_numpy(state_from_numpy(d))
    for f in FIELDS:
        assert back[f].dtype == d[f].dtype, f
        np.testing.assert_array_equal(back[f], d[f], err_msg=f)


@pytest.mark.parametrize("obs_type,acc_mode", [
    ("ram", "storage"), ("grayscale", "storage"), ("rgb", "delivered")])
def test_rollout_matches_jax(obs_type, acc_mode):
    """From prefilled word-form boards, so episodes end and auto-reset
    inside the rollout. (rgb's storage observation is grayscale's.)"""
    kw = dict(width=32, height=20, obs_type=obs_type, auto_reset=True)
    B = 8
    jenv = JaxEnv(JaxConfig(**kw), B)
    tenv = TetrisVectorEnv(EnvConfig(**kw), B, device="cpu")
    js = prefilled_jax_state(jenv.config, B, np.random.RandomState(9))
    ts = to_port(js)
    acts = np.random.RandomState(10).randint(0, 7, (30, B)).astype(np.int32)
    jf, jacc, jrew, jdone = jenv.rollout(js, jnp.asarray(acts),
                                         acc_mode=acc_mode)
    tf, tacc, trew, tdone = tenv.rollout(ts, acts, acc_mode=acc_mode)
    assert_state_equal(jf, tf)
    assert_bitwise(tacc, jacc, "acc")
    assert_bitwise(trew, jrew, "reward")
    assert_bitwise(tdone, jdone, "done")
    assert int(np.asarray(jdone).sum()) > 0


@pytest.mark.parametrize("w,h", [(32, 20), (40, 30)])
def test_plain_accumulate_matches_pallas(w, h):
    """Three folds into a random uint8 accumulator (every value wraps),
    against the Pallas raster-accumulate kernel in interpret mode."""
    jcfg, cfg = _pair_cfg(width=w, height=h)
    acc0 = np.random.RandomState(2).randint(0, 256, (8, 84, 84), dtype=np.uint8)
    jacc, tacc = jnp.asarray(acc0), torch.from_numpy(acc0.copy())
    rng = np.random.RandomState(w * h)
    for _ in range(3):
        jr, tr = _random_rows(cfg, 8, rng, full_rows=False)
        jacc = pallas_raster_accumulate(jcfg, jr, jacc, interpret=True)
        out = raster.raster_accumulate_plain(cfg, tr, tacc)
        assert out is tacc
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))


@pytest.mark.parametrize("w,h,size", [(33, 14, 160), (40, 26, 512)])
def test_plain_raster_matches_host(w, h, size):
    """The render-fuzz wide geometries (tests/test_render_fuzz.py)."""
    cfg = EnvConfig(width=w, height=h)
    jr, tr = _random_rows(cfg, 3, np.random.RandomState(size), full_rows=False)
    got = raster.rasterize_rows_plain(cfg, tr, size).numpy()
    cells = np.asarray(jax_bitops.unpack_rows(JaxConfig(width=w, height=h), jr,
                                              dtype=jnp.uint8))   # [B, H, W]
    for b in range(3):
        np.testing.assert_array_equal(
            got[b], jax_raster.rasterize_host(cells[b], h, w, size))


def test_image_width_limit_matches_jax():
    """At 84 px an image observation fits up to width 41; width 42 raises
    ValueError in both packages."""
    for w in (41, 42):
        kw = dict(width=w, height=20, obs_type="grayscale")
        jenv = JaxEnv(JaxConfig(**kw), 2)
        tenv = TetrisVectorEnv(EnvConfig(**kw), 2, device="cpu")
        if w == 41:
            assert_bitwise(tenv.reset(0)[0], jenv.reset(jax.random.PRNGKey(0))[0])
            continue
        with pytest.raises(ValueError, match="too large"):
            jenv.reset(jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="too large"):
            tenv.reset(0)


@pytest.mark.parametrize("kw", [
    dict(width=32, height=20), dict(width=57, height=9, extend_dims=True),
    dict(width=1024, height=3, obs_dtype="uint8"),
    dict(width=40, obs_type="grayscale"), dict(width=25, obs_type="rgb")])
def test_spaces_match_jax(kw):
    jcfg, cfg = _pair_cfg(**kw)
    a, b = spaces.observation_space(cfg), jax_spaces.observation_space(jcfg)
    assert (a.shape, a.dtype, a.low, a.high) == (b.shape, b.dtype, b.low, b.high)
    if cfg.obs_type == "ram":
        assert a.shape[:2] == (cfg.width, cfg.height)


def test_widest_board_steps_on_the_cpu():
    """Width 1024 (NW = 33): 30 steps from prefilled boards against JAX;
    CPU tensors never launch a kernel."""
    jcfg, cfg = _pair_cfg(width=1024, height=6, penalise_height_increase=True)
    B = 4
    rng = np.random.RandomState(4)
    js = prefilled_jax_state(jcfg, B, rng)
    ts = to_port(js)
    launches = ("kernel.step.launches", "kernel.raster.launches",
                "kernel.raster_acc.launches")
    n = [counters()[k] for k in launches]
    j_inj = jax.jit(lambda s, a, r: JE.engine_step(jcfg, s, a, injected_r=r))
    for t in range(30):
        a, r = rng.randint(0, 7, B), rng.randint(1, 36, B)
        jo = j_inj(js, jnp.asarray(a, jnp.int32), jnp.asarray(r, jnp.int32))
        to = E.engine_step(cfg, ts, torch.from_numpy(a), torch.from_numpy(r))
        assert_out_equal(jo, to, f"t={t}")
        js, ts = jo.state, to.state
    np.testing.assert_array_equal(
        bitops.unpack_board(cfg, ts.rows, torch.uint8).numpy(),
        np.asarray(jax_bitops.unpack_board(jcfg, js.rows, jnp.uint8)))
    assert int(ts.deaths.sum()) > 0
    assert [counters()[k] for k in launches] == n
