"""The port's standalone ``TetrisEngine``, ``convert_grayscale*`` and
movement primitives (``api/engine.py``, ``api/primitives.py``) on the CPU
against the JAX package's, bitwise; and the human render's transpose
identity on non-square boards."""

import numpy as np
import pytest

from gym_simpletetris_tpu.api import engine as jax_engine
from gym_simpletetris_tpu.api import primitives as jax_prim
from gym_simpletetris_tpu.core.pieces import OFFSETS
from gym_simpletetris_tpu.ops.raster import rasterize
from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.api import engine as port_engine
from gym_simpletetris_tpu_torch.api import primitives as port_prim
from gym_simpletetris_tpu_torch.api.gym_compat import board_image, human_image
from gym_simpletetris_tpu_torch.ops.bitops import unpack_board
import port_harness  # noqa: F401 (torch on one CPU thread)


_PROPS = ("board", "anchor", "shape", "shape_name", "shape_counts", "time",
          "score", "holes", "lines_cleared", "piece_height", "n_deaths",
          "_lock_delay")


def _same_props(j, p, msg=""):
    for f in _PROPS:
        assert getattr(p, f) == getattr(j, f) if f != "board" else \
            np.array_equal(p.board, j.board), (msg, f)


def test_engine_lockstep_with_jax():
    args = (9, 14, 1, True, True, False, True, True, False, True, False)
    j = jax_engine.TetrisEngine(*args, seed=5)
    p = port_engine.TetrisEngine(*args, seed=5, device="cpu")
    assert p._scoring == j._scoring
    assert p.nb_actions == j.nb_actions == 7
    np.testing.assert_array_equal(p.clear(), j.clear())
    rng = np.random.RandomState(2)
    dones = 0
    for t in range(200):
        a = int(rng.randint(0, 7))
        bj, rj, dj = j.step(a)
        bp, rp, dp = p.step(a)
        assert bp.dtype == bj.dtype and bp.shape == bj.shape
        np.testing.assert_array_equal(bp, bj, err_msg=f"step {t}")
        assert (rp, dp) == (rj, dj), t
        if t % 10 == 0 or dj:
            _same_props(j, p, t)
            assert p.get_info() == j.get_info()
            assert p.valid_action_count() == j.valid_action_count()
            assert repr(p) == repr(j)
            np.testing.assert_array_equal(p.render(), j.render())
        if dj:
            dones += 1
            inj = int(rng.randint(1, 36))
            np.testing.assert_array_equal(p.clear(injected_r=inj),
                                          j.clear(injected_r=inj))
    assert dones > 0


def test_engine_before_clear_and_board_setter():
    j = jax_engine.TetrisEngine(10, 20, seed=1)
    p = port_engine.TetrisEngine(10, 20, seed=1, device="cpu")
    _same_props(j, p, "before clear")
    assert p.time == p.score == -1 and p.anchor is None and p.shape is None
    assert p.shape_name is None
    assert p.get_info() == j.get_info()
    np.testing.assert_array_equal(p.render(), j.render())
    assert repr(p) == repr(j)
    with pytest.raises(TypeError):
        p.step(0)
    with pytest.raises(TypeError):
        p.valid_action_count()
    with pytest.raises(RuntimeError):
        p.board = np.zeros((10, 20))
    j.clear()
    p.clear()
    board = np.zeros((10, 20))
    board[:, 17:] = 1
    board[3, 17] = board[6, 18] = 0
    board[2, 12] = 2           # any nonzero value is an occupied cell
    for eng in (j, p):
        eng.board = board
    with pytest.raises(ValueError):
        p.board = np.zeros((20, 10))
    np.testing.assert_array_equal(p.board, board != 0)
    assert p._state.rows.dtype == p._state.time.dtype  # int32 words
    for a in [2, 0, 0, 2, 5, 1, 1, 1, 2, 3, 2]:
        out_j, out_p = j.step(a), p.step(a)
        np.testing.assert_array_equal(out_p[0], out_j[0])
        assert out_p[1:] == out_j[1:]
    _same_props(j, p, "after the setter")
    # reseed: the next clear() is a fresh engine with that seed
    p.seed(9)
    assert p.time == -1
    p.clear()
    fresh = port_engine.TetrisEngine(10, 20, seed=9, device="cpu")
    fresh.clear()
    _same_props(fresh, p, "seed")


@pytest.mark.parametrize("size", [84, 160, 64])
def test_convert_grayscale_against_jax(size):
    rng = np.random.RandomState(size)
    for shape in [(10, 20), (7, 3), (16, 16), (24, 30)]:
        for arr in (rng.randint(0, 2, shape),
                    rng.choice([0, 1, 5, 200, 255], shape),
                    rng.rand(*shape) * 3):
            got = port_engine.convert_grayscale(arr, size)
            want = jax_engine.convert_grayscale(arr, size)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                port_engine.convert_grayscale_rgb(got),
                jax_engine.convert_grayscale_rgb(want))
    with pytest.raises(ValueError):
        port_engine.convert_grayscale(np.zeros((200, 10)), 84)
    # the reshape to (shape[0], shape[1], 1) rejects a third axis > 1
    for fn in (port_engine.convert_grayscale_rgb,
               jax_engine.convert_grayscale_rgb):
        with pytest.raises(ValueError):
            fn(rng.randint(0, 255, (5, 7, 2)))
    one = rng.randint(0, 255, (5, 7, 1))
    np.testing.assert_array_equal(port_engine.convert_grayscale_rgb(one),
                                  jax_engine.convert_grayscale_rgb(one))


def test_primitives_against_jax():
    pairs = [(port_prim.left, jax_prim.left), (port_prim.right, jax_prim.right),
             (port_prim.soft_drop, jax_prim.soft_drop),
             (port_prim.hard_drop, jax_prim.hard_drop),
             (port_prim.rotate_left, jax_prim.rotate_left),
             (port_prim.rotate_right, jax_prim.rotate_right),
             (port_prim.idle, jax_prim.idle)]
    rng = np.random.RandomState(0)
    for trial in range(300):
        w, h = int(rng.randint(4, 12)), int(rng.randint(4, 16))
        board = (rng.rand(w, h) < 0.3).astype(float)
        shape = [tuple(c) for c in
                 OFFSETS[rng.randint(7), rng.randint(4)].tolist()]
        anchor = (int(rng.randint(-2, w + 2)), int(rng.randint(-4, h)))
        for ours, ref in pairs:
            assert ours(list(shape), anchor, board) == \
                ref(list(shape), anchor, board), (trial, ref.__name__)
        for cclk in (True, False):
            assert port_prim.rotated(shape, cclk) == \
                jax_prim.rotated(shape, cclk)
    assert list(port_prim.VALUE_ACTION_MAP) == list(jax_prim.VALUE_ACTION_MAP)


@pytest.mark.parametrize("wh", [(10, 20), (7, 13), (16, 5), (32, 20)])
def test_human_image_is_the_transposed_raster(wh):
    """The (W, H) board's raster (what the reference's human render draws)
    equals the transpose of the (H, W) raster that the raster kernel draws,
    at 512 and at 160 px, on non-square boards."""
    w, h = wh
    cfg = EnvConfig(width=w, height=h)
    env = TetrisVectorEnv(cfg, 3, device="cpu")
    _, s = env.reset(4)
    for a in [2, 0, 2, 1, 2, 4, 2]:
        _, s, *_ = env.step(s, np.full(3, a))
    rows = env.render_rows(s)[..., 1:2].contiguous()
    board = unpack_board(cfg, rows)[0].numpy()
    for size in (512, 160):
        want = np.asarray(rasterize(board[None], w, h, size))[0]
        got = human_image(cfg, rows, size)
        np.testing.assert_array_equal(got, np.repeat(want[..., None], 3, 2))
        np.testing.assert_array_equal(
            board_image(cfg, rows, size)[..., 0],
            np.asarray(rasterize(board.T[None], h, w, size))[0])
