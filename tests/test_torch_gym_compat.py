"""The port's old-gym shim (``api/gym_compat.TetrisEnv``) on the CPU against
the JAX package's, bitwise: observations, rewards, dones and info dicts in
lockstep (threefry seeds and injected draws), the ``_observation`` hook,
the renders, and the engine view."""

import numpy as np
import pytest

from gym_simpletetris_tpu.api.gym_compat import TetrisEnv as JaxEnv
from gym_simpletetris_tpu.ops.raster import rasterize
from gym_simpletetris_tpu_torch.api.gym_compat import TetrisEnv, human_image
from gym_simpletetris_tpu_torch.ops.raster import rasterize_host
import port_harness  # noqa: F401 (torch on one CPU thread)


LOCKSTEP = {
    "ram": dict(obs_type="ram", reward_step=True, penalise_holes=True),
    "grayscale": dict(obs_type="grayscale", advanced_clears=True,
                      lock_delay=1),
    "rgb": dict(obs_type="rgb", high_scoring=True, step_reset=True,
                lock_delay=1),
    "grayscale-extend": dict(obs_type="grayscale", extend_dims=True,
                             penalise_height_increase=True),
    "ram-32-wide": dict(obs_type="ram", width=32, height=12,
                        penalise_height=True),
}


def _draw(info, rng):
    """A spawn draw for the next transition: randint(1, sum(m)) of the
    count-balanced weights m = 5 + max(counts) - counts."""
    c = np.array(list(info["statistics"].values()))
    return int(rng.randint(1, int((5 + c.max() - c).sum()) + 1))


def _same(j, p, msg):
    assert p[0].dtype == j[0].dtype == np.float32, msg
    assert p[0].shape == j[0].shape, msg
    np.testing.assert_array_equal(p[0], j[0], err_msg=msg)
    assert p[1:] == j[1:], (msg, p[1:], j[1:])


@pytest.mark.parametrize("name", sorted(LOCKSTEP))
def test_shim_lockstep_with_jax(name):
    """Threefry draws from the seed for the first half, injected draws for
    the second, episodes reset on done; every output bitwise."""
    kw = LOCKSTEP[name]
    j, p = JaxEnv(seed=7, **kw), TetrisEnv(seed=7, device="cpu", **kw)
    oj, ij = j.reset(return_info=True)
    op, ip = p.reset(return_info=True)
    _same((oj, ij), (op, ip), "reset")
    rng = np.random.RandomState(1)
    dones = 0
    for t in range(80):
        a = int(rng.choice([0, 1, 2, 2, 3, 4, 5, 6]))   # hard-drop heavy
        inj = _draw(ij, rng) if t >= 40 else None
        rj = j.step(a, injected_r=inj)
        rp = p.step(a, injected_r=inj)
        _same(rj, rp, f"{name} step {t}")
        ij = rj[3]
        if rj[2]:
            dones += 1
            inj = _draw(ij, rng) if t >= 40 else None
            oj, ij = j.reset(return_info=True, injected_r=inj)
            op, ip = p.reset(return_info=True, injected_r=inj)
            _same((oj, ij), (op, ip), f"{name} reset after {t}")
    assert dones > 0
    assert p.valid_action_count() == j.valid_action_count()
    assert repr(p) == repr(j)
    np.testing.assert_array_equal(p.render("rgb_array"), j.render("rgb_array"))


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port env, 30 steps into one episode."""
    j = JaxEnv(obs_type="ram", seed=3)
    p = TetrisEnv(obs_type="ram", seed=3, device="cpu")
    j.reset()
    p.reset()
    for a in [0, 0, 5, 2, 1, 1, 4, 2, 3, 3] * 3:
        j.step(a)
        p.step(a)
    return j, p


def test_observation_hook_with_user_arrays(pair):
    """``_observation`` on the live board and on user arrays, with the
    value pass-through of ``convert_grayscale`` (values other than 0 / 1
    become the pixel's shade)."""
    j, p = pair
    rng = np.random.RandomState(0)
    boards = [None, rng.randint(0, 2, (10, 20)).astype(float),
              rng.choice([0, 1, 7, 255, 60], (10, 20))]
    for state in boards:
        for mode in (None, "ram", "grayscale", "rgb"):
            for ext in (None, True, False):
                want = j._observation(mode, state, ext)
                got = p._observation(mode, state, ext)
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)


def test_renders(pair, monkeypatch):
    """``rgb_array`` at 160 px; ``human`` under pygame's dummy video driver:
    the window holds the same pixels as the JAX package's, and the image
    is the 512 px raster of the (W, H) board."""
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    pygame = pytest.importorskip("pygame")
    j, p = pair
    img = p.render("rgb_array")
    assert img.shape == (160, 160, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, j.render("rgb_array"))
    board = p._board()
    want = rasterize_host(board, p.width, p.height, 512)
    human = human_image(p.config, p._rows(), 512)
    np.testing.assert_array_equal(human[..., 0], want)
    np.testing.assert_array_equal(
        human, np.asarray(rasterize(board[None], 10, 20, 512))[0][..., None]
        .repeat(3, axis=2))
    windows = []
    for env in (p, j):
        assert env.render("human") is None
        windows.append(pygame.surfarray.array3d(env.window).copy())
        pygame.display.quit()
        env.window = env.clock = None
    np.testing.assert_array_equal(windows[0], windows[1])
    np.testing.assert_array_equal(windows[0], human)
    with pytest.raises(NotImplementedError):
        p.render("ansi")


def test_engine_view_seed_and_no_op_actions():
    j = JaxEnv(obs_type="ram", seed=11, lock_delay=1)
    p = TetrisEnv(obs_type="ram", seed=11, lock_delay=1, device="cpu")
    assert repr(p) == "TetrisEnv(10x20, unreset)"
    with pytest.raises(RuntimeError):
        p.step(0)
    with pytest.raises(RuntimeError):
        p.engine.board
    j.reset()
    p.reset()
    for t, a in enumerate([0, 5, 1, -1, 7, 99, 2, 3, 6, 4] * 4):
        before = p.engine.board, p.engine.anchor, p.engine.shape
        rj, rp = j.step(a), p.step(a)
        _same(rj, rp, f"step {t} action {a}")
        if a in (-1, 7, 99) and not rp[2]:
            # a no-op: only gravity moves the piece
            assert p.engine.shape == before[2]
            assert p.engine.anchor[0] == before[1][0]
        for f in ("board", "anchor", "shape_name", "shape", "shape_counts",
                  "time", "score", "holes", "lines_cleared", "n_deaths",
                  "width", "height"):
            np.testing.assert_array_equal(getattr(p.engine, f),
                                          getattr(j.engine, f), err_msg=f)
        assert p.engine.valid_action_count() == j.engine.valid_action_count()
        np.testing.assert_array_equal(p.engine.render(), j.engine.render())
        assert p.engine.get_info() == j.engine.get_info()
        assert repr(p) == repr(j)
        if rp[2]:
            j.reset()
            p.reset()
    # seed() in place: the next reset is a fresh engine with that seed
    for s in (11, 4):
        p.seed(s)
        fresh = TetrisEnv(obs_type="ram", seed=s, lock_delay=1, device="cpu")
        assert p.reset(return_info=True)[1] == fresh.reset(return_info=True)[1]
        assert p.step(2)[1:] == fresh.step(2)[1:]
    assert [f.__name__ for f in p.value_action_map.values()] == \
        [f.__name__ for f in j.value_action_map.values()]
    assert p.nb_actions == 7 and p.action_value_map[p.value_action_map[2]] == 2
    p.close()
    assert p._state is None


def test_to_host_round_trips_each_dtype():
    """``api.env.to_host``: one copy, each tensor back in its dtype and
    shape (float32 by its bits, NaN included); 8-byte dtypes refused."""
    import torch
    from gym_simpletetris_tpu_torch.api.env import to_host
    ts = (torch.tensor([[1.5, float("nan")], [-0.0, 3e38]]),
          torch.tensor([True, False, True]),
          torch.arange(-3, 3, dtype=torch.int32).reshape(2, 3),
          torch.tensor([0, 128, 255], dtype=torch.uint8),
          torch.ones(2, 1)[..., None].expand(2, 1, 3))
    for got, t in zip(to_host(*ts), ts):
        want = t.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == np.ascontiguousarray(want).tobytes()
    for bad in (torch.zeros(2, dtype=torch.float64),
                torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(TypeError):
            to_host(bad)
