"""The port's TetrisVectorEnv equals the JAX TetrisVectorEnv bit for bit from
the same PRNGKey seed: reset / step / rollout for ram, grayscale and rgb with
auto_reset, the info dict (lines_delta included), a JAX state carried across
mid-episode, and the five golden reference traces."""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu import TetrisVectorEnv as JaxEnv
from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.core import engine as E
from gym_simpletetris_tpu_torch.core.pieces import PIECE_NAMES
from gym_simpletetris_tpu_torch.core.state import (
    FIELDS, init_state, state_from_numpy, state_to_numpy)
from gym_simpletetris_tpu_torch.ops.bitops import unpack_board

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "golden_traces.json")
B = 8


def to_port(js):
    return state_from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS})


def assert_state_equal(js, ts, msg=""):
    got = state_to_numpy(ts)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                      err_msg=f"state.{f} {msg}")


def assert_bitwise(got: torch.Tensor, want, msg=""):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (msg, got.shape, want.shape)
    g = got.numpy()
    if g.dtype == np.float32:
        g, want = g.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(g, want, err_msg=msg)


def _pair(**kw):
    return (JaxEnv(JaxConfig(**kw), B),
            TetrisVectorEnv(EnvConfig(**kw), B, device="cpu"))


@pytest.mark.parametrize("kw", [
    dict(obs_type="ram", auto_reset=True),
    dict(obs_type="grayscale", auto_reset=True),
    dict(obs_type="rgb", auto_reset=True),
    dict(obs_type="grayscale", auto_reset=True, extend_dims=True,
         obs_dtype="uint8", width=9, height=12),
    dict(obs_type="ram", extend_dims=True, reward_step=True,
         penalise_holes=True),                # no auto_reset: steps past death
], ids=["ram", "grayscale", "rgb", "gray_u8_w9", "ram_no_reset"])
def test_env_reset_step_matches_jax(kw):
    jenv, tenv = _pair(**kw)
    jobs, js = jenv.reset(jax.random.PRNGKey(3))
    tobs, ts = tenv.reset(3)
    assert_bitwise(tobs, jobs, "reset obs")
    assert_state_equal(js, ts, "reset")
    rng = np.random.RandomState(4)
    dones = 0
    for t in range(48):
        a = rng.randint(0, 7, B)
        jobs, js, jr, jd, jinfo = jenv.step(js, jnp.asarray(a))
        tobs, ts, tr, td, tinfo = tenv.step(ts, a)
        assert_bitwise(tobs, jobs, f"obs t={t}")
        assert_bitwise(tr, jr, f"reward t={t}")
        assert_bitwise(td, jd, f"done t={t}")
        assert set(tinfo) == set(jinfo)
        for k in jinfo:
            assert_bitwise(tinfo[k], jinfo[k], f"info[{k}] t={t}")
        assert_state_equal(js, ts, f"t={t}")
        dones += int(np.asarray(jd).sum())
    assert dones > 0
    assert tobs.shape == (B,) + tenv.observation_space.shape


@pytest.mark.parametrize("obs_type,acc_mode", [
    ("ram", "storage"), ("grayscale", "storage"), ("rgb", "storage"),
    ("rgb", "delivered"), ("ram", "delivered")])
def test_rollout_matches_jax(obs_type, acc_mode):
    jenv, tenv = _pair(obs_type=obs_type, auto_reset=True)
    _, js = jenv.reset(jax.random.PRNGKey(5))
    _, ts = tenv.reset(5)
    acts = np.random.RandomState(6).randint(0, 7, (24, B)).astype(np.int32)
    jf, jacc, jrew, jdone = jenv.rollout(js, jnp.asarray(acts),
                                         acc_mode=acc_mode)
    tf, tacc, trew, tdone = tenv.rollout(ts, acts, acc_mode=acc_mode)
    assert_state_equal(jf, tf)
    assert_bitwise(tacc, jacc, "acc")
    assert_bitwise(trew, jrew, "reward")
    assert_bitwise(tdone, jdone, "done")


def test_rollout_equals_step_loop_without_obs():
    tenv = TetrisVectorEnv(EnvConfig(auto_reset=True), B, device="cpu")
    _, s = tenv.reset(1)
    acts = np.random.RandomState(2).randint(0, 7, (20, B))
    final, acc, rew, done = tenv.rollout(s, acts, with_obs=False)
    assert not acc.any()
    for t, a in enumerate(acts):
        _, s, r, d, _ = tenv.step(s, a)
        assert torch.equal(r, rew[t]) and torch.equal(d, done[t])
    assert torch.equal(final.rows, s.rows) and torch.equal(final.key, s.key)


def test_state_from_jax_mid_episode():
    """A JAX state carried across continues identically, including its
    threefry stream; the numpy round trip keeps every bit."""
    jenv, tenv = _pair(obs_type="grayscale", auto_reset=True,
                       penalise_height_increase=True)
    _, js = jenv.reset(jax.random.PRNGKey(11))
    rng = np.random.RandomState(12)
    for _ in range(25):
        _, js, *_ = jenv.step(js, jnp.asarray(rng.randint(0, 7, B)))
    d = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    ts = state_from_numpy(d)
    back = state_to_numpy(ts)
    for f in FIELDS:
        assert back[f].dtype == d[f].dtype, f
        np.testing.assert_array_equal(back[f], d[f], err_msg=f)
    for t in range(20):
        a = rng.randint(0, 7, B)
        jobs, js, jr, jd, _ = jenv.step(js, jnp.asarray(a))
        tobs, ts, tr, td, _ = tenv.step(ts, a)
        assert_bitwise(tobs, jobs, f"obs t={t}")
        assert_bitwise(tr, jr, f"reward t={t}")
        assert_state_equal(js, ts, f"t={t}")


def test_injected_reset_soft_reset_and_aux_match_jax():
    jenv, tenv = _pair(obs_type="ram", lock_delay=1)
    r = np.random.RandomState(0).randint(1, 36, B)
    jobs, js = jenv.reset(jax.random.PRNGKey(1), injected_r=jnp.asarray(r))
    tobs, ts = tenv.reset(1, injected_r=r)
    assert_bitwise(tobs, jobs)
    rng = np.random.RandomState(1)
    for t in range(15):
        a, r = rng.randint(0, 7, B), rng.randint(1, 36, B)
        jobs, js, *_ = jenv.step(js, jnp.asarray(a), jnp.asarray(r))
        tobs, ts, *_ = tenv.step(ts, a, injected_r=r)
        assert_bitwise(tobs, jobs, f"t={t}")
        assert_bitwise(tenv.render_rows(ts).view(torch.int32),
                       np.asarray(jenv.render_rows(js)).view(np.int32))
        assert_bitwise(tenv.valid_action_count(ts), jenv.valid_action_count(js))
    jobs, js = jenv.soft_reset(js)
    tobs, ts = tenv.soft_reset(ts)
    assert_bitwise(tobs, jobs)
    assert_state_equal(js, ts)


def _board_hash(board) -> str:
    bits = (np.asarray(board) != 0).astype(np.uint8)
    return hashlib.sha256(bits.tobytes()).hexdigest()[:16]


def _traces():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", _traces(), ids=lambda t: t["name"])
def test_golden_trace(trace):
    """The checked-in reference traces, replayed through the port's engine
    on two lanes (as tests/test_golden_traces.py replays the JAX engine)."""
    cfg = EnvConfig(width=trace["width"], height=trace["height"],
                    **trace["flags"])
    lanes = 2
    full = lambda v: torch.full((lanes,), v, dtype=torch.int32)
    resets = list(trace["resets"])
    s = init_state(cfg, lanes, 0, device="cpu")
    s, _ = E.engine_clear(cfg, s, injected_r=full(resets.pop(0)))
    for t, step in enumerate(trace["steps"]):
        r = step["r"] if step["r"] is not None else 0
        out = E.engine_step(cfg, s, full(step["action"]), injected_r=full(r))
        s = out.state
        boards = unpack_board(cfg, out.emitted_rows).numpy()
        assert (boards[0] == boards[1]).all()
        assert _board_hash(boards[0]) == step["board"], f"t={t}"
        assert float(out.reward[0]) == step["reward"], f"t={t}"
        assert bool(out.done[0]) == step["done"], f"t={t}"
        assert int(s.score[0]) == step["score"]
        assert int(s.lines_cleared[0]) == step["lines"]
        assert int(s.holes[0]) == step["holes"]
        assert int(s.deaths[0]) == step["deaths"]
        assert PIECE_NAMES[int(s.piece[0])] == step["piece"]
        if step["done"]:
            s, _ = E.engine_clear(cfg, s, injected_r=full(resets.pop(0)))
