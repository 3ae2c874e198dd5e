"""The port's frame ring and obs ring (``train/replay.py``) and the DQN
trainer's ring branches (``train/dqn.py``, ``run_dqn --replay-layout``)
against a numpy reference and the JAX package.

- Ring contents: the transitions ``_frame_ring_batch`` rebuilds (stacks
  clamped at episode starts, n-step return, discount, done-any) against the
  numpy reference of ``tests/test_frame_ring.py``, both layouts, wrapped and
  not; the return within 1e-5 relative (the reference sums in float64).
- Against the JAX ring on the same inserts and keys: every ring field, and
  each of the four samplers' batches and indices, bitwise; PER and slot-PER
  weights bitwise on dyadic priorities and within 4 ulp on random ones
  (measured: 2; XLA sums the grid's total as one 2-D reduce, not emulated).
- ``frame_ring_stack_newest`` against the gather path and the JAX one.
- The trainer's actor stream: legacy, frame ring and obs ring bitwise in
  the port (grayscale), and each against the JAX trainer from the same
  state (ram boards, 4 stacked frames: the JAX compile of the grayscale
  trainer is what the first-learner-step tests pay for).
- The first learner step: ``test_torch_frame_ring_learner.py``.
- ``run_dqn`` on each layout, a killed and resumed frame-ring run bitwise,
  and a resume into another layout refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu.train import dqn as jax_dqn
from gym_simpletetris_tpu.train import replay as jr
from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.core.state import _key_tensor
from gym_simpletetris_tpu_torch.train import dqn
from gym_simpletetris_tpu_torch.train import replay as tr
from port_harness import assert_bitwise, assert_state_equal
from test_torch_dqn import _init_pair

RING = ("frame", "action", "reward", "done", "priority", "max_p", "ptr",
        "filled_slots")


def _script(T, B, F, seed=0, p_done=0.15):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, (T, B, F)).astype(np.uint8),
            rng.randint(0, 7, (T, B)).astype(np.int8),
            (rng.randn(T, B) * rng.choice([1.0, 30.0], (T, B)))
            .astype(np.float32),
            rng.rand(T, B) < p_done)


def _np_stack(frames, dones, t, b, k):
    """The reference stack ending at time t for env b: a position j back
    clamps to the episode's first frame."""
    out = np.empty(frames.shape[-1:] + (k,), frames.dtype)
    off, ok = 0, True
    for j in range(k):
        if j > 0:
            ok = ok and t - j >= 0 and not dones[t - j, b]
            if ok:
                off = j
        out[:, k - 1 - j] = frames[t - off, b]
    return out


def _fill(rows, actions, rewards, dones, S, k, n, gamma, stacked, jax_too):
    """The port's ring (and the JAX one) after inserting the script."""
    T, B, W = rows.shape
    F = W // k if stacked else W
    ts = tr.frame_ring_init(S * B, (F,), B, k, n, gamma, stacked,
                            device="cpu")
    js = jr.frame_ring_init(S * B, (F,), B, k, n, gamma, stacked) \
        if jax_too else None
    for t in range(T):
        ts = tr.frame_ring_insert_frame(ts, torch.from_numpy(rows[t]))
        ts = tr.frame_ring_insert_step(ts, torch.from_numpy(actions[t]),
                                       torch.from_numpy(rewards[t]),
                                       torch.from_numpy(dones[t]))
        if jax_too:
            js = jr.frame_ring_insert_frame(js, jnp.asarray(rows[t]))
            js = jr.frame_ring_insert_step(js, jnp.asarray(actions[t]),
                                           jnp.asarray(rewards[t]),
                                           jnp.asarray(dones[t]))
    return ts, js


@pytest.mark.parametrize("T,S,k,n,stacked", [
    (20, 32, 4, 3, False), (50, 16, 4, 3, False), (30, 16, 1, 1, False),
    (40, 16, 3, 2, False), (20, 32, 4, 3, True), (50, 16, 4, 2, True)])
def test_ring_contents_vs_numpy(T, S, k, n, stacked):
    """Every valid age's transition for every env: obs and next stacks, the
    action, the n-step return and discount, done-any."""
    B, F, gamma = 5, 12, 0.9
    frames, actions, rewards, dones = _script(T, B, F)
    stacks = np.stack([np.stack([_np_stack(frames, dones, t, b, k)
                                 for b in range(B)]) for t in range(T)])
    rows = stacks.reshape(T, B, -1) if stacked else frames
    ts, _ = _fill(rows, actions, rewards, dones, S, k, n, gamma, stacked,
                  False)
    assert int(ts.filled_slots) == min(T, S)
    valid = int(ts.valid_slots)
    assert valid == max(min(T, S) - (1 if stacked else k) - n + 1, 0) > 0
    ages = list(range(n, n + valid))
    slots = torch.tensor([(T - 1 - m) % S for m in ages], dtype=torch.int32)
    for b in range(B):
        env = torch.full((len(ages),), b, dtype=torch.int32)
        got = tr._frame_ring_batch(ts, slots, env)
        for i, m in enumerate(ages):
            t = T - 1 - m
            for key, tt in (("obs", t), ("next_obs", t + n)):
                want = stacks[tt, b]
                np.testing.assert_array_equal(
                    got[key][i].numpy().reshape(want.shape), want,
                    err_msg=f"{key} t={t} b={b}")
            assert int(got["action"][i]) == actions[t, b]
            ret, alive = 0.0, 1.0
            for j in range(n):
                ret += gamma ** j * alive * float(rewards[t + j, b])
                alive *= 1.0 - float(dones[t + j, b])
            np.testing.assert_allclose(float(got["reward"][i]), ret,
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(float(got["discount"][i]),
                                       gamma ** n * alive, rtol=1e-6)
            assert bool(got["done"][i]) == bool(dones[t:t + n, b].any())


def test_ring_init_and_insert_errors():
    with pytest.raises(ValueError, match="multiple"):
        tr.frame_ring_init(10, (3,), 4, device="cpu")
    with pytest.raises(ValueError, match="cannot serve"):
        tr.frame_ring_init(16, (3,), 4, frame_stack=2, n_step=2,
                           device="cpu")
    rs = tr.frame_ring_init(32, (3,), 4, device="cpu")
    assert bool(rs.done.all()) and int(rs.valid_slots) == 0
    with pytest.raises(ValueError, match="width"):
        tr.frame_ring_insert_frame(rs, torch.zeros(3, 3))
    rs = tr.frame_ring_init(64, (3,), 4, frame_stack=4, device="cpu")
    with pytest.raises(ValueError, match="slot-row"):
        tr.frame_ring_sample_slots(rs, _key_tensor(0, "cpu"), 8)


def _weights_equal(got, want, kind):
    if kind == "dyadic":
        assert_bitwise(got, want, "weights")
    else:
        ulp = np.abs(got.numpy().view(np.int32)
                     - np.asarray(want).view(np.int32))
        assert ulp.max() <= 4, ulp.max()


# (T, S, B, F, k, n, stacked): wrapped rings of both layouts, a single
# frame, and a ring wider than a window of XLA's sums
LAYOUTS = {"frame_k4n3": (50, 16, 5, 12, 4, 3, False),
           "frame_k1": (30, 16, 40, 12, 1, 1, False),
           "obs_k4n3": (50, 16, 5, 12, 4, 3, True),
           "obs_k3n5_wide": (60, 16, 40, 6, 3, 5, True)}


@pytest.mark.parametrize("kind", ["dyadic", "random"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ring_and_samplers_match_jax(layout, kind):
    T, S, B, F, k, n, stacked = LAYOUTS[layout]
    frames, actions, rewards, dones = _script(T, B, F * k if stacked else F,
                                              seed=1, p_done=0.2)
    ts, js = _fill(frames, actions, rewards, dones, S, k, n, 0.99, stacked,
                   True)
    for f in RING:
        assert_bitwise(getattr(ts, f), np.asarray(getattr(js, f)), f)
    rng = np.random.RandomState(2)
    if kind == "dyadic":
        p = rng.choice([0.25, 0.5, 1.0, 2.0, 4.0], (S, B)).astype(np.float32)
    else:
        p = (rng.rand(S, B) ** 3 * 5).astype(np.float32)
    js = js.replace(priority=jnp.asarray(p))
    ts.priority.copy_(torch.from_numpy(p))
    slots = stacked or k == 1
    for seed in (3, 4):
        jk, tk = jax.random.PRNGKey(seed), _key_tensor(seed, "cpu")
        jb = jax.jit(jr.frame_ring_sample, static_argnums=2)(js, jk, 64)
        _batch_equal(tr.frame_ring_sample(ts, tk, 64), jb)
        jb, jidx, jw = jax.jit(jr.frame_ring_sample_prioritized,
                               static_argnums=2)(js, jk, 64, 0.4)
        tb, tidx, tw = tr.frame_ring_sample_prioritized(ts, tk, 64, 0.4)
        _batch_equal(tb, jb)
        assert_bitwise(tidx, np.asarray(jidx), "PER indices")
        _weights_equal(tw, jw, kind)
        if not slots:
            continue
        jb, jslot = jax.jit(jr.frame_ring_sample_slots,
                            static_argnums=2)(js, jk, 2 * B)
        tb, tslot = tr.frame_ring_sample_slots(ts, tk, 2 * B)
        _batch_equal(tb, jb)
        assert_bitwise(tslot, np.asarray(jslot), "slots")
        jb, jslot, jw = jax.jit(jr.frame_ring_sample_slots_prioritized,
                                static_argnums=2)(js, jk, 2 * B, 0.7)
        tb, tslot, tw = tr.frame_ring_sample_slots_prioritized(ts, tk, 2 * B,
                                                               0.7)
        _batch_equal(tb, jb)
        assert_bitwise(tslot, np.asarray(jslot), "PER slots")
        _weights_equal(tw, jw, kind)
    # the priority write-backs, duck-typed on the frame ring
    td = rng.randn(2 * B).astype(np.float32)
    if slots:
        js = jax.jit(jr.replay_update_priority_slots)(
            js, jslot, jnp.asarray(td), 0.6, 1e-3)
        ts = tr.replay_update_priority_slots(ts, tslot, torch.from_numpy(td),
                                             0.6)
    td = rng.randn(64).astype(np.float32)
    js = jax.jit(jr.replay_update_priority)(js, jidx, jnp.asarray(td), 0.5,
                                            1e-2)
    ts = tr.replay_update_priority(ts, tidx, torch.from_numpy(td), 0.5, 1e-2)
    for f in ("priority", "max_p"):
        assert_bitwise(getattr(ts, f), np.asarray(getattr(js, f)), f)


def _batch_equal(tb, jb):
    assert set(tb) == set(jb)
    for key in jb:
        assert_bitwise(tb[key], np.asarray(jb[key]), key)


@pytest.mark.parametrize("seed,T,S", [(0, 25, 16), (1, 40, 16), (2, 9, 12)])
def test_stack_newest_equals_gather_path_and_jax(seed, T, S):
    B, F, k = 6, 8, 4
    frames, actions, rewards, dones = _script(T, B, F, seed=seed, p_done=0.3)
    ts, js = _fill(frames[:-1], actions[:-1], rewards[:-1], dones[:-1], S, k,
                   2, 0.99, False, True)
    ts = tr.frame_ring_insert_frame(ts, torch.from_numpy(frames[-1]))
    js = jr.frame_ring_insert_frame(js, jnp.asarray(frames[-1]))
    fast = tr.frame_ring_stack_newest(ts)
    slot = ts.ptr.expand(B).clone()
    np.testing.assert_array_equal(
        fast.numpy(), tr._ring_stack(ts, slot, torch.arange(B)).numpy())
    assert_bitwise(fast, np.asarray(jax.jit(jr.frame_ring_stack_newest)(js)),
                   "stack_newest")
    for b in range(B):
        np.testing.assert_array_equal(
            fast[b].numpy().reshape(F, k),
            _np_stack(frames, dones, T - 1, b, k))


# ---------------------------------------------------------------- trainer

LAYOUT_FLAGS = {"legacy": dict(), "frame-ring": dict(frame_ring=True),
                "obs-ring": dict(frame_ring=True, ring_stacks=True)}
STREAM_STEPS = 40


def _stream_cfgs(layout, obs_type):
    ekw = dict(obs_type=obs_type, auto_reset=True, width=6, height=8,
               reward_step=True)
    kw = dict(num_envs=8, buffer_capacity=512, learn_batch=16,
              learn_starts=10 ** 9, frame_stack=4, n_step=1,
              **LAYOUT_FLAGS[layout])
    return (jax_dqn.DQNConfig(env=JaxConfig(**ekw), **kw),
            dqn.DQNConfig(env=EnvConfig(**ekw), **kw))


def test_actor_stream_three_way():
    """Grayscale, 4 stacked frames, n_step 1, learning off: the three
    layouts give the same rewards and episode ends step by step (stacks
    rebuilt from the ring == stacks shifted == stacks stored whole)."""
    streams = []
    for layout in LAYOUT_FLAGS:
        _, tcfg = _stream_cfgs(layout, "grayscale")
        init_fn, step_fn, _, _ = dqn.make_train(tcfg, "cpu")
        s, rows = init_fn(11), []
        for _ in range(STREAM_STEPS):
            s, m = step_fn(s)
            rows.append((float(m["mean_reward"]), float(m["episodes_done"])))
        streams.append((rows, s.env_state.rows.clone()))
    for rows, env_rows in streams[1:]:
        assert rows == streams[0][0]
        assert torch.equal(env_rows, streams[0][1])
    assert sum(d for _, d in streams[0][0]) > 0       # episodes ended


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX trainer's actor-only runs of each layout on ram boards with
    4 stacked frames, from seed 11: the port's init state (the flax
    parameters carried across) and the JAX state and metrics after every
    step."""
    out = {}
    for layout in LAYOUT_FLAGS:
        jcfg, tcfg = _stream_cfgs(layout, "ram")
        jfns, js, _, ts = _init_pair(jcfg, tcfg, seed=11)
        step = jax.jit(jfns[1])
        states, metrics = [], []
        for _ in range(STREAM_STEPS):
            js, m = step(js)
            states.append(js)
            metrics.append({k: float(v) for k, v in m.items()})
        out[layout] = (ts, states, metrics)
    return out


@pytest.mark.parametrize("layout", list(LAYOUT_FLAGS))
def test_actor_stream_against_jax(jax_streams, layout):
    """Each layout's actor bitwise to the JAX trainer's from the same state:
    env, observation, key and metrics after every step, the ring at the
    end."""
    ts, jstates, jmetrics = jax_streams[layout]
    _, tcfg = _stream_cfgs(layout, "ram")
    _, step_fn, _, _ = dqn.make_train(tcfg, "cpu")
    for t in range(STREAM_STEPS):
        ts, m = step_fn(ts)
        js, msg = jstates[t], f"{layout} step {t}"
        assert_state_equal(js.env_state, ts.env_state, msg)
        assert_bitwise(ts.obs, np.asarray(js.obs), f"{msg} obs")
        assert_bitwise(ts.key, np.asarray(js.key).view(np.int32), msg)
        for k in ("mean_reward", "episodes_done", "lines_cleared"):
            assert float(m[k]) == jmetrics[t][k], (msg, k)
    fields = RING if layout != "legacy" else (
        "obs", "next_obs", "action", "reward", "done", "priority")
    for f in fields:
        assert_bitwise(getattr(ts.replay, f),
                       np.asarray(getattr(js.replay, f)), f"{layout} {f}")


def test_make_train_frame_ring_validation_and_gate():
    """Both frame-ring layouts build (with and without ring_stacks); the
    learner waits for a sampleable slot as well as learn_starts."""
    for stacks in (False, True):
        cfg = dqn.DQNConfig(
            env=EnvConfig(auto_reset=True, reward_step=True, width=6,
                          height=8),
            num_envs=4, buffer_capacity=64, learn_batch=8, learn_starts=4,
            frame_stack=2, n_step=3, frame_ring=True, ring_stacks=stacks)
        init_fn, step_fn, chunk_fn, _ = dqn.make_train(cfg, "cpu")
        s = init_fn(0)
        assert isinstance(s.replay, tr.FrameRingState) and s.window is None
        assert s.obs.dtype == torch.uint8
        assert s.obs.shape == ((4, 6, 8, 2) if stacks else (4, 6, 8))
        history = 1 if stacks else 2
        for t in range(history + 2):
            s, m = step_fn(s)
            assert int(s.learn_steps) == 0, t   # valid_slots still 0
        s, m = step_fn(s)
        assert int(s.learn_steps) == 1 and float(m["loss"]) > 0
        s, m = chunk_fn(s, 4)
        assert int(s.learn_steps) == 5


def _read_jsonl(path):
    return [json.loads(ln) for ln in open(path)
            if ln.strip() and "resumed_from" not in ln]


@pytest.mark.parametrize("layout", ["frame-ring", "obs-ring"])
def test_run_dqn_layout_kill_and_resume_identical(tmp_path, layout):
    """A frame-ring / obs-ring run checkpointed and resumed gives the same
    metric lines bitwise; a resume into another layout is refused."""
    from gym_simpletetris_tpu_torch.train.run_dqn import main

    def args(tmp, total, every):
        return ["--num-envs", "4", "--width", "6", "--height", "8",
                "--buffer", "64", "--learn-batch", "8", "--learn-starts",
                "12", "--chunk", "8", "--total-steps", str(total),
                "--frame-stack", "2", "--n-step", "2", "--prioritized",
                "--replay-layout", layout, "--ckpt", str(tmp / "ckpt.pt"),
                "--ckpt-every", str(every), "--log-jsonl",
                str(tmp / "log.jsonl"), "--device", "cpu"]

    gold, part = tmp_path / "gold", tmp_path / "part"
    gold.mkdir()
    part.mkdir()
    main(args(gold, 24, 1 << 30))
    main(args(part, 8, 8))
    state = main(args(part, 24, 8) + ["--resume"])
    assert isinstance(state.replay, tr.FrameRingState)
    assert state.replay.stacked == (layout == "obs-ring")
    golden, resumed = _read_jsonl(gold / "log.jsonl"), _read_jsonl(
        part / "log.jsonl")
    assert len(golden) == len(resumed) == 3
    for g, r in zip(golden, resumed):
        for k in g:
            if k not in ("wall_s", "sps"):
                assert g[k] == r[k], (k, g["actor_steps"])
    assert golden[-1]["loss"] > 0
    other = [a if a != layout else "legacy" for a in args(part, 32, 8)]
    with pytest.raises(SystemExit, match=f"holds a '{layout}'"):
        main(other + ["--resume"])
