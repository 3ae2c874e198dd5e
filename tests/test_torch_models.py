"""The port's models and wrappers against the JAX package on the same inputs:
the actor-critic forward with flax parameters carried across
(``params_from_flax``), the one-step-lookahead heuristic, FrameStack and
EpisodeStats.

Tolerances, and why:

- ram MLP, bf16: bitwise on boards from play (the greedy line-clear agent's
  own boards). On random dense boards an element may sit one bf16 ulp away:
  the float32 sum inside each bf16 product runs in another order in torch's
  sgemm than in XLA's dot, and a tie in the rounding goes the other way
  (about 1 logit in 7,000 at 40% fill).
- float32 (MLP and conv): relative 1e-5 of the row's largest |logit|, for
  the same summation order (measured up to 1e-6).
- conv, bf16: one bf16 ulp of the row's largest |logit| (2**-7 relative);
  the greedy actions are equal wherever the top-2 margin exceeds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu import TetrisVectorEnv as JaxEnv
from gym_simpletetris_tpu.api import wrappers as jax_wrappers
from gym_simpletetris_tpu.models import heuristic as jax_heuristic
from gym_simpletetris_tpu.models.actor_critic import ActorCritic as JaxAC
from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.api import wrappers
from gym_simpletetris_tpu_torch.models import heuristic
from gym_simpletetris_tpu_torch.models.actor_critic import (
    ActorCritic, params_from_flax)
from gym_simpletetris_tpu_torch.utils.checkpoint import load_flax_params

NPZ = "artifacts/ppo_lineclear_params.npz"
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _flax_init(obs_type, shape, jdt, seed):
    net = JaxAC(obs_type=obs_type, dtype=jdt)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + shape))
    return net, jax.tree.map(np.asarray, params)


def _port(obs_type, shape, tdt, params):
    net = ActorCritic(shape, obs_type=obs_type, dtype=tdt)
    net.load_state_dict(params_from_flax(params))
    return net


def _forward(net, x):
    with torch.no_grad():
        logits, value = net(torch.from_numpy(x))
    return logits.numpy(), value.numpy()


def _play_boards():
    """4096 ram boards from 32 steps of the greedy line-clear agent in the
    JAX env at B = 128 (seed 0), and the checkpoint's flax params."""
    tree = {"params": {}}
    with np.load(NPZ) as z:
        for name in z.files:
            node = tree
            for m in name.split("/")[:-1]:
                node = node.setdefault(m, {})
            node[name.split("/")[-1]] = z[name]
    net = JaxAC(obs_type="ram")
    apply = jax.jit(net.apply)
    env = JaxEnv(JaxConfig(obs_type="ram", auto_reset=True,
                           reward_step=True), 128)
    obs, s = env.reset(jax.random.PRNGKey(0))
    boards = []
    for _ in range(32):
        boards.append(np.asarray(obs))
        a = jnp.argmax(apply(tree, obs)[0], -1)
        obs, s, *_ = env.step(s, a.astype(jnp.int32))
    return np.concatenate(boards), tree


def test_ram_forward_bitwise_on_play_boards():
    """The checkpoint's bf16 MLP: logits and value bitwise equal to the
    jitted flax forward on boards the agent meets."""
    x, tree = _play_boards()
    lj, vj = jax.jit(JaxAC(obs_type="ram").apply)(tree, jnp.asarray(x))
    net = ActorCritic((10, 20), obs_type="ram")
    net.load_state_dict(load_flax_params(NPZ))
    lt, vt = _forward(net, x)
    np.testing.assert_array_equal(_bits(lt), _bits(lj))
    np.testing.assert_array_equal(_bits(vt), _bits(vj))


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_ram_forward_random_boards(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(0)
    x = (rng.rand(4096, 10, 20) < 0.4).astype(np.float32)
    jnet, params = _flax_init("ram", (10, 20), jdt, 3)
    lj, vj = (np.asarray(a) for a in jax.jit(jnet.apply)(params, jnp.asarray(x)))
    lt, vt = _forward(_port("ram", (10, 20), tdt, params), x)
    assert lt.dtype == vt.dtype == np.float32
    assert lt.shape == (4096, 7) and vt.shape == (4096,)
    rel = 2.0 ** -7 if dt == "bf16" else 1e-5
    scale = np.abs(lj).max(axis=1, keepdims=True)
    assert (np.abs(lt - lj) <= rel * scale).all()
    assert (np.abs(vt - vj) <= rel * np.abs(vj).max()).all()
    if dt == "bf16":
        # all but a rounding tie here and there are bitwise
        assert (_bits(lt) != _bits(lj)).mean() < 1e-3


@pytest.mark.parametrize("obs_type,shape", [("grayscale", (84, 84)),
                                            ("rgb", (84, 84, 3))])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_conv_forward(obs_type, shape, dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(5)
    x = rng.choice([0.0, 128.0, 190.0], size=(48,) + shape).astype(np.float32)
    jnet, params = _flax_init(obs_type, shape, jdt, 5)
    lj, vj = (np.asarray(a) for a in jax.jit(jnet.apply)(params, jnp.asarray(x)))
    lt, vt = _forward(_port(obs_type, shape, tdt, params), x)
    rel = 2.0 ** -7 if dt == "bf16" else 1e-5
    tol = rel * np.abs(lj).max(axis=1)
    assert (np.abs(lt - lj) <= tol[:, None]).all()
    assert (np.abs(vt - vj) <= rel * np.abs(vj).max()).all()
    top2 = np.sort(lj, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.sum() > len(x) // 2
    np.testing.assert_array_equal(lt.argmax(1)[clear], lj.argmax(1)[clear])


def test_params_from_flax_layouts():
    """Dense kernels transpose, conv kernels go HWIO -> OIHW, the trunk is
    renamed, and the outer "params" key is optional."""
    _, params = _flax_init("grayscale", (84, 84), jnp.bfloat16, 1)
    sd = params_from_flax(params)
    assert sd.keys() == params_from_flax(params["params"]).keys()
    p = params["params"]
    np.testing.assert_array_equal(sd["trunk.conv1.weight"].numpy(),
                                  p["ConvTrunk_0"]["conv1"]["kernel"]
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  p["fc"]["kernel"].T)
    net = ActorCritic((84, 84), obs_type="grayscale")
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_fresh_init_follows_flax_defaults():
    """LeCun-normal (truncated) kernels, zero biases, the flax shapes."""
    _, params = _flax_init("ram", (10, 20), jnp.bfloat16, 0)
    want = params_from_flax(params)
    net = ActorCritic((10, 20), obs_type="ram")
    net.reset_parameters(torch.Generator().manual_seed(0))
    for k, v in net.state_dict().items():
        assert v.shape == want[k].shape and v.dtype == torch.float32, k
        if k.endswith("bias"):
            assert not v.any(), k
        else:
            std = (1.0 / v.shape[1]) ** 0.5
            assert abs(float(v.std()) / std - 1) < 0.1, k
            assert float(v.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-6


def _run_heuristic(env, es, policy, steps, seed, record):
    obs, st = es.reset(seed)
    for _ in range(steps):
        a = policy(st.env_state)
        obs, st, r, d, _ = es.step(st, a)
        record.append((np.asarray(a), np.asarray(r), np.asarray(d)))
    return st


@pytest.mark.parametrize("kw,b", [
    (dict(), 24),
    (dict(width=8, height=10, penalise_holes=True, lock_delay=1), 16)],
    ids=["10x20", "8x10"])
def test_heuristic_matches_jax(kw, b):
    """200 steps of the lookahead policy in the env: actions, rewards,
    dones and every EpisodeStats field bitwise."""
    kw = dict(kw, auto_reset=True, reward_step=True)
    jenv = JaxEnv(JaxConfig(**kw), b)
    tenv = TetrisVectorEnv(EnvConfig(**kw), b, device="cpu")
    jrec, trec = [], []
    jst = _run_heuristic(jenv, jax_wrappers.EpisodeStats(jenv),
                         jax_heuristic.make_heuristic_policy(jenv.config),
                         200, jax.random.PRNGKey(4), jrec)
    tst = _run_heuristic(tenv, wrappers.EpisodeStats(tenv),
                         heuristic.make_heuristic_policy(tenv.config),
                         200, 4, trec)
    for t, (j, p) in enumerate(zip(jrec, trec)):
        for name, x, y in zip(("action", "reward", "done"), j, p):
            np.testing.assert_array_equal(
                y.view(np.int32) if y.dtype == np.float32 else y,
                x.view(np.int32) if x.dtype == np.float32 else x,
                err_msg=f"{name} at step {t}")
    for f in ("ep_return", "ep_length", "last_return", "last_length",
              "episodes", "ep_lines", "last_lines", "total_lines"):
        a, w = getattr(tst, f).numpy(), np.asarray(getattr(jst, f))
        assert a.dtype == w.dtype, f
        np.testing.assert_array_equal(a.view(np.int32), w.view(np.int32),
                                      err_msg=f)
    assert int(tst.total_lines.sum()) + int(tst.episodes.sum()) > 0


def test_heuristic_wide_board_matches_jax_parts():
    """A 32-column board ([H, NW, B] rows). The JAX policy reads its batch
    size from ``rows.shape[1]``, the word axis there, and raises; the port's
    policy is held bitwise to the same lookahead built from the JAX parts
    (``_tile_state``, ``engine_step``, ``board_score``) for 100 steps."""
    from gym_simpletetris_tpu.core import engine as jax_engine
    kw = dict(width=32, height=10, auto_reset=True, reward_step=True)
    b = 8
    jenv = JaxEnv(JaxConfig(**kw), b)
    tenv = TetrisVectorEnv(EnvConfig(**kw), b, device="cpu")
    jcfg, w = jenv.config, jax_heuristic.HeuristicWeights()

    @jax.jit
    def jax_policy(s):
        out = jax_engine.engine_step(
            jcfg, jax_heuristic._tile_state(s, 7),
            jnp.repeat(jnp.arange(7, dtype=jnp.int32), b))
        score = jax_heuristic.board_score(jcfg, out.state, out.reward,
                                          out.done, w)
        return jnp.argmin(score.reshape(7, b), axis=0).astype(jnp.int32)

    policy = heuristic.make_heuristic_policy(tenv.config)
    _, js = jenv.reset(jax.random.PRNGKey(6))
    _, ts = tenv.reset(6)
    assert ts.rows.dim() == 3
    for t in range(100):
        ja, ta = jax_policy(js), policy(ts)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      err_msg=f"action at step {t}")
        _, js, jr, jd, _ = jenv.step(js, ja)
        _, ts, tr, td, _ = tenv.step(ts, ta)
        np.testing.assert_array_equal(_bits(tr.numpy()), _bits(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_heuristic_tile_and_scores_match_jax():
    """The pieces under the policy on one mid-game state: the 7x tiled
    state, column heights and board scores."""
    cfg_kw = dict(width=9, height=12, auto_reset=True)
    jenv = JaxEnv(JaxConfig(**cfg_kw), 6)
    tenv = TetrisVectorEnv(EnvConfig(**cfg_kw), 6, device="cpu")
    rng = np.random.RandomState(2)
    _, js = jenv.reset(jax.random.PRNGKey(1))
    _, ts = tenv.reset(1)
    for _ in range(30):
        a = rng.randint(0, 7, 6)
        _, js, *_ = jenv.step(js, jnp.asarray(a, jnp.int32))
        _, ts, *_ = tenv.step(ts, a)
    jt = jax_heuristic._tile_state(js, 7)
    tt = heuristic._tile_state(ts, 7)
    np.testing.assert_array_equal(tt.rows.numpy().view(np.uint32),
                                  np.asarray(jt.rows))
    np.testing.assert_array_equal(tt.shape_counts.numpy(),
                                  np.asarray(jt.shape_counts))
    np.testing.assert_array_equal(
        heuristic._column_heights(tenv.config, tt.rows).numpy(),
        np.asarray(jax_heuristic._column_heights(jenv.config, jt.rows)))
    w = heuristic.HeuristicWeights(holes=3.0, bumpiness=0.5)
    reward = rng.choice([1.0, -100.0, 101.0], 42).astype(np.float32)
    done = rng.rand(42) < 0.2
    got = heuristic.board_score(tenv.config, tt, torch.from_numpy(reward),
                                torch.from_numpy(done), w)
    want = jax_heuristic.board_score(
        jenv.config, jt, jnp.asarray(reward), jnp.asarray(done),
        jax_heuristic.HeuristicWeights(holes=3.0, bumpiness=0.5))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("obs_type", ["ram", "grayscale"])
def test_frame_stack_matches_jax(obs_type):
    kw = dict(obs_type=obs_type, auto_reset=True, width=6, height=8)
    jfs = jax_wrappers.FrameStack(JaxEnv(JaxConfig(**kw), 4), k=3)
    tfs = wrappers.FrameStack(
        TetrisVectorEnv(EnvConfig(**kw), 4, device="cpu"), k=3)
    jf, js = jfs.reset(jax.random.PRNGKey(2))
    tf, ts = tfs.reset(2)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    rng = np.random.RandomState(0)
    n_done = 0
    for _ in range(40):
        a = rng.randint(0, 7, 4)
        jf, js, _, jd, _ = jfs.step(js, jnp.asarray(a, jnp.int32))
        tf, ts, _, td, _ = tfs.step(ts, a)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        n_done += int(td.sum())
    assert n_done > 0 and tf.shape[-1] == 3


def test_episode_stats_requires_auto_reset():
    with pytest.raises(ValueError, match="auto_reset"):
        wrappers.EpisodeStats(TetrisVectorEnv(EnvConfig(), 2, device="cpu"))
