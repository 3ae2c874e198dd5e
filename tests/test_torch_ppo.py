"""The port's PPO trainer against the JAX package's on the same init state,
the flax init parameters carried across with ``params_from_flax``.

- float32 (``ActorCritic`` swapped for a float32 one in both trainers):
  the collected actions, rewards and dones bitwise; after one update the
  env state bitwise, the metrics within 1e-4 and every parameter within
  1e-4 (measured: 7e-6; float sums run in another order in torch than in
  XLA, and Adam's first step divides by |g|, so a parameter moves by up to
  lr = 3e-4 on a gradient's rounding).
- bf16 (the defaults): the first update's trajectory bitwise, the loss
  metrics within 1e-4 (measured: 7e-6).
- run_ppo kill-and-resume: the same metric lines bitwise.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu.api.env import step_fn as jax_step_fn
from gym_simpletetris_tpu.models.actor_critic import ActorCritic as JaxAC
from gym_simpletetris_tpu.train import ppo as jax_ppo
from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.core.state import FIELDS, state_to_numpy
from gym_simpletetris_tpu_torch.models.actor_critic import (
    ActorCritic, params_from_flax)
from gym_simpletetris_tpu_torch.train import ppo
import port_harness  # noqa: F401 (torch on one CPU thread)

SMALL = dict(num_envs=16, rollout_len=16, num_minibatches=4, epochs=2)


def _pair(obs_type="ram", shuffle_block=1):
    kw = dict(obs_type=obs_type, auto_reset=True, reward_step=True,
              width=6, height=8)
    jcfg = jax_ppo.PPOConfig(env=JaxConfig(**kw), shuffle_block=shuffle_block,
                             **SMALL)
    tcfg = ppo.PPOConfig(env=EnvConfig(**kw), shuffle_block=shuffle_block,
                         **SMALL)
    return jcfg, tcfg


def _init_pair(jcfg, tcfg, seed=3):
    """Both trainers' init states; the port takes the flax parameters."""
    ji, ju, jnet = jax_ppo.make_ppo(jcfg)
    ti, tu, _ = ppo.make_ppo(tcfg, "cpu")
    js, ts = ji(jax.random.PRNGKey(seed)), ti(seed)
    ts.params = params_from_flax(jax.tree.map(np.asarray, js.params))
    return (ju, jnet, js), (tu, ts)


def _jax_trajectory(jcfg, jnet, js):
    """The collection loop of the JAX update, one jitted step at a time:
    (action, reward, done) per step."""
    keys = jax.random.split(jax.random.fold_in(js.key, js.update),
                            jcfg.rollout_len)
    apply = jax.jit(jnet.apply)
    step = jax.jit(lambda s, a: jax_step_fn(jcfg.env, s, a))
    obs, s, out = js.obs, js.env_state, []
    for k in keys:
        logits, _ = apply(js.params, obs)
        a = jax.random.categorical(k, logits).astype(jnp.int32)
        obs, s, r, d, _ = step(s, a)
        out.append((np.asarray(a), np.asarray(r), np.asarray(d)))
    return out


def _check_update(jcfg, jside, tside, metric_atol, param_atol):
    ju, jnet, js = jside
    tu, ts = tside
    want = _jax_trajectory(jcfg, jnet, js)
    env_state, obs, traj, _ = tu.collect(ts)
    for t, (a, r, d) in enumerate(want):
        np.testing.assert_array_equal(traj["action"][t].numpy(), a,
                                      err_msg=f"action at step {t}")
        np.testing.assert_array_equal(traj["done"][t].numpy(),
                                      d.astype(np.float32),
                                      err_msg=f"done at step {t}")
        # stored scaled in float32, as the JAX trainer stores it
        scaled = r * np.float32(jcfg.reward_scale)
        np.testing.assert_array_equal(traj["reward"][t].numpy().view(np.int32),
                                      scaled.view(np.int32),
                                      err_msg=f"reward at step {t}")

    js2, jm = jax.jit(ju)(js)
    ts2, tm = tu.learn(ts, (env_state, obs, traj, _))
    assert list(tm) == list(jm)
    je = {f: np.asarray(getattr(js2.env_state, f)) for f in FIELDS}
    te = state_to_numpy(ts2.env_state)
    for f in FIELDS:
        np.testing.assert_array_equal(te[f], je[f], err_msg=f"env_state.{f}")
    np.testing.assert_array_equal(ts2.obs.numpy(), np.asarray(js2.obs))
    for k in ("episodes_done", "lines_cleared"):
        assert float(tm[k]) == float(jm[k]), k
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=metric_atol, err_msg=k)
    assert int(ts2.update) == int(js2.update) == 1
    assert int(ts2.opt_state["count"]) == jcfg.epochs * jcfg.num_minibatches
    if param_atol is not None:
        jp = params_from_flax(jax.tree.map(np.asarray, js2.params))
        for k, v in jp.items():
            np.testing.assert_allclose(ts2.params[k].numpy(), v.numpy(),
                                       rtol=0, atol=param_atol, err_msg=k)
    return tm


@pytest.mark.parametrize("obs_type", ["ram", "grayscale"])
def test_update_f32_matches_jax(monkeypatch, obs_type):
    monkeypatch.setattr(jax_ppo, "ActorCritic",
                        functools.partial(JaxAC, dtype=jnp.float32))
    monkeypatch.setattr(ppo, "ActorCritic",
                        functools.partial(ActorCritic, dtype=torch.float32))
    jcfg, tcfg = _pair(obs_type)
    jside, tside = _init_pair(jcfg, tcfg)
    assert all(v.dtype == torch.float32 for v in tside[1].params.values())
    tm = _check_update(jcfg, jside, tside, metric_atol=1e-4, param_atol=1e-4)
    assert 0 < float(tm["entropy"]) <= np.log(7) + 1e-3


def test_update_bf16_block_shuffle_matches_jax():
    """The defaults (bf16) with shuffle_block = 8: the block permutation."""
    jcfg, tcfg = _pair("ram", shuffle_block=8)
    jside, tside = _init_pair(jcfg, tcfg, seed=5)
    _check_update(jcfg, jside, tside, metric_atol=1e-4, param_atol=None)


def test_ppo_learns_and_moves_params():
    cfg = ppo.PPOConfig(env=EnvConfig(obs_type="ram", auto_reset=True,
                                      reward_step=True, width=6, height=8),
                        shuffle_block=8, **SMALL)
    init_fn, update_fn, net = ppo.make_ppo(cfg, "cpu")
    s = init_fn(0)
    p0 = {k: v.clone() for k, v in s.params.items()}
    for _ in range(3):
        s, m = update_fn(s)
    assert int(s.update) == 3
    for k in ("pg_loss", "v_loss", "entropy", "clip_frac", "mean_reward"):
        assert np.isfinite(float(m[k])), k
    assert sum(float((s.params[k] - p0[k]).abs().sum()) for k in p0) > 0
    assert 0.0 < float(m["entropy"]) <= np.log(7) + 1e-3
    assert isinstance(net, ActorCritic)


def test_config_validation_and_auto_reset():
    with pytest.raises(ValueError):
        ppo.make_ppo(ppo.PPOConfig(env=EnvConfig(auto_reset=False)), "cpu")
    with pytest.raises(ValueError):
        ppo.PPOConfig(num_envs=16, rollout_len=16, shuffle_block=7)
    with pytest.raises(ValueError):
        # divides n but not the minibatch size
        ppo.PPOConfig(num_envs=16, rollout_len=16, num_minibatches=4,
                      shuffle_block=128)
    with pytest.raises(ValueError):
        ppo.PPOConfig(num_envs=10, rollout_len=3, num_minibatches=4)
    with pytest.raises(ValueError):
        # divides the minibatch size but not num_envs
        ppo.PPOConfig(num_envs=12, rollout_len=16, num_minibatches=3,
                      shuffle_block=8)
    with pytest.raises(ValueError, match="device"):
        ppo.make_ppo(ppo.PPOConfig(), "meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ppo.make_ppo(ppo.PPOConfig(), "cuda")


def test_optimizer_matches_optax():
    """clip_by_global_norm + adam over three steps on random gradients, with
    the norm above and below max_norm."""
    import optax
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    jp, jo = dict(params), tx.init(params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    to = {"count": torch.zeros((), dtype=torch.int32),
          "mu": {k: torch.zeros_like(v) for k, v in tp.items()},
          "nu": {k: torch.zeros_like(v) for k, v in tp.items()}}
    for scale in (10.0, 0.01, 3.0):
        g = {k: (rng.randn(*s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        ju, jo = tx.update(g, jo, jp)
        jp = optax.apply_updates(jp, ju)
        tg = ppo.clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, 0.5)
        tu, to = ppo.adam_update(tg, to, 3e-4)
        tp = {k: tp[k] + tu[k] for k in tp}
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-7, err_msg=k)
    assert int(to["count"]) == 3


def _read_jsonl(path):
    return [json.loads(l) for l in open(path)
            if l.strip() and "resumed_from" not in l]


def test_run_ppo_kill_and_resume_identical_metrics(tmp_path):
    from gym_simpletetris_tpu_torch.train.run_ppo import main
    args = ["--num-envs", "16", "--width", "6", "--height", "8",
            "--rollout-len", "8", "--minibatches", "2", "--epochs", "1",
            "--device", "cpu"]
    gold = tmp_path / "gold"
    gold.mkdir()
    main(args + ["--updates", "6", "--ckpt", str(gold / "c.pt"),
                 "--log-jsonl", str(gold / "log.jsonl")])
    golden = _read_jsonl(gold / "log.jsonl")

    part = tmp_path / "part"
    part.mkdir()
    main(args + ["--updates", "3", "--ckpt", str(part / "c.pt"),
                 "--ckpt-every", "2", "--log-jsonl", str(part / "log.jsonl")])
    main(args + ["--updates", "6", "--ckpt", str(part / "c.pt"), "--resume",
                 "--log-jsonl", str(part / "log.jsonl")])
    resumed = _read_jsonl(part / "log.jsonl")

    assert len(golden) == len(resumed) == 6
    for g, r in zip(golden, resumed):
        assert g["update"] == r["update"]
        assert set(g) == set(r)
        for k in g:
            if k not in ("wall_s", "sps"):
                assert g[k] == r[k], (k, g["update"])


def test_run_ppo_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is about hosts without it")
    from gym_simpletetris_tpu_torch.train.run_ppo import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--num-envs", "4", "--rollout-len", "2", "--minibatches", "1",
              "--updates", "1"])
