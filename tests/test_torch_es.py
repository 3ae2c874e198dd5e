"""The port's ES trainer (``train/es.py``, ``run_es``, the es policy of
``evaluate``) against the JAX package's.

- ``centered_ranks`` bitwise against the jitted JAX function (ties broken
  by position) and a numpy stable argsort.
- theta's ``ravel`` / ``unravel`` against ``ravel_pytree`` of real flax
  parameters (RamDQN, a RamDQN of 11 layers whose module names sort
  ``dense10`` before ``dense2``, NatureDQN): bitwise both ways.
- ``es_update`` bitwise against the jitted JAX function for both fitness
  shapings (its dot and reductions follow XLA's CPU order).
- The members' vmapped forward equals each member's unbatched forward.
- One generation against ``make_es`` from a carried theta and key (ram:
  pop 8 x 2, horizon 16, hidden (64, 64); grayscale NatureDQN: pop 2 x 1,
  horizon 3): eps bitwise, the fitness metrics bitwise, the new theta within
  1e-6 (measured: bitwise for grayscale, 3e-8 for ram, where XLA fuses the
  update's dot with a recomputation of the draws; not emulated).
- ``ESConfig``'s validation, ``run_es`` and ``evaluate --policies es``, the
  checkpoint round trip, and the es policy's greedy actions bitwise against
  the JAX policy's on the same theta.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu import TetrisVectorEnv as JaxEnv
from gym_simpletetris_tpu.models import dqn as jax_models
from gym_simpletetris_tpu.train import es as jes
from gym_simpletetris_tpu.train import evaluate as jax_eval
from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.core import threefry
from gym_simpletetris_tpu_torch.train import es, evaluate
from gym_simpletetris_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                         save_checkpoint)
from port_harness import assert_bitwise, flax_to_state_dict

EKW = dict(auto_reset=True, reward_step=True, penalise_holes=True, width=6,
           height=8)


@pytest.mark.parametrize("n", [2, 5, 8, 16, 256, 1001])
def test_centered_ranks_bitwise(n):
    rng = np.random.RandomState(n)
    for f in ((rng.randn(n) * 10).astype(np.float32),
              rng.choice([0.0, 1.0, -3.5, 2.25], n).astype(np.float32)):
        got = es.centered_ranks(torch.from_numpy(f))
        assert_bitwise(got, np.asarray(jax.jit(jes.centered_ranks)(f)), n)
        ranks = np.argsort(np.argsort(f, kind="stable"), kind="stable")
        np.testing.assert_allclose(got.numpy(), ranks / (n - 1) - 0.5,
                                   rtol=0, atol=1e-6)


def _flax_params(obs_type, hidden=None):
    """(flax params, the port's ESConfig-free network) of an ES policy."""
    if obs_type == "ram":
        net = jax_models.RamDQN(hidden=hidden)
        shape = (6, 8)
    else:
        net = jax_models.build_q_network(obs_type, None)
        shape = (84, 84)
    params = net.init(jax.random.PRNGKey(1), jnp.zeros((1,) + shape))
    cfg = es.ESConfig(env=EnvConfig(obs_type=obs_type, **EKW),
                      hidden=hidden or (64, 64))
    return params, cfg


@pytest.mark.parametrize("obs_type,hidden", [
    ("ram", (64, 64)), ("ram", (4,) * 11), ("grayscale", None)],
    ids=["ram", "ram_11_layers", "grayscale"])
def test_ravel_unravel_match_ravel_pytree(obs_type, hidden):
    params, cfg = _flax_params(obs_type, hidden)
    theta = np.array(ravel_pytree(params)[0])
    net, ravel, unravel, _, dim = es._build_policy(cfg)
    assert dim == theta.size
    want = flax_to_state_dict(params)
    got = unravel(torch.from_numpy(theta))
    assert set(got) == set(want) == set(net.state_dict())
    for k in want:
        assert_bitwise(got[k], want[k].numpy(), k)
    assert_bitwise(ravel(want), theta, "ravel")
    assert_bitwise(ravel(es.greedy_params(cfg, theta)), theta, "greedy")
    # leading axes: one set of parameters per member
    two = unravel(torch.from_numpy(np.stack([theta, -theta])))
    for k in want:
        assert torch.equal(two[k][0], got[k]) and torch.equal(two[k][1],
                                                              -got[k])


@pytest.mark.parametrize("pop,dim", [(16, 37), (256, 3000)])
def test_es_update_bitwise(pop, dim):
    rng = np.random.RandomState(pop)
    theta = rng.randn(dim).astype(np.float32)
    half = rng.randn(pop // 2, dim).astype(np.float32)
    eps = np.concatenate([half, -half])
    fitness = np.round(rng.randn(pop) * 20).astype(np.float32)   # ties
    for shaping in (True, False):
        kw = dict(sigma=0.05, lr=0.02, weight_decay=0.005,
                  rank_shaping=shaping)
        jt, jg = jax.jit(lambda t, e, f: jes.es_update(t, e, f, **kw))(
            theta, eps, fitness)
        tt, tg = es.es_update(torch.from_numpy(theta), torch.from_numpy(eps),
                              torch.from_numpy(fitness), **kw)
        assert_bitwise(tg, np.asarray(jg), f"grad {shaping}")
        assert_bitwise(tt, np.asarray(jt), f"theta {shaping}")


def test_member_forward_equals_unbatched():
    """The vmapped forward of pop members on their envs' boards: each
    member's Q-values bitwise equal to its own unbatched RamDQN forward."""
    cfg = es.ESConfig(env=EnvConfig(obs_type="ram", **EKW), pop_size=6,
                      envs_per_member=5)
    _, gen_fn, net = es.make_es(cfg, "cpu")
    rng = np.random.RandomState(0)
    members = torch.from_numpy(
        (rng.randn(6, gen_fn.ravel(net.state_dict()).numel()) * 0.2)
        .astype(np.float32))
    env = TetrisVectorEnv(cfg.env, 30, device="cpu")
    obs, st = env.reset(0)
    for _ in range(20):
        obs, st, *_ = env.step(st, torch.from_numpy(rng.randint(0, 7, 30)))
    params = gen_fn.unravel(members)
    with torch.no_grad():
        got = gen_fn.member_forward(params, obs.reshape(6, 5, 6, 8))
        for i in range(6):
            net.load_state_dict({k: v[i] for k, v in params.items()})
            assert_bitwise(got[i], net(obs[5 * i:5 * i + 5]).numpy(), i)


GENS = {"ram": dict(pop_size=8, envs_per_member=2, horizon=16,
                    hidden=(64, 64)),
        "grayscale": dict(pop_size=2, envs_per_member=1, horizon=3)}


@pytest.fixture(scope="module")
def jax_generations():
    """One JAX generation per observation type from PRNGKey(3)'s init."""
    out = {}
    for obs_type, kw in GENS.items():
        cfg = jes.ESConfig(env=JaxConfig(obs_type=obs_type, **EKW), **kw)
        init_fn, gen_fn, _ = jes.make_es(cfg)
        s0 = init_fn(jax.random.PRNGKey(3))
        s1, m = jax.jit(gen_fn)(s0)
        out[obs_type] = (s0, s1, {k: np.asarray(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("obs_type", list(GENS))
def test_one_generation_against_make_es(jax_generations, obs_type):
    s0, s1, jm = jax_generations[obs_type]
    cfg = es.ESConfig(env=EnvConfig(obs_type=obs_type, **EKW),
                      **GENS[obs_type])
    _, gen_fn, _ = es.make_es(cfg, "cpu")
    key = torch.from_numpy(np.asarray(s0.key).view(np.int32).copy())
    state = es.ESState(theta=torch.from_numpy(np.asarray(s0.theta).copy()),
                       key=key, generation=torch.zeros((), dtype=torch.int32))
    # the perturbations: jax.random.normal's bit for bit
    dim = state.theta.numel()
    k_eps = threefry.split(key, 3)[0]
    jk_eps = jax.random.split(s0.key, 3)[0]
    shape = (cfg.pop_size // 2, dim)
    assert_bitwise(threefry.normal(k_eps, shape),
                   np.asarray(jax.jit(jax.random.normal, static_argnums=1)(
                       jk_eps, shape)), "eps")
    new, m = gen_fn(state)
    assert int(new.generation) == 1
    assert_bitwise(new.key, np.asarray(s1.key).view(np.int32), "key")
    for k in ("fitness_mean", "fitness_max", "fitness_std"):
        assert_bitwise(m[k], jm[k], k)
    for k in ("theta_norm", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    np.testing.assert_allclose(new.theta.numpy(), np.asarray(s1.theta),
                               rtol=0, atol=1e-6)


def test_config_validation_and_default_device():
    with pytest.raises(ValueError, match="even"):
        es.ESConfig(pop_size=7)
    with pytest.raises(ValueError, match="auto_reset"):
        es.ESConfig(env=EnvConfig(obs_type="ram"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            es.make_es(es.ESConfig())
        with pytest.raises(RuntimeError, match="cuda"):
            es.train(es.ESConfig(pop_size=2, envs_per_member=1), 1)


def test_run_es_ckpt_and_evaluate_es(tmp_path):
    """run_es writes its JSONL lines and an ESState; the checkpoint round
    trip is exact; evaluate --policies es plays it greedily."""
    from gym_simpletetris_tpu_torch.train import run_es
    ck, log = str(tmp_path / "es.pt"), str(tmp_path / "es.jsonl")
    state = run_es.main(["--width", "6", "--height", "8", "--pop", "8",
                         "--envs-per-member", "2", "--horizon", "16",
                         "--generations", "2", "--hidden", "16", "--ckpt",
                         ck, "--log-jsonl", log, "--device", "cpu"])
    lines = [json.loads(ln) for ln in open(log)]
    assert [ln["generation"] for ln in lines] == [1, 2]
    assert set(lines[0]) == {"fitness_mean", "fitness_max", "fitness_std",
                             "theta_norm", "grad_norm", "generation",
                             "env_steps"}
    assert lines[1]["env_steps"] == 2 * 8 * 2 * 16
    back = restore_checkpoint(ck, device="cpu")
    assert isinstance(back, es.ESState) and int(back.generation) == 2
    for f in ("theta", "key", "generation"):
        assert torch.equal(getattr(back, f), getattr(state, f)), f
    cfg = EnvConfig(width=6, height=8, auto_reset=True, reward_step=True)
    fn = evaluate.make_action_fn("es", cfg, 8, ck, device="cpu",
                                 es_hidden=(16,))
    env = TetrisVectorEnv(cfg, 8, device="cpu")
    obs, st = env.reset(0)
    net = es._build_policy(es.ESConfig(env=cfg, hidden=(16,)))[0]
    net.load_state_dict(es.greedy_params(es.ESConfig(env=cfg, hidden=(16,)),
                                         state.theta))
    with torch.no_grad():
        want = net(obs).argmax(-1)
    np.testing.assert_array_equal(fn(obs, st).numpy(), want.numpy())
    res = evaluate.main(["--policies", "es", "--ckpt", ck, "--es-hidden",
                         "16", "--num-envs", "8", "--steps", "40", "--width",
                         "6", "--height", "8", "--device", "cpu"])
    assert res["es"]["total_deaths"] == res["es"]["episodes"] >= 0


def test_es_policy_matches_jax(tmp_path):
    """The es policy on one theta: the port's (an ESState file) and the JAX
    package's (an orbax checkpoint) take the same greedy actions for 120
    steps at B = 16 on the 10 x 20 board."""
    b, steps = 16, 120
    kw = dict(obs_type="ram", auto_reset=True, reward_step=True)
    jcfg, tcfg = JaxConfig(**kw), EnvConfig(**kw)
    init_fn = jes.make_es(jes.ESConfig(env=jcfg))[0]
    js = init_fn(jax.random.PRNGKey(5))
    # a theta with nonzero biases, as training gives: with the fresh init's
    # zero biases XLA folds the head's bias add away, and with it the bf16
    # rounding of its product (ROADMAP Queue 3)
    rng = np.random.RandomState(5)
    js = js.replace(theta=js.theta + jnp.asarray(
        0.05 * rng.randn(js.theta.size), jnp.float32))
    from gym_simpletetris_tpu.utils.checkpoint import \
        save_checkpoint as jax_save
    jck = jax_save(str(tmp_path / "es_orbax"), js)
    tck = save_checkpoint(str(tmp_path / "es.pt"), es.ESState(
        theta=torch.from_numpy(np.asarray(js.theta).copy()),
        key=torch.zeros(2, dtype=torch.int32),
        generation=torch.zeros((), dtype=torch.int32)))
    jact = jax_eval.make_action_fn("es", jcfg, b, jck)
    tact = evaluate.make_action_fn("es", tcfg, b, tck, device="cpu")
    jenv, tenv = JaxEnv(jcfg, b), TetrisVectorEnv(tcfg, b, device="cpu")
    (jo, jst), (to, tst) = jenv.reset(jax.random.PRNGKey(0)), tenv.reset(0)
    for t in range(steps):
        ja, ta = jact(jo, jst), tact(to, tst)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      err_msg=f"action at step {t}")
        jo, jst, *_ = jenv.step(jst, ja)
        to, tst, *_ = tenv.step(tst, ta)
