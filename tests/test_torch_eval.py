"""Greedy evaluation of the line-clear PPO checkpoint in the port against the
JAX package's ``evaluate_policy`` on the CPU, and the evaluation CLI.

``artifacts/ppo_lineclear_params.npz`` is the orbax checkpoint
``artifacts/ppo_lineclear_ckpt`` as numpy (keys: flax paths joined by "/");
the first test keeps its provenance checked.
"""

import json

import jax
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu import TetrisVectorEnv as JaxEnv
from gym_simpletetris_tpu.api import wrappers as jax_wrappers
from gym_simpletetris_tpu.train import evaluate as jax_eval
from gym_simpletetris_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.train import evaluate
from gym_simpletetris_tpu_torch.utils.checkpoint import load_flax_params

CKPT = "artifacts/ppo_lineclear_ckpt"
NPZ = "artifacts/ppo_lineclear_params.npz"


def test_npz_equals_orbax_checkpoint():
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat["/".join(path)] = np.asarray(node)

    walk(jax_restore(CKPT), ())
    with np.load(NPZ) as z:
        assert sorted(z.files) == sorted(flat)
        for k, v in flat.items():
            assert z[k].dtype == v.dtype == np.float32, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_greedy_eval_matches_jax(monkeypatch):
    """B = 128 for 1000 steps from seed 0: the greedy actions equal the JAX
    policy's step for step, every EpisodeStats field ends bitwise equal,
    and so do the summary dicts of both ``evaluate_policy``s."""
    b, steps = 128, 1000
    kw = dict(obs_type="ram", auto_reset=True, reward_step=True)
    jcfg, tcfg = JaxConfig(**kw), EnvConfig(**kw)
    jenv = JaxEnv(jcfg, b)
    jfn = jax_eval.make_action_fn("ppo", jcfg, b, CKPT)
    tfn = evaluate.make_action_fn("ppo", tcfg, b, NPZ, device="cpu")
    want = jax_eval.evaluate_policy(jenv, jfn, steps, 0)

    # the JAX loop of evaluate_policy again, keeping actions and the state
    jes = jax_wrappers.EpisodeStats(jenv)
    obs, jst = jes.reset(jax.random.PRNGKey(0))
    jstep = jax.jit(jes.step)
    jacts = []
    for _ in range(steps):
        a = jfn(obs, jst.env_state)
        jacts.append(np.asarray(a))
        obs, jst, *_ = jstep(jst, a)

    # the port's evaluate_policy, its EpisodeStats spied on
    final, tacts = {}, []

    class Spy(evaluate.EpisodeStats):
        def step(self, es, action):
            out = super().step(es, action)
            final["port"] = out[1]
            return out

    monkeypatch.setattr(evaluate, "EpisodeStats", Spy)

    def trec(obs, st):
        a = tfn(obs, st)
        assert a.dtype == torch.int32
        tacts.append(a.numpy())
        return a

    got = evaluate.evaluate_policy(TetrisVectorEnv(tcfg, b, device="cpu"),
                                   trec, steps, 0)
    diff = np.argwhere(np.stack(jacts) != np.stack(tacts))
    assert not len(diff), f"first differing (step, env): {diff[0]}"
    for f in ("ep_return", "ep_length", "last_return", "last_length",
              "episodes", "ep_lines", "last_lines", "total_lines"):
        a = getattr(final["port"], f).numpy()
        w = np.asarray(getattr(jst, f))
        assert a.dtype == w.dtype, f
        np.testing.assert_array_equal(a.view(np.int32), w.view(np.int32),
                                      err_msg=f)
    assert got == want
    assert got["episodes"] > 0 and got["lines_per_episode"] > 3.0


def test_ppo_policy_from_a_trainer_checkpoint(tmp_path):
    """A ``run_ppo --ckpt`` file serves as a ppo checkpoint too."""
    from gym_simpletetris_tpu_torch.train.run_ppo import main
    path = tmp_path / "ppo.pt"
    state = main(["--num-envs", "8", "--width", "6", "--height", "8",
                  "--rollout-len", "4", "--minibatches", "2", "--epochs", "1",
                  "--updates", "1", "--ckpt", str(path), "--device", "cpu"])
    cfg = EnvConfig(width=6, height=8, auto_reset=True, reward_step=True)
    fn = evaluate.make_action_fn("ppo", cfg, 8, str(path), device="cpu")
    obs = state.obs
    a = fn(obs, None)
    from gym_simpletetris_tpu_torch.models.actor_critic import ActorCritic
    net = ActorCritic((6, 8))
    net.load_state_dict(state.params)
    with torch.no_grad():
        want = net(obs)[0].argmax(-1)
    np.testing.assert_array_equal(a.numpy(), want.numpy())


def test_action_fns_and_errors():
    cfg = EnvConfig(auto_reset=True)
    env = TetrisVectorEnv(cfg, 4, device="cpu")
    obs, st = env.reset(0)
    a = evaluate.make_action_fn("random", cfg, 4, seed=3,
                                device="cpu")(obs, st)
    np.testing.assert_array_equal(a.numpy(),
                                  np.random.RandomState(3).randint(0, 7, 4))
    with pytest.raises(ValueError, match="ckpt"):
        evaluate.make_action_fn("ppo", cfg, 4, device="cpu")
    for name, item in (("es", "item 12"), ("dqn", "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            evaluate.make_action_fn(name, cfg, 4, ckpt="x", device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        evaluate.make_action_fn("nope", cfg, 4, device="cpu")


def test_main_cpu_and_cuda_request(capsys):
    res = evaluate.main(["--policies", "random", "heuristic", "--num-envs",
                         "8", "--steps", "40", "--width", "6", "--height",
                         "8", "--device", "cpu"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [list(l) for l in lines] == [["random"], ["heuristic"]]
    assert res["random"] == lines[0]["random"]
    for r in res.values():
        assert r["episodes"] >= 0 and r["total_deaths"] == r["episodes"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            evaluate.main(["--policies", "random", "--steps", "1"])


def test_load_flax_params_layout():
    sd = load_flax_params(NPZ)
    assert sorted(sd) == sorted([
        "trunk.dense0.weight", "trunk.dense0.bias", "trunk.dense1.weight",
        "trunk.dense1.bias", "pi.weight", "pi.bias", "v.weight", "v.bias"])
    with np.load(NPZ) as z:
        for name, key in (("trunk.dense0", "MlpTrunk_0/dense0"),
                          ("pi", "pi"), ("v", "v")):
            np.testing.assert_array_equal(
                sd[name + ".weight"].numpy(), z[f"params/{key}/kernel"].T)
            np.testing.assert_array_equal(
                sd[name + ".bias"].numpy(), z[f"params/{key}/bias"])
