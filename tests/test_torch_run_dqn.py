"""``run_dqn`` and the dqn policy of ``evaluate`` in the port: a killed and
resumed run gives the same metric lines, a CUDA request without a card
raises, and the greedy policy's actions are the JAX package's bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu import TetrisVectorEnv as JaxEnv
from gym_simpletetris_tpu.train import dqn as jax_dqn
from gym_simpletetris_tpu.train import evaluate as jax_eval
from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.train import evaluate
import port_harness  # noqa: F401 (torch on one CPU thread)


def _read_jsonl(path):
    return [json.loads(l) for l in open(path)
            if l.strip() and "resumed_from" not in l]


@pytest.mark.parametrize("extra", [(), ("--prioritized", "--n-step", "2")],
                         ids=["plain", "per_nstep"])
def test_run_dqn_kill_and_resume_identical_metrics(tmp_path, extra):
    """The twin of tests/test_resume.py's DQN case: a run checkpointed
    and resumed gives the same metric lines, bitwise."""
    from gym_simpletetris_tpu_torch.train.run_dqn import main

    def args(tmp, total, every):
        return ["--num-envs", "4", "--width", "6", "--height", "8",
                "--buffer", "64", "--learn-batch", "8", "--learn-starts",
                "12", "--chunk", "8", "--total-steps", str(total),
                "--ckpt", str(tmp / "ckpt.pt"), "--ckpt-every", str(every),
                "--log-jsonl", str(tmp / "log.jsonl"), "--device",
                "cpu"] + list(extra)

    gold = tmp_path / "gold"
    gold.mkdir()
    main(args(gold, 24, 1 << 30))
    golden = _read_jsonl(gold / "log.jsonl")
    part = tmp_path / "part"
    part.mkdir()
    main(args(part, 8, 8))
    main(args(part, 24, 8) + ["--resume"])
    resumed = _read_jsonl(part / "log.jsonl")
    assert len(golden) == len(resumed) == 3
    for g, r in zip(golden, resumed):
        assert set(g) == set(r)
        for k in g:
            if k not in ("wall_s", "sps"):
                assert g[k] == r[k], (k, g["actor_steps"])
    assert golden[-1]["loss"] > 0


def test_run_dqn_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is about hosts without it")
    from gym_simpletetris_tpu_torch.train.run_dqn import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--num-envs", "4", "--buffer", "16", "--total-steps", "1"])


@pytest.mark.parametrize("atoms,noisy", [(51, False), (0, True)],
                         ids=["c51", "noisy"])
def test_dqn_policy_matches_jax(tmp_path, atoms, noisy):
    """The dqn policy of ``evaluate`` on an ``.npz`` of flax Q-network
    parameters: greedy actions bitwise against the JAX
    ``make_action_fn("dqn")`` on the same parameters as an orbax checkpoint,
    over 200 steps at B = 32 (C51 over the atom index; a noisy net
    mu-only)."""
    b, steps = 32, 200
    kw = dict(obs_type="ram", auto_reset=True, reward_step=True)
    jcfg, tcfg = JaxConfig(**kw), EnvConfig(**kw)
    net = jax_dqn.build_q_network("ram", (10, 20), num_atoms=atoms,
                                  noisy=noisy)
    params = net.init(jax.random.PRNGKey(4), jnp.zeros((1, 10, 20)))
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat["/".join(path)] = np.asarray(node)

    walk(jax.tree.map(np.asarray, params), ())
    npz = tmp_path / "q.npz"
    np.savez(npz, **flat)
    # the same parameters as an orbax checkpoint for the JAX policy
    from gym_simpletetris_tpu.utils.checkpoint import save_checkpoint
    ckpt = save_checkpoint(str(tmp_path / "q_orbax"), {"params": params})
    jact = jax_eval.make_action_fn("dqn", jcfg, b, ckpt, atoms=atoms,
                                   noisy=noisy)
    tfn = evaluate.make_action_fn("dqn", tcfg, b, str(npz), device="cpu",
                                  atoms=atoms, noisy=noisy)
    jenv, tenv = JaxEnv(jcfg, b), TetrisVectorEnv(tcfg, b, device="cpu")
    (jo, js), (to, ts) = jenv.reset(jax.random.PRNGKey(0)), tenv.reset(0)
    for t in range(steps):
        ja, ta = jact(jo, js), tfn(to, ts)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      err_msg=f"action at step {t}")
        jo, js, *_ = jenv.step(js, ja)
        to, ts, *_ = tenv.step(ts, ta)


def test_dqn_policy_from_a_trainer_checkpoint(tmp_path):
    """A ``run_dqn --ckpt`` file serves as a dqn checkpoint (a dueling head
    read from its parameter names), and ``evaluate.main`` runs it."""
    from gym_simpletetris_tpu_torch.train.run_dqn import main
    path = tmp_path / "dqn.pt"
    state = main(["--num-envs", "8", "--width", "6", "--height", "8",
                  "--buffer", "64", "--learn-batch", "8", "--learn-starts",
                  "16", "--chunk", "4", "--total-steps", "8", "--dueling",
                  "--ckpt", str(path), "--device", "cpu"])
    cfg = EnvConfig(width=6, height=8, auto_reset=True, reward_step=True)
    fn = evaluate.make_action_fn("dqn", cfg, 8, str(path), device="cpu")
    from gym_simpletetris_tpu_torch.models.dqn import build_q_network
    net = build_q_network("ram", (6, 8), dueling=True)
    net.load_state_dict(state.params)
    with torch.no_grad():
        want = net(state.obs).argmax(-1)
    np.testing.assert_array_equal(fn(state.obs, None).numpy(), want.numpy())
    res = evaluate.main(["--policies", "dqn", "--ckpt", str(path),
                         "--num-envs", "8", "--steps", "20", "--width", "6",
                         "--height", "8", "--device", "cpu"])
    assert res["dqn"]["total_deaths"] == res["dqn"]["episodes"]
    with pytest.raises(ValueError, match="ckpt"):
        evaluate.make_action_fn("dqn", cfg, 8, device="cpu")
