"""Process worlds for the port's multi-process tests: ``run_world(n, job,
tmp)`` starts n OS processes of this file, joined over gloo on the CPU
through a file store, each running ``job`` (a function of this module) on
its rank and writing what it returns (a dict of numpy arrays) to an
``.npz``; the parent gets the n dicts in rank order. Each world has its own
timeout, so a hung rendezvous fails one test instead of stalling the suite.

The jobs use the port alone (no jax): the tests hold their outputs against
the JAX package in the parent process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120


def run_world(n: int, job: str, tmp, timeout: float = WORLD_TIMEOUT,
              **kwargs) -> list:
    """Run ``job(**kwargs)`` on every rank of an n-process gloo world;
    returns each rank's dict of arrays."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"store_{job}_{n}")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    args = json.dumps(kwargs)
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(n), store, tmp, args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {job} exited {p.returncode}:"
                                 f"\n{log[-6000:]}")
    out = []
    for r in range(n):
        with np.load(os.path.join(tmp, f"{job}_{n}_rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _np(x):
    import torch
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.numpy() if x.dtype != torch.bfloat16 else x.float().numpy()
    return np.asarray(x)


# ----------------------------------------------------------------- the jobs

ENV_CASES = (("ram", dict(obs_type="ram")),
             ("gray", dict(obs_type="grayscale")),
             ("wide", dict(obs_type="ram", width=32)))
ENV_B = 8          # per rank
ENV_STEPS = 32
ENV_T = 16


def env_job(mesh_device="cpu", bench=False):
    """ShardedTetrisEnv on each case: reset, 32 steps, a 16-step rollout
    with auto_reset, global_metrics; then shard_map_step (and with
    ``bench`` the two benchmarks). Every output is the rank's block."""
    import torch
    from gym_simpletetris_tpu_torch import EnvConfig
    from gym_simpletetris_tpu_torch.core import engine as E
    from gym_simpletetris_tpu_torch.core.state import (init_state,
                                                       state_to_numpy)
    from gym_simpletetris_tpu_torch.parallel import mesh as M
    import torch.distributed as dist
    mesh = M.make_data_mesh(mesh_device)
    n = dist.get_world_size()
    B = ENV_B * n
    out = {}
    for name, kw in ENV_CASES:
        cfg = EnvConfig(auto_reset=True, reward_step=True, **kw)
        env = M.ShardedTetrisEnv(cfg, B, mesh)
        rng = np.random.RandomState(0)
        obs, s = env.reset(3)
        out[f"{name}/reset_obs"] = _np(obs)
        steps = {"obs": [], "reward": [], "done": []}
        infos = {}
        for _ in range(ENV_STEPS):
            obs, s, r, d, info = env.step(s, rng.randint(0, 7, B))
            for k, v in (("obs", obs), ("reward", r), ("done", d)):
                steps[k].append(_np(v))
            for k, v in info.items():
                infos.setdefault(k, []).append(_np(v))
        for k, v in list(steps.items()) + [(f"info.{k}", v)
                                           for k, v in infos.items()]:
            out[f"{name}/{k}"] = np.stack(v)
        for f, v in state_to_numpy(s).items():
            out[f"{name}/state.{f}"] = v
        final, acc, rew, don = env.rollout(s, rng.randint(0, 7, (ENV_T, B)))
        out[f"{name}/acc"] = _np(acc)
        out[f"{name}/roll_reward"] = _np(rew)
        out[f"{name}/roll_done"] = _np(don)
        for f, v in state_to_numpy(final).items():
            out[f"{name}/final.{f}"] = v
        for k, v in M.global_metrics(final, mesh).items():
            out[f"{name}/metric.{k}"] = _np(v)
    # shard_map_step on a small board (deaths come quickly)
    cfg = EnvConfig(auto_reset=True, width=4, height=5)
    st = init_state(cfg, B, 4, device=mesh_device)
    st, _ = E.engine_clear(cfg, st)
    st = M.shard_state(st, mesh)
    step = M.shard_map_step(cfg, mesh)
    rec = {"obs": [], "reward": [], "done": [], "finished": [], "piece": []}
    for _ in range(30):
        obs, st, r, d, fin = step(st, torch.full((ENV_B,), 2))
        for k, v in zip(rec, (obs, r, d, fin, st.piece)):
            rec[k].append(_np(v))
    for k, v in rec.items():
        out[f"smap/{k}"] = np.stack(v)
    for f, v in state_to_numpy(st).items():
        out[f"smap/state.{f}"] = v
    g = M.gather_state(st, mesh)
    out["smap/gathered_rows"] = state_to_numpy(g)["rows"]
    try:
        M.ShardedTetrisEnv(cfg, B + 1, mesh)
        out["indivisible_refused"] = np.array(False)
    except ValueError:
        out["indivisible_refused"] = np.array(True)
    if bench:
        out.update(bench_job())
    return out


def bench_job():
    """collective_bench (0.5 MB, 2 iters) and a tiny scaling_bench, env
    and actor-learner."""
    from gym_simpletetris_tpu_torch.core.config import EnvConfig
    from gym_simpletetris_tpu_torch.parallel import (collective_bench,
                                                     scaling_bench)
    from gym_simpletetris_tpu_torch.parallel.mesh import make_data_mesh
    mesh = make_data_mesh("cpu")
    cb = collective_bench.bench_collectives(mesh, mb=0.5, iters=2)
    sb = scaling_bench.main(["--per-device", "8", "--steps", "4", "--chunk",
                             "2", "--device", "cpu"])
    tb = scaling_bench.main(["--per-device", "8", "--steps", "4", "--chunk",
                             "2", "--device", "cpu", "--train"])
    return {"collective": np.array(json.dumps(cb)),
            "scaling": np.array(json.dumps(sb)),
            "train": np.array(json.dumps(tb))}


# the trainers' configurations: the JAX package's own mesh tests'
DQN_KW = dict(num_envs=16, buffer_capacity=256, learn_batch=16,
              learn_starts=32, target_update_period=5)         # test_sharding
DQN_STEPS = 40
PPO_KW = dict(num_envs=16, rollout_len=8, num_minibatches=2, epochs=1)
PPO_UPDATES = 5
# a shuffle block of every env of a step: each block straddles the ranks
PPO_BLOCK_KW = dict(PPO_KW, shuffle_block=16)
PPO_BLOCK_UPDATES = 2
ES_KW = dict(pop_size=8, envs_per_member=2, horizon=32, hidden=(16,))
RING_KW = dict(num_envs=16, buffer_capacity=512, learn_batch=16,
               learn_starts=32, frame_stack=4, n_step=2, dueling=True,
               noisy=True, frame_ring=True, ring_stacks=True)  # test_frame_ring
RING_STEPS = 16
CKPT_KW = dict(num_envs=16, buffer_capacity=256, learn_batch=16,
               learn_starts=16, target_update_period=5, prioritized=True,
               n_step=2, dueling=True, noisy=True)  # test_checkpoint_topology
CKPT_STEPS, CKPT_MORE = 24, 5


def env_cfg(obs_type="ram"):
    from gym_simpletetris_tpu_torch import EnvConfig
    return EnvConfig(obs_type=obs_type, auto_reset=True, reward_step=True,
                     width=6, height=8)


def load_params(path) -> dict:
    import torch
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def with_params(state, sd):
    """A trainer state carrying the parameters ``sd`` (fresh Adam state)."""
    import torch
    zeros = lambda: {k: torch.zeros_like(v) for k, v in sd.items()}
    kw = dict(params=sd, opt_state=dict(state.opt_state, mu=zeros(),
                                        nu=zeros()))
    if hasattr(state, "target_params"):
        kw["target_params"] = dict(sd)
    import dataclasses
    return dataclasses.replace(state, **kw)


def dqn_run(mesh, dqn_params=None):
    """DQN_KW from seed 7 (the given parameters) for DQN_STEPS steps:
    (state, metrics by step, the parameters after the first learner
    step)."""
    from gym_simpletetris_tpu_torch.train import dqn
    cfg = dqn.DQNConfig(env=env_cfg(), **DQN_KW)
    init_fn, step_fn, _, _ = dqn.make_train(cfg, "cpu", mesh=mesh)
    s = init_fn(7)
    if dqn_params:
        s = with_params(s, load_params(dqn_params))
    ms, first = [], None
    for _ in range(DQN_STEPS):
        s, m = step_fn(s)
        ms.append(m)
        if first is None and int(s.learn_steps) == 1:
            first = dict(s.params)
    return s, {k: np.stack([_np(m[k]) for m in ms]) for k in ms[0]}, first


def ppo_run(mesh, ppo_params=None, kw=PPO_KW, updates=PPO_UPDATES):
    """``kw`` from seed 9 (the given parameters) for ``updates`` updates:
    (state, metrics by update, the parameters after the first)."""
    from gym_simpletetris_tpu_torch.train import ppo
    cfg = ppo.PPOConfig(env=env_cfg(), **kw)
    init_fn, update_fn, _ = ppo.make_ppo(cfg, "cpu", mesh=mesh)
    s = init_fn(9)
    if ppo_params:
        s = with_params(s, load_params(ppo_params))
    ms, first = [], None
    for _ in range(updates):
        s, m = update_fn(s)
        ms.append(m)
        first = first or dict(s.params)
    return s, {k: np.stack([_np(m[k]) for m in ms]) for k in ms[0]}, first


def es_run(mesh, es_theta=None):
    import torch
    from gym_simpletetris_tpu_torch.train import es
    cfg = es.ESConfig(env=env_cfg(), **ES_KW)
    init_fn, gen_fn, _ = es.make_es(cfg, "cpu", mesh=mesh)
    s = init_fn(5)
    if es_theta:
        s = s.replace(theta=torch.from_numpy(np.load(es_theta)))
    return gen_fn(s)


def ring_run(mesh):
    from gym_simpletetris_tpu_torch.train import dqn
    cfg = dqn.DQNConfig(env=env_cfg("grayscale"), **RING_KW)
    init_fn, _, chunk_fn, _ = dqn.make_train(cfg, "cpu", mesh=mesh)
    return chunk_fn(init_fn(2), RING_STEPS)


def ckpt_run(mesh, path, path0):
    """CKPT_KW from seed 3: its init state saved to ``path0``; CKPT_STEPS
    steps, saved to ``path``; then (the state and metrics after CKPT_MORE
    more steps, the same from the state restored from the file)."""
    from gym_simpletetris_tpu_torch.train import dqn
    from gym_simpletetris_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)
    cfg = dqn.DQNConfig(env=env_cfg(), **CKPT_KW)
    init_fn, step_fn, chunk_fn, _ = dqn.make_train(cfg, "cpu", mesh=mesh)
    s = init_fn(3)
    save_checkpoint(path0, s, mesh=mesh)
    s, _ = chunk_fn(s, CKPT_STEPS)
    save_checkpoint(path, s, mesh=mesh)
    return (continue_run(step_fn, s),
            continue_run(step_fn, restore_checkpoint(path, "cpu", mesh=mesh)))


def continue_run(step_fn, s, steps=CKPT_MORE):
    """``steps`` train steps: (state, each metric stacked over the steps)."""
    ms = []
    for _ in range(steps):
        s, m = step_fn(s)
        ms.append(m)
    return s, {k: np.stack([_np(m[k]) for m in ms]) for k in ms[0]}


def record(prefix, state, metrics=None, first=None) -> dict:
    """The arrays of a trainer state (its tensors by path), metrics and the
    parameters after the first update."""
    from gym_simpletetris_tpu_torch.train.sharding import leaves
    out = {f"{prefix}/{'.'.join(map(str, p))}": _np(x)
           for p, x in leaves(state)}
    for k, v in (metrics or {}).items():
        out[f"{prefix}/metric.{k}"] = _np(v)
    for k, v in (first or {}).items():
        out[f"{prefix}/first.{k}"] = _np(v)
    return out


def train_job(dqn_params, ppo_params, es_theta):
    """The three trainers on the world's mesh."""
    from gym_simpletetris_tpu_torch.parallel.mesh import make_data_mesh
    mesh = make_data_mesh("cpu")
    out = {}
    out.update(record("dqn", *dqn_run(mesh, dqn_params)))
    out.update(record("ppo", *ppo_run(mesh, ppo_params)))
    out.update(record("ppo_block", *ppo_run(mesh, None, PPO_BLOCK_KW,
                                            PPO_BLOCK_UPDATES)))
    out.update(record("es", *es_run(mesh, es_theta)))
    return out


# ------------------------------------------------- tensor parallelism (15b)

TP_DQN_KW = dict(DQN_KW, prioritized=True, dueling=True)
TP_PLAIN_STEPS = 3     # DQN_KW's first learner step is its second step
# the obs ring with a noisy C51 head whose widths (4, 28) divide the model
# axis: every layer of the network is split, a NoisyDense among them
TP_RING_KW = dict(RING_KW, distributional=True, num_atoms=4)
_RING_FIELDS = ("obs", "next_obs", "action", "reward", "discount", "done",
                "priority")


def mesh_2d(data: int, model: int):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))


def own_params(state, sd, mesh):
    """``with_params`` on a sharded state: the whole parameters ``sd`` cut
    to the rank's blocks (through a gather and a shard of the state)."""
    from gym_simpletetris_tpu_torch.train.sharding import (
        gather_train_state, shard_train_state)
    if mesh is None:
        return with_params(state, sd)
    return shard_train_state(with_params(gather_train_state(state, mesh), sd),
                             mesh)


def tp_dqn_run(mesh, dqn_params, kw=TP_DQN_KW, steps=DQN_STEPS):
    """``kw`` from seed 7 and the given parameters, ``steps`` steps:
    (state, metrics by step, the parameters after the first learner step,
    {the env rows and the ring's fields by step}, the init state's leaf
    shapes)."""
    from gym_simpletetris_tpu_torch.train import dqn
    cfg = dqn.DQNConfig(env=env_cfg(), **kw)
    init_fn, step_fn, _, _ = dqn.make_train(cfg, "cpu", mesh=mesh)
    s = init_fn(7)
    shapes = {k: np.array(v.shape) for k, v in record("", s).items()}
    s = own_params(s, load_params(dqn_params), mesh)
    ms, first, trace = [], None, {}
    for _ in range(steps):
        s, m = step_fn(s)
        ms.append(m)
        if first is None and int(s.learn_steps) == 1:
            first = dict(s.params)
        # copies: the ring is written in place
        for f in _RING_FIELDS:
            trace.setdefault(f"replay.{f}", []).append(
                _np(getattr(s.replay, f)).copy())
        trace.setdefault("rows", []).append(_np(s.env_state.rows).copy())
    return (s, {k: np.stack([_np(m[k]) for m in ms]) for k in ms[0]}, first,
            {k: np.stack(v) for k, v in trace.items()}, shapes)


def tp_ppo_run(mesh, ppo_params):
    """PPO_KW from seed 9 and the given parameters, PPO_UPDATES updates:
    (state, metrics by update, the parameters after the first, {the env
    rows by update}, the init state's leaf shapes)."""
    from gym_simpletetris_tpu_torch.train import ppo
    cfg = ppo.PPOConfig(env=env_cfg(), **PPO_KW)
    init_fn, update_fn, _ = ppo.make_ppo(cfg, "cpu", mesh=mesh)
    s = init_fn(9)
    shapes = {k: np.array(v.shape) for k, v in record("", s).items()}
    s = own_params(s, load_params(ppo_params), mesh)
    ms, first, rows = [], None, []
    for _ in range(PPO_UPDATES):
        s, m = update_fn(s)
        ms.append(m)
        first = first or dict(s.params)
        rows.append(_np(s.env_state.rows).copy())
    return (s, {k: np.stack([_np(m[k]) for m in ms]) for k in ms[0]}, first,
            {"rows": np.stack(rows)}, shapes)


def record_tp(prefix, state, metrics, first, trace, shapes) -> dict:
    out = record(prefix, state, metrics, first)
    out.update({f"{prefix}/trace.{k}": v for k, v in trace.items()})
    out.update({f"{prefix}/shape{k}": v for k, v in shapes.items()})
    return out


def tp_job(dqn_params, plain_params, ppo_params, es_theta):
    """The three trainers on a (data, model) = (world / 2, 2) mesh; DQN
    also on DQN_KW to its first learner step, from ``plain_params``."""
    import torch.distributed as dist
    mesh = mesh_2d(dist.get_world_size() // 2, 2)
    out = record_tp("dqn", *tp_dqn_run(mesh, dqn_params))
    out.update(record_tp("dqn_plain", *tp_dqn_run(
        mesh, plain_params, DQN_KW, TP_PLAIN_STEPS)))
    out.update(record_tp("ppo", *tp_ppo_run(mesh, ppo_params)))
    out.update(record("es", *es_run(mesh, es_theta)))
    return out


def noisy_weights(network, params, key_seed=5) -> dict:
    """Each NoisyDense's (weight, bias) under the noise of one key, from
    ``params`` (the rank's blocks under a split network)."""
    import copy
    from gym_simpletetris_tpu_torch.core.state import _key_tensor
    from gym_simpletetris_tpu_torch.models.dqn import NoisyDense
    key = _key_tensor(key_seed, "cpu")
    out = {}
    for name, m in network.named_modules():
        if isinstance(m, NoisyDense):
            layer = copy.copy(m)         # the copy's own parameters
            layer._parameters = {leaf: params[f"{name}.{leaf}"] for leaf in (
                "weight_mu", "weight_sigma", "bias_mu", "bias_sigma")}
            w, b = layer.noisy_weights(key)
            out[f"{name}.weight"], out[f"{name}.bias"] = _np(w), _np(b)
    return out


def tp_ring_run(mesh):
    """The obs-ring Rainbow of TP_RING_KW from seed 2, RING_STEPS steps:
    (state, metrics) and the NoisyDense weights of its final parameters."""
    from gym_simpletetris_tpu_torch.train import dqn
    cfg = dqn.DQNConfig(env=env_cfg("grayscale"), **TP_RING_KW)
    init_fn, _, chunk_fn, network = dqn.make_train(cfg, "cpu", mesh=mesh)
    s, m = chunk_fn(init_fn(2), RING_STEPS)
    return (s, m), noisy_weights(network, s.params)


def tp_ckpt_job(path, path0):
    """At (data, model) = (1, 2): the obs-ring Rainbow and the noisy
    weights; checkpoints saved at (1, 2) (``ckpt_run``), and the later one
    restored at (2, 1) and continued. The continued states are recorded
    whole (gathered)."""
    from gym_simpletetris_tpu_torch.train import dqn
    from gym_simpletetris_tpu_torch.train.sharding import gather_train_state
    from gym_simpletetris_tpu_torch.utils.checkpoint import restore_checkpoint
    mesh = mesh_2d(1, 2)
    ring, noisy = tp_ring_run(mesh)
    out = record("ring", *ring)
    out.update({f"noisy/{k}": v for k, v in noisy.items()})
    cont, restored = ckpt_run(mesh, path, path0)
    mesh21 = mesh_2d(2, 1)
    cfg = dqn.DQNConfig(env=env_cfg(), **CKPT_KW)
    _, step_fn, _, _ = dqn.make_train(cfg, "cpu", mesh=mesh21)
    restored21 = continue_run(step_fn, restore_checkpoint(path, "cpu",
                                                          mesh=mesh21))
    for name, (s, m), at in (("cont", cont, mesh),
                             ("restored", restored, mesh),
                             ("restored21", restored21, mesh21)):
        out.update(record(name, gather_train_state(s, at), m))
    return out


def ring_ckpt_job(path, path0):
    """The obs-ring Rainbow, and checkpoints saved at this world's size."""
    from gym_simpletetris_tpu_torch.parallel.mesh import make_data_mesh
    mesh = make_data_mesh("cpu")
    out = record("ring", *ring_run(mesh))
    cont, restored = ckpt_run(mesh, path, path0)
    out.update(record("cont", *cont))
    out.update(record("restored", *restored))
    return out


JOBS = {"env_job": env_job, "bench_job": bench_job, "train_job": train_job,
        "ring_ckpt_job": ring_ckpt_job, "tp_job": tp_job,
        "tp_ckpt_job": tp_ckpt_job}


def _worker(job, rank, n, store, outdir, kwargs):
    import torch
    torch.set_num_threads(1)
    from gym_simpletetris_tpu_torch.parallel.mesh import (init_distributed,
                                                          shutdown)
    init_distributed(f"file://{store}", n, rank, backend="gloo")
    try:
        out = JOBS[job](**kwargs)
    finally:
        shutdown()
    np.savez(os.path.join(outdir, f"{job}_{n}_rank{rank}.npz"), **out)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5], json.loads(sys.argv[6]))
