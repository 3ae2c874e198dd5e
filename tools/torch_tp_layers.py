#!/usr/bin/env python3
"""Which layer of a network split over the ``model`` axis sums in another
order than the whole layer, on one CUDA card.

    python3 tools/torch_tp_layers.py

Two ranks at (data, model) = (1, 2) over gloo on cuda:0 (spawned) build
the networks of ``chip_smoke.py`` phase 10a (the 7f RamDQN, the obs-ring
Rainbow 7i, the PPO actor-critic) split over the model axis, run the
forward on their init parameters (7i also after its 32-step run at the
(1, 2) mesh) at the actor's batch and at the learner's (8192 rows for the
MLPs, 1024 for 7i; 7i also with a noise key), and record each top-level
layer's output. This process runs the whole layers on the same (gathered)
parameters and inputs and prints, per network and batch, each layer as
``=`` (bitwise) or ``DIFF <largest difference> <share of its outputs>``.
Deterministic algorithms are on in both. Imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_STEPS = 32


def _networks(mesh):
    """(name, network, init_fn, whether to train it first) of phase 10a."""
    import chip_smoke as C
    from gym_simpletetris_tpu_torch.train import dqn, ppo
    legacy, rainbow = C._p9_dqn_configs()
    out = []
    for name, cfg in (("7f", legacy), ("7i", rainbow)):
        init_fn, _, _, net = dqn.make_train(cfg, "cuda", mesh=mesh)
        out.append((name, net, init_fn))
    init_fn, _, net = ppo.make_ppo(ppo.PPOConfig(), "cuda", mesh=mesh)
    return out + [("ppo", net, init_fn)]


def _cases(name, state):
    """{case: (input, noise key)} of a network at its actor's and learner's
    batches."""
    import torch
    from gym_simpletetris_tpu_torch.core.state import _key_tensor
    if name == "7i":
        big, key = state.obs.repeat(4, 1, 1, 1), _key_tensor(11, "cuda")
        return {"actor": (state.obs, None), "learner": (big, None),
                "actor noisy": (state.obs, key), "learner noisy": (big, key)}
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 2, (8192, 10, 20), device="cuda",
                      generator=g).float()
    return {"actor": (x[:1024], None), "learner": (x, None)}


def _forward(net, params, x, key, ppo):
    """Each top-level layer's output, as numpy by name."""
    import torch
    from torch.func import functional_call
    out = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: out.__setitem__(n, (
            o[0] if isinstance(o, tuple) else o).float().cpu().numpy()))
        for n, m in net.named_children()]
    try:
        with torch.no_grad():
            functional_call(net, params, (x,) if ppo else (x, key))
    finally:
        for h in hooks:
            h.remove()
    return out


def _rank(rank: int, store: str):
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    C._import_port()
    from torch.distributed.device_mesh import init_device_mesh
    from gym_simpletetris_tpu_torch.parallel import mesh as M
    from gym_simpletetris_tpu_torch.train import dqn
    from gym_simpletetris_tpu_torch.train.sharding import gather_train_state
    M.init_distributed(f"file://{store}", 2, rank, backend="gloo")
    torch.use_deterministic_algorithms(True)
    rec = {}
    try:
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        for name, net, init_fn in _networks(mesh):
            states = [("init", init_fn(0))]
            if name == "7i":
                chunk_fn = dqn.make_train(C._p9_dqn_configs()[1], "cuda",
                                          mesh=mesh)[2]
                states.append((f"after {RING_STEPS} steps",
                               chunk_fn(init_fn(0), RING_STEPS)[0]))
            for when, st in states:
                for case, (x, key) in _cases(name, st).items():
                    tag = f"{name}|{when}|{case}"
                    rec[f"{tag}|x"] = x.cpu().numpy()
                    for k, v in _forward(net, st.params, x, key,
                                         name == "ppo").items():
                        rec[f"{tag}|out|{k}"] = v
                for k, v in gather_train_state(st, mesh).params.items():
                    rec[f"{name}|{when}|param|{k}"] = v.cpu().numpy()
    finally:
        M.shutdown()
    if rank == 0:
        np.savez(store + ".npz", **rec)


def main() -> int:
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    C._import_port()
    from gym_simpletetris_tpu_torch.core.state import _key_tensor
    with tempfile.TemporaryDirectory(prefix=".tp_smoke_", dir=ROOT) as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, __file__, str(r), store])
                 for r in range(2)]
        if any(p.wait() != 0 for p in procs):
            print("torch_tp_layers: a rank failed", file=sys.stderr)
            return 1
        rec = dict(np.load(store + ".npz"))
    torch.use_deterministic_algorithms(True)
    nets = {name: net for name, net, _ in _networks(None)}
    tags = sorted({k.rsplit("|", 1)[0] for k in rec if k.endswith("|x")})
    for tag in tags:
        name, when, case = tag.split("|")
        params = {k.split("|")[-1]: torch.from_numpy(v).cuda()
                  for k, v in rec.items()
                  if k.startswith(f"{name}|{when}|param|")}
        x = torch.from_numpy(rec[f"{tag}|x"]).cuda()
        key = _key_tensor(11, "cuda") if case.endswith("noisy") else None
        whole = _forward(nets[name], params, x, key, name == "ppo")
        cells = []
        for k, v in whole.items():
            got = rec[f"{tag}|out|{k}"]
            cells.append(f"{k} =" if got.tobytes() == v.tobytes() else
                         f"{k} DIFF {np.abs(got - v).max():.3g} "
                         f"{100 * (got != v).mean():.3g}%")
        print(f"{name} {when}, {case} {tuple(x.shape)}: {'; '.join(cells)}",
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        _rank(int(sys.argv[1]), sys.argv[2])
        sys.exit(0)
    sys.exit(main())
