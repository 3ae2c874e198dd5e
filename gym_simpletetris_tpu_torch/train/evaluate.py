"""Policy evaluation CLI of the PyTorch port: random / heuristic / ppo
checkpoints, one JSON line each (port of
``gym_simpletetris_tpu.train.evaluate``, plus ``--device``).

    python -m gym_simpletetris_tpu_torch.train.evaluate --policies ppo \
        --ckpt artifacts/ppo_lineclear_params.npz --num-envs 512 --steps 3000

A ppo checkpoint is either an ``.npz`` of flax parameters
(``utils.checkpoint.load_flax_params``) or a ``PPOState`` file written by
``run_ppo --ckpt``; a dqn checkpoint likewise an ``.npz`` of flax Q-network
parameters or a ``DQNState`` file written by ``run_dqn --ckpt``; an es
checkpoint an ``ESState`` file written by ``run_es --ckpt`` (its policy's
hidden widths given by ``--es-hidden``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..api.env import TetrisVectorEnv, check_device
from ..api.wrappers import EpisodeStats
from ..core.config import EnvConfig


def evaluate_policy(env: TetrisVectorEnv, action_fn, steps: int,
                    seed: int) -> dict:
    """Roll ``steps`` with ``action_fn(obs, state) -> actions``; aggregate
    episode stats over the batch."""
    es = EpisodeStats(env)
    obs, state = es.reset(seed)
    for _ in range(steps):
        obs, state, r, d, info = es.step(state,
                                         action_fn(obs, state.env_state))
    eps = state.episodes.cpu().numpy()
    rets = state.last_return.cpu().numpy()
    lens = state.last_length.cpu().numpy()
    mask = eps > 0
    # total_lines spans all episodes (accumulated from info["lines_delta"])
    total_lines = int(state.total_lines.sum())
    n_eps = int(eps.sum())
    return {
        "episodes": n_eps,
        "mean_return": round(float(rets[mask].mean()), 2) if mask.any() else None,
        "mean_length": round(float(lens[mask].mean()), 2) if mask.any() else None,
        "total_lines": total_lines,
        "lines_per_episode": round(total_lines / n_eps, 3) if n_eps else None,
        "total_deaths": int(state.env_state.deaths.sum()),
    }


def _params(ckpt: str, device) -> dict:
    """A state_dict from an ``.npz`` of flax parameters or a trainer
    checkpoint (read onto ``device``)."""
    from ..utils.checkpoint import load_flax_params, restore_checkpoint
    if ckpt.endswith(".npz"):
        return load_flax_params(ckpt)
    return restore_checkpoint(ckpt, device).params


def make_action_fn(name: str, cfg: EnvConfig, batch: int, ckpt: str = None,
                   seed: int = 0, device="cuda", atoms: int = 0,
                   noisy: bool = False, es_hidden=(64, 64)):
    """``action_fn(obs, env_state) -> int32[batch]`` on ``device``: the card
    unless ``device="cpu"``; a CUDA request without a card raises here.
    ``atoms`` / ``noisy``: the dqn checkpoint's C51 atom count and
    NoisyNet layers; ``es_hidden``: the es policy's MLP widths."""
    device = check_device(device)
    if name == "random":
        rng = np.random.RandomState(seed)
        return lambda obs, st: torch.as_tensor(rng.randint(0, 7, batch),
                                               device=device)
    if name == "heuristic":
        from ..models.heuristic import make_heuristic_policy
        pol = make_heuristic_policy(cfg)
        return lambda obs, st: pol(st)
    if name == "ppo":
        if ckpt is None:
            raise ValueError("--ckpt required for the ppo policy")
        from ..api import spaces
        from ..models.actor_critic import ActorCritic
        net = ActorCritic(spaces.observation_space(cfg).shape,
                          obs_type=cfg.obs_type)
        net.load_state_dict(_params(ckpt, device))
        net.to(device)

        @torch.no_grad()
        def act_ppo(obs, st):
            logits, _ = net(obs.float())
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return act_ppo
    if name == "dqn":
        if ckpt is None:
            raise ValueError("--ckpt required for the dqn policy")
        return _dqn_policy(cfg, _params(ckpt, device), atoms, noisy, device)
    if name == "es":
        if ckpt is None:
            raise ValueError("--ckpt required for the es policy")
        from ..utils.checkpoint import restore_checkpoint
        from .es import ESConfig, _build_policy, greedy_params
        escfg = ESConfig(env=cfg, hidden=tuple(es_hidden))
        net = _build_policy(escfg)[0]
        net.load_state_dict(greedy_params(escfg,
                                          restore_checkpoint(ckpt, device).theta))
        net.to(device)

        @torch.no_grad()
        def act_es(obs, st):
            return torch.argmax(net(obs.float()), dim=-1).to(torch.int32)
        return act_es
    raise ValueError(f"unknown policy {name!r}")


def _dqn_policy(cfg: EnvConfig, params: dict, atoms: int, noisy: bool,
                device):
    """Greedy actions of a Q-network: argmax of Q, or under a C51 head of
    the expectation over the atom index (greedy over E[Z] is the same for
    any linear support). A noisy network plays mu-only (no noise key). A
    dueling head is read from the parameters' names."""
    from ..api import spaces
    from ..models.dqn import build_q_network
    from .dqn import _softmax
    from .replay import _sum_f32
    dueling = any(k.startswith(("DuelingHead_0.", "C51Head_0.value."))
                  for k in params)
    net = build_q_network(cfg.obs_type, spaces.observation_space(cfg).shape,
                          dueling=dueling, num_atoms=atoms, noisy=noisy)
    net.load_state_dict(params)
    net.to(device)
    idx = torch.arange(atoms, dtype=torch.float32, device=device)

    @torch.no_grad()
    def act_dqn(obs, st):
        out = net(obs)
        if atoms:
            out = _sum_f32(_softmax(out) * idx)
        return torch.argmax(out, dim=1).to(torch.int32)
    return act_dqn


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--policies", nargs="+", default=["random", "heuristic"])
    p.add_argument("--obs", default="ram", choices=["ram", "grayscale", "rgb"])
    p.add_argument("--width", type=int, default=10)
    p.add_argument("--height", type=int, default=20)
    p.add_argument("--reward-step", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--atoms", type=int, default=0,
                   help="num_atoms of a distributional (C51) dqn checkpoint")
    p.add_argument("--noisy", action="store_true",
                   help="the dqn checkpoint has NoisyNet layers (evaluated "
                        "deterministically with the mu weights)")
    p.add_argument("--es-hidden", type=int, nargs="+", default=[64, 64],
                   help="hidden widths of an es checkpoint's policy MLP")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (raises without a card) or cpu")
    args = p.parse_args(argv)

    cfg = EnvConfig(width=args.width, height=args.height, obs_type=args.obs,
                    auto_reset=True, reward_step=args.reward_step)
    env = TetrisVectorEnv(cfg, args.num_envs, device=args.device)
    results = {}
    for name in args.policies:
        fn = make_action_fn(name, cfg, args.num_envs, args.ckpt, args.seed,
                            device=args.device, atoms=args.atoms,
                            noisy=args.noisy, es_hidden=tuple(args.es_hidden))
        results[name] = evaluate_policy(env, fn, args.steps, args.seed)
        print(json.dumps({name: results[name]}), flush=True)
    return results


if __name__ == "__main__":
    main()
