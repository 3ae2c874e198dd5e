"""Policy evaluation CLI of the PyTorch port: random / heuristic / ppo
checkpoints, one JSON line each (port of
``gym_simpletetris_tpu.train.evaluate``, plus ``--device``).

    python -m gym_simpletetris_tpu_torch.train.evaluate --policies ppo \
        --ckpt artifacts/ppo_lineclear_params.npz --num-envs 512 --steps 3000

A ppo checkpoint is either an ``.npz`` of flax parameters
(``utils.checkpoint.load_flax_params``) or a ``PPOState`` file written by
``run_ppo --ckpt``. The es and dqn policies are not ported yet.
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


def _ppo_params(ckpt: str) -> dict:
    from ..utils.checkpoint import load_flax_params, restore_checkpoint
    if ckpt.endswith(".npz"):
        return load_flax_params(ckpt)
    return restore_checkpoint(ckpt).params


def make_action_fn(name: str, cfg: EnvConfig, batch: int, ckpt: str = None,
                   seed: int = 0, device="cuda"):
    """``action_fn(obs, env_state) -> int32[batch]`` on ``device``: the card
    unless ``device="cpu"``; a CUDA request without a card raises here."""
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
        net.load_state_dict(_ppo_params(ckpt))
        net.to(device)

        @torch.no_grad()
        def act_ppo(obs, st):
            logits, _ = net(obs.float())
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return act_ppo
    if name in ("es", "dqn"):
        item = {"es": "12 (train/es.py)", "dqn": "11 (models/dqn.py)"}[name]
        raise NotImplementedError(
            f"the {name} policy is not ported yet: ROADMAP Queue 1 item {item}")
    raise ValueError(f"unknown policy {name!r}")


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
    # the JAX CLI's flags of the dqn and es policies, accepted so that its
    # command lines parse; those policies raise until they are ported
    p.add_argument("--atoms", type=int, default=0)
    p.add_argument("--noisy", action="store_true")
    p.add_argument("--es-hidden", type=int, nargs="+", default=[64, 64])
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
                            device=args.device)
        results[name] = evaluate_policy(env, fn, args.steps, args.seed)
        print(json.dumps({name: results[name]}), flush=True)
    return results


if __name__ == "__main__":
    main()
