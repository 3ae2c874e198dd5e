"""Train DQN briefly on the PyTorch port, evaluate it against random and
the heuristic, save a GIF of the agent; on the card unless
``--device cpu``.

Run: python examples/torch_train_and_watch.py [--device cuda|cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # run from anywhere

import argparse

import torch
from torch.func import functional_call

from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.train.dqn import DQNConfig, make_train
from gym_simpletetris_tpu_torch.train.evaluate import (evaluate_policy,
                                                       make_action_fn)
from gym_simpletetris_tpu_torch.utils.video import frames_from_rows, write_gif

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = p.parse_args()

# GST_EXAMPLE_SMOKE=1 shrinks the run so the test suite can execute this
# example end-to-end (tests/test_torch_examples.py); the default is the demo
SMOKE = bool(_os.environ.get("GST_EXAMPLE_SMOKE"))

cfg = DQNConfig(
    env=EnvConfig(obs_type="ram", auto_reset=True, reward_step=True,
                  penalise_holes_increase=True),
    num_envs=32 if SMOKE else 512, buffer_capacity=4096 if SMOKE else 65536,
    learn_batch=64 if SMOKE else 512, learn_starts=128 if SMOKE else 2048)
init_fn, _, chunk_fn, network = make_train(cfg, args.device)
state = init_fn(0)
for i in range(2 if SMOKE else 20):
    state, metrics = chunk_fn(state, 50 if SMOKE else 500)
    print(f"chunk {i}: reward={float(metrics['mean_reward']):.2f} "
          f"q={float(metrics['mean_q']):.1f} eps={float(metrics['epsilon']):.2f}")


@torch.no_grad()
def dqn_action(obs, st):
    q = functional_call(network, state.params, (obs, None))
    return torch.argmax(q, dim=1).to(torch.int32)


# evaluate
n_eval = 16 if SMOKE else 128
eval_env = TetrisVectorEnv(cfg.env, n_eval, device=args.device)
for name, fn in [("dqn", dqn_action),
                 ("random", make_action_fn("random", cfg.env, n_eval,
                                           device=args.device)),
                 ("heuristic", make_action_fn("heuristic", cfg.env, n_eval,
                                              device=args.device))]:
    print(name, evaluate_policy(eval_env, fn, steps=50 if SMOKE else 500,
                                seed=1))

# record the greedy agent
genv = TetrisVectorEnv(cfg.env.replace(auto_reset=False), 1,
                       device=args.device)
obs, st = genv.reset(7)
hist = [genv.render_rows(st)]
for t in range(40 if SMOKE else 400):
    obs, st, r, d, _ = genv.step(st, dqn_action(obs, st))
    hist.append(genv.render_rows(st))
    if bool(d[0]):
        break
write_gif(frames_from_rows(genv.config, hist, size=160), "dqn_episode.gif")
print(f"wrote dqn_episode.gif ({len(hist)} frames)")
