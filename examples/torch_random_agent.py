"""The reference README's usage example (README.md:36-54) on the PyTorch
port: single env, old-gym API, random actions, 10 episodes, on the card
unless ``--device cpu``.

Run: python examples/torch_random_agent.py [--device cuda|cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # run from anywhere

import argparse

from gym_simpletetris_tpu_torch import make

# GST_EXAMPLE_SMOKE=1 shrinks the run for the test suite
EPISODES = 3 if _os.environ.get("GST_EXAMPLE_SMOKE") else 10

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = p.parse_args()

env = make("SimpleTetris-v0", backend=args.device)
env.reset()

episode = 0
while episode < EPISODES:
    obs, reward, done, info = env.step(env.action_space.sample())
    if done:
        print(f"episode {episode}: time={info['time']} score={info['score']} "
              f"lines={info['lines_cleared']} holes={info['holes']}")
        episode += 1
        env.reset()
env.close()
