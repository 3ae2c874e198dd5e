"""Batched API of the PyTorch port: 4096 boards in lockstep, a T-step
rollout on the card (step kernel A each step) unless ``--device cpu``.

Run: python examples/torch_vectorized_rollout.py [--device cuda|cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # run from anywhere

import argparse
import time

import numpy as np

from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.utils.profiling import block

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = p.parse_args()

# GST_EXAMPLE_SMOKE=1 shrinks the run for the test suite
SMOKE = bool(_os.environ.get("GST_EXAMPLE_SMOKE"))
B, T = (64, 32) if SMOKE else (4096, 512)

env = TetrisVectorEnv(EnvConfig(obs_type="ram", auto_reset=True), B,
                      device=args.device)
obs, state = env.reset(0)
actions = np.random.RandomState(1).randint(0, 7, (T, B))

final, acc, rew, done = block(env.rollout(state, actions))  # warm-up
t0 = time.perf_counter()
final, acc, rew, done = block(env.rollout(final, actions))
dt = time.perf_counter() - t0
print(f"{T * B / dt / 1e6:.3f}M env-steps/s on {args.device}; "
      f"{int(done.sum())} episodes finished in this rollout")
