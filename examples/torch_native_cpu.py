"""Host-native backend tour on the PyTorch port: the C++ engine, no torch
device, then the same games on the torch engine in lockstep.

Three tiers, slowest to fastest:
  1. make(backend="native")      - drop-in old-gym single env (reference API)
  2. NativeVectorEnv             - B games per ctypes call
  3. NativeTetrisEngine.drive()  - bulk offline rollouts
and a check: the native env and ``make(backend=--device)`` (the card
unless ``--device cpu``) fed the same spawn draws agree step for step.

Run: python examples/torch_native_cpu.py [--device cuda|cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # run from anywhere

import argparse
import time

import numpy as np

from gym_simpletetris_tpu_torch import NativeVectorEnv, make
from gym_simpletetris_tpu_torch.native import NativeTetrisEngine

p = argparse.ArgumentParser(description=__doc__)
p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = p.parse_args()

# GST_EXAMPLE_SMOKE=1 shrinks the run for the test suite
_SMOKE = bool(_os.environ.get("GST_EXAMPLE_SMOKE"))

# -- 1. reference-style agent loop on the C++ engine -------------------------
env = make("SimpleTetris-v0", backend="native", obs_type="ram",
           reward_step=True, seed=0)
obs = env.reset()
ep_reward, episodes = 0.0, 0
rng = np.random.RandomState(0)
while episodes < 3:
    obs, reward, done, info = env.step(rng.randint(0, 7))
    ep_reward += reward
    if done:
        episodes += 1
        print(f"episode {episodes}: return {ep_reward:.0f}, "
              f"lines {info['lines_cleared']}, pieces {info['statistics']}")
        ep_reward = 0.0
        obs = env.reset()
print(env)  # ASCII board

# -- 2. batched vector env ----------------------------------------------------
venv = NativeVectorEnv(batch_size=256, obs_type="ram", auto_reset=True,
                       seed=1, with_info=True)
venv.reset()
t0 = time.perf_counter()
steps = 100 if _SMOKE else 2000
for _ in range(steps):
    obs, rew, done, info = venv.step(rng.randint(0, 7, 256))
dt = time.perf_counter() - t0
print(f"\nNativeVectorEnv: {steps * 256 / dt / 1e6:.2f}M env-steps/s "
      f"(256 games, auto-reset); total deaths {int(info['deaths'].sum())}")

# -- 3. bulk rollouts (checkpointable) ----------------------------------------
eng = NativeTetrisEngine(seed=2)
eng.clear()
actions = rng.randint(0, 7, 50_000 if _SMOKE else 1_000_000).astype(np.int32)
t0 = time.perf_counter()
boards, rewards, dones, _, _ = eng.drive(actions, auto_clear=True)
dt = time.perf_counter() - t0
snap = eng.save_state()          # bit-identical resume point
print(f"drive(): {len(actions) / dt / 1e6:.2f}M engine-steps/s, "
      f"{int(dones.sum())} episodes, state snapshot {snap.nbytes} bytes")

# -- the same game on both engines, fed the same spawn draws -----------------
nat = make(backend="native", obs_type="grayscale", seed=3)
dev = make(backend=args.device, obs_type="grayscale", seed=3)


def draw(info):
    """randint(1, sum(m)) of the count-balanced spawn weights."""
    c = np.array(list(info["statistics"].values()))
    return int(rng.randint(1, int((5 + c.max() - c).sum()) + 1))


r = draw({"statistics": dict.fromkeys("TJLZSIO", 0)})
(o1, i1), (o2, i2) = (e.reset(return_info=True, injected_r=r)
                      for e in (nat, dev))
n = 60 if _SMOKE else 500
for t in range(n):
    a, r = int(rng.randint(0, 7)), draw(i2)
    (o1, r1, d1, i1), (o2, r2, d2, i2) = (e.step(a, injected_r=r)
                                          for e in (nat, dev))
    assert np.array_equal(o1, o2) and (r1, d1, i1) == (r2, d2, i2), t
    if d1:
        r = draw(i2)
        (o1, i1), (o2, i2) = (e.reset(return_info=True, injected_r=r)
                              for e in (nat, dev))
print(f"native and {args.device} engines agree over {n} grayscale steps")
