"""tetrisRL-style standalone engine usage (no gym env) on the PyTorch port:
construct a ``TetrisEngine`` directly, drive it, read its attributes (the
reference's original interface, tetris_env.py:125-335), on the batched
engine at B = 1 on the card unless ``--device cpu``.

Run: python examples/torch_standalone_engine.py [--device cuda|cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # run from anywhere

import argparse
import random

from gym_simpletetris_tpu_torch import (TetrisEngine, convert_grayscale,
                                        convert_grayscale_rgb)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    eng = TetrisEngine(10, 20, reward_step=True, seed=7, device=args.device)
    eng.clear()
    total = 0.0
    # GST_EXAMPLE_SMOKE=1 shrinks the run for the test suite
    for t in range(60 if _os.environ.get("GST_EXAMPLE_SMOKE") else 200):
        action = random.randint(0, 6)
        board, reward, done = eng.step(action)     # (W, H) float board copy
        total += reward
        if done:
            eng.clear()                            # carries deaths/statistics
    print(eng)                                     # ASCII board, like the ref
    info = eng.get_info()
    print(f"steps={info['time']} score={info['score']} deaths={info['deaths']} "
          f"lines={info['lines_cleared']} total_reward={total}")
    print(f"piece={eng.shape_name} at {eng.anchor}, offsets {eng.shape}")
    print(f"spawn statistics: {eng.shape_counts}")

    # the module-level raster functions work on any array:
    img = convert_grayscale(eng.render(), 84)      # (84, 84) uint8
    rgb = convert_grayscale_rgb(img)               # (84, 84, 3)
    print(f"raster: {img.shape} {img.dtype}, rgb {rgb.shape}, "
          f"shades {sorted(set(img.reshape(-1).tolist()))[:4]}")


if __name__ == "__main__":
    main()
