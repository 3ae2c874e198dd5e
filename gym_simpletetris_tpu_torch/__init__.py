"""gym_simpletetris_tpu_torch — the PyTorch / CUDA port of gym_simpletetris_tpu.

The batched SimpleTetris env on a torch device: a bit-packed engine, the
84 x 84 grayscale/rgb raster and a rollout loop, with the same bits as the
JAX package. On CUDA the step, the raster and the raster-accumulate run as
hand-written kernels for Hopper (``csrc/``), built with nvcc at first use; on
the CPU the same functions run in plain PyTorch. On top of the env: the
wrappers (``api.wrappers``), the actor-critic and the lookahead heuristic
(``models``), and the PPO trainer with its CLIs (``train.ppo``,
``train.run_ppo``, ``train.evaluate``).

    >>> from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
    >>> env = TetrisVectorEnv(EnvConfig(obs_type="ram", auto_reset=True), 4096)
    >>> obs, state = env.reset(0)
    >>> obs, state, reward, done, info = env.step(state, actions)

The entry points run on the card unless given ``device="cpu"``; without a
card a CUDA request raises. This package imports neither jax nor
gym_simpletetris_tpu.
"""

from .core.config import EnvConfig
from .core.state import EnvState, init_state
from .core.pieces import PIECE_NAMES
from .api.env import TetrisVectorEnv, step_fn, reset_fn, build_observation

__all__ = [
    "EnvConfig", "EnvState", "init_state", "PIECE_NAMES", "TetrisVectorEnv",
    "step_fn", "reset_fn", "build_observation",
]
