"""gym_simpletetris_tpu_torch — the PyTorch / CUDA port of gym_simpletetris_tpu.

The complete SimpleTetris-v0 environment on a torch device, with the same
bits as the JAX package: a bit-packed batched engine, the grayscale / rgb
raster, a rollout loop, and the user-facing surfaces on top. On CUDA the
step, the raster and the raster-accumulate run as hand-written kernels for
Hopper (``csrc/``), built with nvcc at first use; on the CPU the same
functions run in plain PyTorch.

- the batched env: ``TetrisVectorEnv``, ``reset_fn`` / ``step_fn``
  (``api.env``), and the wrappers (``api.wrappers``);
- the reference-compatible surfaces: ``make`` (``api.registry``), the
  old-gym ``TetrisEnv`` (``api.gym_compat``), the standalone
  ``TetrisEngine`` and ``convert_grayscale*`` (``api.engine``), the
  gymnasium adapters (``api.registry.make_gymnasium_env``,
  ``make_gymnasium_vector_env``), and the host C++ backend
  (``NativeTetrisEnv``, ``NativeVectorEnv``, ``NativeTetrisEngine``);
- the trainers: PPO, Rainbow DQN on three replay layouts, and ES, with their
  CLIs (``train``), the networks and the lookahead heuristic (``models``);
- ``utils``: checkpoints, metric sinks, video export and profiling hooks.

Quick start (batched):
    >>> from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
    >>> env = TetrisVectorEnv(EnvConfig(obs_type="ram", auto_reset=True), 4096)
    >>> obs, state = env.reset(0)
    >>> obs, state, reward, done, info = env.step(state, actions)

Quick start (reference-compatible, single env):
    >>> from gym_simpletetris_tpu_torch import make
    >>> env = make("SimpleTetris-v0", obs_type="grayscale")
    >>> obs = env.reset()
    >>> obs, reward, done, info = env.step(env.action_space.sample())

The entry points run on the card unless given ``device="cpu"`` (``make``:
``backend="cpu"``); without a card a CUDA request raises. This package
imports neither jax nor gym_simpletetris_tpu; gymnasium, gym, pygame, PIL and
tensorboardX only inside the functions that use them.
"""

from .core.config import EnvConfig
from .core.state import EnvState, init_state
from .core.pieces import PIECE_NAMES
from .api.env import TetrisVectorEnv, step_fn, reset_fn, build_observation
from .api.gym_compat import TetrisEnv
from .api.engine import TetrisEngine, convert_grayscale, convert_grayscale_rgb
from .api.registry import make, register, register_gym, register_gymnasium

__all__ = [
    "EnvConfig", "EnvState", "init_state", "PIECE_NAMES",
    "TetrisVectorEnv", "TetrisEnv", "TetrisEngine", "step_fn", "reset_fn",
    "build_observation", "convert_grayscale", "convert_grayscale_rgb",
    "make", "register", "register_gym", "register_gymnasium",
    "NativeTetrisEnv", "NativeVectorEnv", "NativeTetrisEngine",
]

# Mirror the reference's import-time legacy-gym registration
# (gym_simpletetris/__init__.py:3-6); a no-op when old gym isn't importable.
register_gym()


def __getattr__(name):
    # Lazy: first touch compiles the C++ engine (native/__init__.py).
    if name == "NativeTetrisEnv":
        from .api.native_env import NativeTetrisEnv
        return NativeTetrisEnv
    if name == "NativeVectorEnv":
        from .api.native_env import NativeVectorEnv
        return NativeVectorEnv
    if name == "NativeTetrisEngine":
        from .native import NativeTetrisEngine
        return NativeTetrisEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
