"""Environment registry: ``make("SimpleTetris-v0", ...)`` (port of
``gym_simpletetris_tpu.api.registry``).

The reference registers id ``SimpleTetris-v0`` with gym
(gym_simpletetris/__init__.py:3-6, no max_episode_steps / reward_threshold,
so no TimeLimit wrapper). Here ``make`` returns either the single-env
old-gym shim or the batched vector env, on one of three backends: "cuda" (the
torch engine on the card, kernels A and B), "cpu" (the same engine on the
CPU, its plain versions) and "native" (the host C++ engine).
``register_gymnasium`` exposes the shim through gymnasium's own registry.
gymnasium and gym are imported only by the functions that need them.
"""

from __future__ import annotations

from ..core.config import EnvConfig

BACKENDS = ("cuda", "cpu", "native")

_REGISTRY = {}


def register(env_id: str, **defaults):
    _REGISTRY[env_id] = defaults


register("SimpleTetris-v0")


def make(env_id: str = "SimpleTetris-v0", batch_size: int = None,
         backend: str = "cuda", **kwargs):
    """batch_size=None -> the single-env old-gym-API shim
    (reference-compatible); batch_size=N -> a TetrisVectorEnv of N boards.
    backend="cuda" runs on the card (a request without one raises),
    "cpu" on the CPU, "native" on the host C++ engine (api/native_env.py)."""
    if env_id not in _REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; known: {list(_REGISTRY)}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{', '.join(map(repr, BACKENDS))}")
    merged = {**_REGISTRY[env_id], **kwargs}
    if backend == "native":
        from .native_env import NativeTetrisEnv, NativeVectorEnv
        if batch_size is not None:
            return NativeVectorEnv(batch_size, **merged)
        return NativeTetrisEnv(**merged)
    if batch_size is None:
        from .gym_compat import TetrisEnv
        return TetrisEnv(device=backend, **merged)
    from .env import TetrisVectorEnv
    merged.pop("seed", None)  # the vector env takes seeds at reset() instead
    return TetrisVectorEnv(EnvConfig(**merged), batch_size=batch_size,
                           device=backend)


def make_gymnasium_env(render_mode=None, device="cuda", **kwargs):
    """A real ``gymnasium.Env`` (new 5-tuple API) wrapping the single-env
    shim on ``device``, for ecosystem tooling (wrappers, vector APIs,
    recorders)."""
    import gymnasium

    class _GymnasiumTetris(gymnasium.Env):
        metadata = {"render_modes": ["rgb_array", "human"], "render_fps": 8}

        def __init__(self, render_mode=None, **kw):
            from .gym_compat import TetrisEnv
            self._kw = dict(kw)
            self._env = TetrisEnv(device=device, **kw)
            self.render_mode = render_mode or "rgb_array"
            self.observation_space = self._env.observation_space.to_gymnasium()
            self.action_space = self._env.action_space.to_gymnasium()

        def reset(self, *, seed=None, options=None):
            # gymnasium's own RNG (env.np_random), which check_env asks for;
            # the engine's draws come from the shim's threefry stream
            super().reset(seed=seed)
            if seed is not None:
                # reseed in place: fresh-engine semantics without rebuilding
                self._env.seed(seed)
            obs, info = self._env.reset(return_info=True)
            return obs, info

        def step(self, action):
            obs, reward, done, info = self._env.step(action)
            # the reference has no truncation concept (no TimeLimit registered)
            return obs, reward, done, False, info

        def render(self):
            return self._env.render(self.render_mode)

        def close(self):
            self._env.close()

    return _GymnasiumTetris(render_mode=render_mode, **kwargs)


def make_gymnasium_vector_env(num_envs: int, backend: str = "cuda",
                              seed: int = 0, **kwargs):
    """A ``gymnasium.vector.VectorEnv`` (v1 next-step-autoreset API) over the
    batched torch engine ("cuda" or "cpu") or the host C++ engine
    ("native"); see api/gymnasium_vector.py."""
    from .gymnasium_vector import make_gymnasium_vector_env as _make
    return _make(num_envs, backend=backend, seed=seed, **kwargs)


def register_gymnasium(env_id: str = "SimpleTetris-v0"):
    """Register with gymnasium so ``gymnasium.make(env_id)`` returns a
    new-API env on the port's engine (pass ``device="cpu"`` to run it on
    the CPU)."""
    import gymnasium
    gymnasium.register(
        id=env_id,
        entry_point="gym_simpletetris_tpu_torch.api.registry:"
                    "make_gymnasium_env")


def register_gym(env_id: str = "SimpleTetris-v0") -> bool:
    """Register with *legacy* gym when importable, mirroring the reference's
    only integration point (``gym.register(id='SimpleTetris-v0', ...)``,
    gym_simpletetris/__init__.py:3-6). Returns True iff registered. Old gym
    is bit-rotted on modern numpy, so failures are swallowed (the package
    must import fine without gym)."""
    try:
        import gym
        gym.register(
            id=env_id,
            entry_point="gym_simpletetris_tpu_torch.api.gym_compat:TetrisEnv")
        return True
    except Exception:
        return False
