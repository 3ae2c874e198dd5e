"""gymnasium.vector.VectorEnv adapters (new v1 API) over both backends (port
of ``gym_simpletetris_tpu.api.gymnasium_vector``).

The reference never had a vector API (one ``TetrisEnv`` per game,
tetris_env.py:338-467); these adapters expose the batched engines to
gymnasium-ecosystem tooling (vector wrappers, recorders, RL libraries).

gymnasium v1 autoreset convention: when an episode terminates at step t,
step t returns the TERMINAL observation with ``terminated=True``; at step
t+1 the env resets instead of stepping: the provided action is ignored, the
reset observation is returned with reward 0 and ``terminated=False``. (The
in-framework ``EnvConfig.auto_reset`` uses the same-step convention; the
adapter keeps a pending mask and reconciles.)

``truncations`` are always False: the reference registers no TimeLimit
(gym_simpletetris/__init__.py:3-6).

The cores (``_TorchVectorCore``, ``_NativeVectorCore``) import without
gymnasium; the gymnasium class is built inside
``make_gymnasium_vector_env``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import engine as E
from ..core import threefry
from ..core.config import EnvConfig
from ..core.state import key_data
from ..utils.profiling import span
from . import env as api_env


def _batched_info(info_arrays: dict) -> dict:
    """gymnasium vector info format: arrays plus per-key presence masks."""
    n = len(next(iter(info_arrays.values())))
    out = {}
    for k, v in info_arrays.items():
        out[k] = np.asarray(v)
        out["_" + k] = np.ones(n, dtype=bool)
    return out


def make_gymnasium_vector_env(num_envs: int, backend: str = "cuda",
                              seed: int = 0, **kwargs):
    """A real ``gymnasium.vector.VectorEnv`` over the batched engine.

    backend="cuda" / "cpu": the torch engine on that device (device-resident
    state; kernels A and B on the card). backend="native": the host C++
    ``NativeVectorEnv``. kwargs: the reference env kwargs (width, obs_type,
    lock_delay, ...).
    """
    from gymnasium.vector import VectorEnv
    from gymnasium.vector.utils import batch_space

    if backend in ("cuda", "cpu"):
        core = _TorchVectorCore(num_envs, seed, device=backend, **kwargs)
    elif backend == "native":
        core = _NativeVectorCore(num_envs, seed, **kwargs)
    else:
        raise ValueError(f"unknown backend {backend!r}; use 'cuda', 'cpu' "
                         "or 'native'")

    try:  # gymnasium >= 1.0: wrappers assert on the AutoresetMode enum
        from gymnasium.vector import AutoresetMode
        _mode = AutoresetMode.NEXT_STEP
    except ImportError:  # older gymnasium: informational string
        _mode = "NextStep"

    class _GymnasiumTetrisVector(VectorEnv):
        metadata = {"autoreset_mode": _mode}

        def __init__(self):
            self.num_envs = num_envs
            self.single_observation_space = \
                core.single_observation_space.to_gymnasium()
            self.single_action_space = core.single_action_space.to_gymnasium()
            self.observation_space = batch_space(
                self.single_observation_space, num_envs)
            self.action_space = batch_space(self.single_action_space, num_envs)

        def reset(self, *, seed=None, options=None):
            obs, info = core.reset(seed)
            return obs, _batched_info(info)

        def step(self, actions):
            obs, reward, term, info = core.step(np.asarray(actions))
            trunc = np.zeros(num_envs, dtype=bool)
            return obs, reward, term, trunc, _batched_info(info)

        def close_extras(self, **kw):
            pass

    return _GymnasiumTetrisVector()


def fused_step(cfg: EnvConfig, state, action: torch.Tensor,
               pending: torch.Tensor):
    """Reset pending envs (ignoring their action), step the rest: (state,
    obs, reward, terminated, info).

    The stepped results of pending envs are discarded wholesale by
    ``apply_reset_mask``, which clears them from the PRE-step state, so
    the ignored action cannot leak, including into the deaths counter or
    RNG-visible state."""
    out = E.engine_step(cfg, state, action)
    new_state, emitted = api_env.apply_reset_mask(
        cfg, out.state, out.emitted_rows, pending, cleared_from=state)
    obs = api_env.build_observation(cfg, emitted)
    reward = torch.where(pending, 0.0, out.reward)
    term = torch.where(pending, False, out.done)
    return new_state, obs, reward, term, api_env.make_info(new_state)


class _TorchVectorCore:
    """Next-step-autoreset core over the batched torch engine, on
    ``device`` (the card unless "cpu"). Returns numpy, each step's outputs
    in one device -> host copy."""

    def __init__(self, num_envs: int, seed: int, device="cuda", **kwargs):
        cfg = EnvConfig(**kwargs)
        if cfg.auto_reset:                 # the adapter owns reset timing
            raise ValueError(
                "auto_reset is owned by the gymnasium vector adapter "
                "(next-step autoreset); do not pass auto_reset=True")
        self.config = cfg
        self._env = api_env.TetrisVectorEnv(cfg, batch_size=num_envs,
                                            device=device)
        self.device = self._env.device
        self._seed = seed
        self._reset_count = 0
        self._state = None
        self._pending = torch.zeros(num_envs, dtype=torch.bool,
                                    device=self.device)
        self.single_observation_space = self._env.observation_space
        self.single_action_space = self._env.action_space

    def reset(self, seed=None):
        if seed is not None:
            self._seed = seed
            self._reset_count = 0
        # gymnasium convention: reset(seed=None) must NOT replay the same
        # episodes: fold a reset counter into the key, as
        # jax.random.fold_in(PRNGKey(seed), count) does
        key = threefry.fold_in(torch.from_numpy(
            key_data(self._seed).view(np.int32)), self._reset_count)
        self._reset_count += 1
        obs, self._state = self._env.reset(key)
        self._pending.zero_()
        (obs,), info = self._host(api_env.make_info(self._state), obs)
        return obs, info

    @span("vector.step")
    def step(self, actions):
        action = torch.as_tensor(np.asarray(actions), device=self.device) \
            .to(torch.int32)
        self._state, obs, reward, term, info = fused_step(
            self.config, self._state, action, self._pending)
        self._pending = term
        (obs, reward, term), info = self._host(info, obs, reward, term)
        return obs, reward, term, info

    @staticmethod
    def _host(info: dict, *tensors):
        """``tensors`` and the info dict's tensors as numpy, one copy."""
        got = api_env.to_host(*tensors, *info.values())
        return got[:len(tensors)], dict(zip(info, got[len(tensors):]))


class _NativeVectorCore:
    """Next-step-autoreset core over the host C++ vector env: pending envs are
    clear()ed and excluded from the step call (their action is ignored)."""

    def __init__(self, num_envs: int, seed: int, **kwargs):
        from .native_env import NativeVectorEnv

        obs_kw = {k: kwargs.pop(k) for k in
                  ("obs_type", "extend_dims", "render_mode") if k in kwargs}
        self._venv = NativeVectorEnv(num_envs, auto_reset=False, seed=seed,
                                     with_info=False, **obs_kw, **kwargs)
        self._pending = np.zeros(num_envs, dtype=bool)
        self.single_observation_space = self._venv.observation_space
        self.single_action_space = self._venv.action_space

    def reset(self, seed=None):
        if seed is not None:
            self._venv.reseed(seed)   # fresh engines + splitmix streams
        obs = self._venv.reset()
        self._pending[:] = False
        return obs, self._venv.infos()

    def step(self, actions):
        v = self._venv
        n = v.batch_size
        pend = self._pending
        boards = np.zeros((n, v.width, v.height), np.uint8)
        rewards = np.zeros(n, np.float32)
        term = np.zeros(n, dtype=bool)
        live = np.nonzero(~pend)[0]
        if live.size:
            handles = v._handles[live]
            acts = np.ascontiguousarray(actions[live], np.int32)
            lb = np.empty((live.size, v.width, v.height), np.uint8)
            lr = np.empty(live.size, np.float32)
            ld = np.empty(live.size, np.uint8)
            r1 = np.empty(live.size, np.int32)
            r2 = np.empty(live.size, np.int32)
            rc = v._lib.tetris_step_vec(handles, live.size, acts, 0,
                                        v.threads, lb, lr, ld, r1, r2)
            assert rc == 0
            boards[live], rewards[live] = lb, lr
            term[live] = ld != 0
        pend_idx = np.nonzero(pend)[0]
        if pend_idx.size:                 # reset obs = empty board, reward 0
            r0 = np.empty(pend_idx.size, np.int32)
            dump = np.empty((pend_idx.size, v.width, v.height), np.uint8)
            rc = v._lib.tetris_clear_vec(
                np.ascontiguousarray(v._handles[pend_idx]), pend_idx.size,
                r0, dump)
            assert rc == 0
        self._pending = term.copy()
        return v._observation(boards), rewards, term, self._venv.infos()