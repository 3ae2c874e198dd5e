"""Drive the gymnasium vector env of the port
(``api/gymnasium_vector.py``): its next-step-autoreset core
``_TorchVectorCore``, which ``make_gymnasium_vector_env(n, backend=...)``
wraps in a ``gymnasium.vector.VectorEnv`` (gymnasium itself is not installed
beside the card, and its wrapper adds only the info dict's presence masks
and the truncations). A closed loop: ``step(actions)`` with random actions,
each call returning numpy observations, rewards, terminations and infos.

Traffic parameters: ``batch``, ``action_blocks`` (the seed's action arrays
[K, B], uniform in [0, 7), cycled), ``warmup_calls``, ``compare_envs``
(the envs whose observation every call is compared; every env's rewards,
terminations and infos are, and every env's observation of the last call)
and ``trace_calls``. A call's latency runs from the call until its numpy
results are returned. Set-up resets the core and makes ``warmup_calls``
calls.
"""

from __future__ import annotations

import time

import numpy as np

from . import common
from ..reference import surfaces

_INFO = ("time", "current_piece", "score", "lines_cleared", "holes", "deaths",
         "statistics")


class Entry:
    def __init__(self, env_kwargs: dict, mix: dict, seeds, device):
        self.env_kwargs = env_kwargs
        self.mix = mix
        self.seeds = seeds
        self.device = device
        self.batch = int(mix["batch"])
        self.steps_per_call = self.batch
        self.sample = common.sample_envs(self.batch, int(mix["compare_envs"]),
                                         seeds.sample)
        self.log = []

    def setup(self) -> None:
        from gym_simpletetris_tpu_torch.api.gymnasium_vector import (
            _TorchVectorCore)
        self.core = _TorchVectorCore(self.batch, self.seeds.env,
                                     device=str(self.device),
                                     **self.env_kwargs)
        rng = np.random.default_rng(self.seeds.actions)
        self.actions = rng.integers(
            0, 7, (int(self.mix["action_blocks"]), self.batch))
        obs, info = self.core.reset()
        self.first = dict(obs=obs[self.sample], info=_copy(info))
        for _ in range(int(self.mix["warmup_calls"])):
            self.call()

    def call(self) -> float:
        block = len(self.log) % len(self.actions)
        t0 = time.perf_counter()
        obs, reward, term, info = self.core.step(self.actions[block])
        lat = time.perf_counter() - t0
        self.log.append(dict(block=block, obs=obs[self.sample],
                             reward=reward.copy(), terminated=term.copy(),
                             info=_copy(info)))
        self.last_obs = obs
        return lat

    def collect(self) -> None:
        self.log[-1]["obs_all"] = self.last_obs
        self.core = self.last_obs = None

    def check(self, control: bool):
        calls = [self.actions[c["block"]] for c in self.log]
        args = (self.env_kwargs, self.batch, self.seeds.env, calls, self.sample)
        first, want = surfaces.vector(*args)
        if control:
            got_first, got = surfaces.vector(*args, uniform_pieces=True)
        else:
            got_first, got = self.first, self.log
        n = dict(obs=0, reward=0, terminated=0, info=0)
        n["obs"] += common.mismatches(got_first["obs"], first["obs"])
        n["info"] += _info_mismatches(got_first["info"], first["info"])
        for g, w in zip(got, want):
            for k in ("reward", "terminated"):
                n[k] += (g[k].dtype != w[k].dtype) or \
                    common.mismatches(g[k], w[k])
            n["obs"] += common.mismatches(g["obs"], w["obs"])
            n["info"] += _info_mismatches(g["info"], w["info"])
        n["obs"] += common.mismatches(got[-1]["obs_all"], want[-1]["obs_all"])
        return common.checks({f"{k}_mismatches": v for k, v in n.items()}), \
            dict(calls=len(want), envs=self.batch, obs_envs=len(self.sample),
                 env_steps=len(want) * self.batch)


def _copy(info: dict) -> dict:
    return {k: np.array(info[k]) for k in _INFO}


def _info_mismatches(got: dict, want: dict) -> int:
    if set(got) != set(want):
        return 1
    return sum(common.mismatches(got[k], want[k]) for k in want)
