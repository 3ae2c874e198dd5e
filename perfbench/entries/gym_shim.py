"""Drive the gym shim of the port, ``api.registry.make("SimpleTetris-v0",
backend=...)`` (``api/gym_compat.py`` ``TetrisEnv``), at B = 1 in a closed
loop, as a user of the reference's API does: ``step(a)`` with a random
action, and ``reset()`` when the episode is done.

Traffic parameters: ``env_id``, ``actions`` (the length of the seed's
action sequence, uniform in [0, 7), cycled), ``warmup_calls`` and
``trace_calls``. A call is one ``step``, with the ``reset`` that follows
it where the step ended the episode; its latency is the step's alone, from
the call until its results are on the host. Set-up resets the env, makes
``warmup_calls`` calls and one more ``reset``. Every call's results are
kept on the host and compared after the window.
"""

from __future__ import annotations

import time

import numpy as np

from . import common
from ..reference import surfaces


class Entry:
    def __init__(self, env_kwargs: dict, mix: dict, seeds, device):
        self.env_kwargs = env_kwargs
        self.mix = mix
        self.seeds = seeds
        self.device = device
        self.batch = 1
        self.steps_per_call = 1
        self.log = []
        self.steps = 0

    def setup(self) -> None:
        from gym_simpletetris_tpu_torch.api import registry
        self.env = registry.make(self.mix["env_id"], backend=str(self.device),
                                 seed=self.seeds.env, **self.env_kwargs)
        rng = np.random.default_rng(self.seeds.actions)
        self.actions = rng.integers(0, 7, int(self.mix["actions"])).tolist()
        self.log.append(("reset", self.env.reset()))
        for _ in range(int(self.mix["warmup_calls"])):
            self.call()
        self.log.append(("reset", self.env.reset()))

    def call(self) -> float:
        a = self.actions[self.steps % len(self.actions)]
        self.steps += 1
        t0 = time.perf_counter()
        obs, reward, done, info = self.env.step(a)
        lat = time.perf_counter() - t0
        self.log.append(("step", a, obs, reward, done, info))
        if done:
            self.log.append(("reset", self.env.reset()))
        return lat

    def collect(self) -> None:
        self.env.close()
        self.env = None

    def check(self, control: bool):
        calls = [c[:2] if c[0] == "step" else c[:1] for c in self.log]
        want = surfaces.gym(self.env_kwargs, self.seeds.env, calls)
        if control:
            got = surfaces.gym(self.env_kwargs, self.seeds.env, calls,
                               uniform_pieces=True)
        else:
            got = [dict(obs=c[1]) if c[0] == "reset" else
                   dict(obs=c[2], reward=c[3], done=c[4], info=c[5])
                   for c in self.log]
        n = dict(obs=0, reward=0, done=0, info=0)
        for g, w in zip(got, want):
            obs = np.asarray(g["obs"])
            n["obs"] += (obs.dtype != w["obs"].dtype
                         or common.mismatches(obs, w["obs"]) > 0)
            if "reward" in w:
                n["reward"] += not (type(g["reward"]) is float
                                    and g["reward"] == w["reward"])
                n["done"] += g["done"] is not w["done"]
                n["info"] += g["info"] != w["info"]
        steps = sum(1 for c in calls if c[0] == "step")
        return common.checks({f"{k}_mismatches": v for k, v in n.items()}), \
            dict(calls=len(calls), steps=steps, resets=len(calls) - steps)
