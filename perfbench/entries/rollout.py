"""Drive ``TetrisVectorEnv.rollout`` (``api/env.py`` ``build_rollout``) of
the port: B envs, T steps a call, auto-reset, the storage accumulator.

Traffic parameters: ``batch``, ``steps_per_call``, ``action_blocks`` (K:
the seed's action arrays [K, T, B], uniform in [0, 7), made on the device
by a ``torch.Generator`` in set-up; call i takes block i mod K),
``auto_reset``, ``acc_mode``, ``compare_envs`` (the envs the reference
replays, drawn from the seed) and ``trace_calls``.

Each call ends in a synchronisation with the card, after which the
compared envs' columns of its outputs come to the host (a few small copies
a call of 1-3 s) and the rest is freed, so that the device's memory peak is
the program's. Set-up resets the env from the seed and makes one call (the
warm-up, compared like the rest).
"""

from __future__ import annotations

import numpy as np

from . import common
from ..reference import surfaces

_SCALARS = ("piece", "rot", "ax", "ay", "lock", "time", "score", "holes",
            "lines_cleared", "piece_height", "deaths")


class Entry:
    def __init__(self, env_kwargs: dict, mix: dict, seeds, device):
        self.env_kwargs = env_kwargs
        self.mix = mix
        self.seeds = seeds
        self.device = device
        self.batch = int(mix["batch"])
        self.T = int(mix["steps_per_call"])
        self.steps_per_call = self.batch * self.T
        self.sample = common.sample_envs(self.batch, int(mix["compare_envs"]),
                                         seeds.sample)
        self.got = []

    def setup(self) -> None:
        import torch
        from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
        cfg = EnvConfig(**self.env_kwargs, auto_reset=self.mix["auto_reset"])
        self.env = TetrisVectorEnv(cfg, self.batch, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seeds.actions)
        self.actions = torch.randint(
            0, 7, (int(self.mix["action_blocks"]), self.T, self.batch),
            generator=gen, dtype=torch.int32, device=self.device)
        self.idx = torch.as_tensor(self.sample, device=self.device)
        _, self.state = self.env.reset(self.seeds.env)
        self.call()

    def call(self):
        block = len(self.got) % self.actions.shape[0]
        self.state, acc, reward, done = self.env.rollout(
            self.state, self.actions[block], acc_mode=self.mix["acc_mode"])
        common.synchronize(self.device)
        idx, st = self.idx, self.state
        self.got.append(dict(
            block=block, acc=acc.index_select(0, idx).cpu().numpy(),
            reward=reward.index_select(1, idx).cpu().numpy(),
            done=done.index_select(1, idx).cpu().numpy(),
            rows=st.rows.index_select(st.rows.dim() - 1, idx).cpu().numpy(),
            counts=st.shape_counts.index_select(1, idx).cpu().numpy().T,
            key=st.key.cpu().numpy().view(np.uint32).astype(np.int64),
            **{f: getattr(st, f).index_select(0, idx).cpu().numpy()
               for f in _SCALARS}))
        return None

    def collect(self) -> None:
        """The compared envs' actions to the host; the device's freed."""
        self.blocks = self.actions.index_select(2, self.idx).cpu().numpy()
        self.state = self.actions = self.env = self.idx = None

    def check(self, control: bool):
        calls = [self.blocks[g["block"]] for g in self.got]
        want = surfaces.rollout(self.env_kwargs, self.sample, self.seeds.env,
                                calls)
        if control:
            got = [_as_program(c) for c in surfaces.rollout(
                self.env_kwargs, self.sample, self.seeds.env, calls,
                uniform_pieces=True)]
        else:
            got = self.got
        width = self.env_kwargs.get("width", 10)
        n = dict(reward=0, done=0, obs_acc=0, state=0)
        for g, w in zip(got, want):
            n["reward"] += common.mismatches(g["reward"], w["reward"])
            n["done"] += common.mismatches(g["done"], w["done"])
            n["obs_acc"] += common.mismatches(g["acc"], w["acc"])
            s = w["state"]
            n["state"] += common.mismatches(
                common.boards_of_rows(g["rows"], width), s["board"])
            n["state"] += common.mismatches(g["counts"], s["shape_counts"])
            n["state"] += common.mismatches(g["key"], s["key"])
            n["state"] += sum(common.mismatches(g[f], s[f]) for f in _SCALARS)
        compared = dict(calls=len(want), envs=len(self.sample),
                        env_steps=len(want) * self.T * len(self.sample))
        return common.checks({f"{k}_mismatches": v for k, v in n.items()}), \
            compared


def _as_program(out: dict) -> dict:
    """A reference replay's call in the form ``call`` records the
    program's (the control stands in the program's place)."""
    s = out["state"]
    x = np.arange(s["board"].shape[1])
    rows = (s["board"].astype(np.int64) << (x + 4)[None, :, None]).sum(axis=1)
    return dict(acc=out["acc"], reward=out["reward"], done=out["done"],
                rows=rows.T.astype(np.uint32), counts=s["shape_counts"],
                key=s["key"], **{f: s[f] for f in _SCALARS})
