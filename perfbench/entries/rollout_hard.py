"""The rollout entry (``entries/rollout.py``) under hard drops: action 2
for every env and every step, so that every step locks a piece and the
episode reset runs at many times the uniform mix's rate. Everything else,
the comparison included, is the rollout entry's."""

from __future__ import annotations

from . import rollout

HARD_DROP = 2


class Entry(rollout.Entry):
    def setup(self) -> None:
        import torch
        from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
        cfg = EnvConfig(**self.env_kwargs, auto_reset=self.mix["auto_reset"])
        self.env = TetrisVectorEnv(cfg, self.batch, device=self.device)
        self.actions = torch.full(
            (int(self.mix["action_blocks"]), self.T, self.batch), HARD_DROP,
            dtype=torch.int32, device=self.device)
        self.idx = torch.as_tensor(self.sample, device=self.device)
        _, self.state = self.env.reset(self.seeds.env)
        self.call()
