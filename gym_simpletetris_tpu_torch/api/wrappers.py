"""Functional wrappers over the batched env: frame stacking and episode stats
(port of ``gym_simpletetris_tpu.api.wrappers``).

The wrappers hold no state of their own: ``reset`` returns a state object
and ``step`` takes one and returns the next, as the env does.
"""

from __future__ import annotations

import dataclasses

import torch

from .env import TetrisVectorEnv


@dataclasses.dataclass
class FrameStackState:
    env_state: object
    frames: torch.Tensor   # [B, *obs, K]


class FrameStack:
    """Stack the last K observations on a trailing axis (channel-last, the
    layout NatureDQN consumes). Works for any obs_type; reset repeats the
    first observation K times."""

    def __init__(self, env: TetrisVectorEnv, k: int = 4):
        self.env = env
        self.k = k

    def _repeat(self, obs: torch.Tensor) -> torch.Tensor:
        return obs[..., None].repeat_interleave(self.k, dim=-1)

    def reset(self, key):
        obs, state = self.env.reset(key)
        frames = self._repeat(obs)
        return frames, FrameStackState(state, frames)

    def step(self, fs_state: FrameStackState, action):
        obs, state, reward, done, info = self.env.step(fs_state.env_state,
                                                       action)
        frames = torch.cat([fs_state.frames[..., 1:], obs[..., None]], dim=-1)
        # on auto-reset boundaries, restart the stack from the reset obs
        if self.env.config.auto_reset:
            d = done.reshape(done.shape + (1,) * (frames.dim() - 1))
            frames = torch.where(d, self._repeat(obs), frames)
        return frames, FrameStackState(state, frames), reward, done, info


@dataclasses.dataclass
class EpisodeStatsState:
    env_state: object
    ep_return: torch.Tensor     # float32[B] running return
    ep_length: torch.Tensor     # int32[B]
    last_return: torch.Tensor   # float32[B] return of last finished episode
    last_length: torch.Tensor   # int32[B]
    episodes: torch.Tensor      # int32[B]
    ep_lines: torch.Tensor      # int32[B] lines cleared this episode
    last_lines: torch.Tensor    # int32[B] lines of last finished episode
    total_lines: torch.Tensor   # int32[B] lines cleared across ALL episodes
    #   (accumulated from info["lines_delta"], so lines cleared on a death
    #   step and past auto-resets are counted)


class EpisodeStats:
    """Track per-env episode returns/lengths (requires auto_reset)."""

    def __init__(self, env: TetrisVectorEnv):
        if not env.config.auto_reset:
            raise ValueError("EpisodeStats requires auto_reset=True")
        self.env = env

    def reset(self, key):
        obs, state = self.env.reset(key)
        b, dev = self.env.batch_size, self.env.device
        z = lambda dt: torch.zeros((b,), dtype=dt, device=dev)
        f, i = torch.float32, torch.int32
        return obs, EpisodeStatsState(state, z(f), z(i), z(f), z(i), z(i),
                                      z(i), z(i), z(i))

    def step(self, es: EpisodeStatsState, action):
        obs, state, reward, done, info = self.env.step(es.env_state, action)
        ret = es.ep_return + reward
        length = es.ep_length + 1
        lines = es.ep_lines + info["lines_delta"]
        new = EpisodeStatsState(
            env_state=state,
            ep_return=torch.where(done, 0.0, ret),
            ep_length=torch.where(done, 0, length),
            last_return=torch.where(done, ret, es.last_return),
            last_length=torch.where(done, length, es.last_length),
            episodes=es.episodes + done.to(torch.int32),
            ep_lines=torch.where(done, 0, lines),
            last_lines=torch.where(done, lines, es.last_lines),
            total_lines=es.total_lines + info["lines_delta"])
        info = dict(info, episode_return=new.last_return,
                    episode_length=new.last_length, episodes=new.episodes,
                    episode_lines=new.last_lines)
        return obs, new, reward, done, info
