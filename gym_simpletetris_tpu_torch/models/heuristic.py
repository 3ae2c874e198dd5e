"""Vectorized one-step-lookahead heuristic policy (port of
``gym_simpletetris_tpu.models.heuristic``; no learning).

For each of the 7 actions, step the engine on a copy of the batch tiled 7
times and score the resulting board by holes, height, bumpiness, reward and
death; pick the best action per env (first index on ties, as JAX's argmin).
The lookahead goes through this module's ``engine_step``, so on a CUDA state
it is one launch of the step kernel at 7 * B envs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import EnvConfig
from ..core.engine import NUM_ACTIONS, count_holes, engine_step, nonempty_rows
from ..core.state import FIELDS, EnvState
from ..ops.bitops import unpack_cells


@dataclasses.dataclass(frozen=True)
class HeuristicWeights:
    holes: float = 4.0
    height: float = 1.0
    lines: float = 8.0      # reward term
    death: float = 1000.0
    bumpiness: float = 0.25


def _tile_state(state: EnvState, n: int) -> EnvState:
    """Repeat the whole batch n times along the batch (last) axis; the key
    is global and stays as it is."""
    last = lambda x: x.repeat((1,) * (x.dim() - 1) + (n,))
    return state.replace(**{f: last(getattr(state, f))
                            for f in FIELDS if f != "key"})


def _column_heights(cfg: EnvConfig, rows: torch.Tensor) -> torch.Tensor:
    """[W, B] column heights: H minus the first filled y, 0 if empty."""
    cells = unpack_cells(cfg, rows, dtype=torch.int32)          # [H, W, B]
    top = torch.argmax(cells, dim=0)                            # first max
    any_fill = cells.amax(dim=0) > 0
    return torch.where(any_fill, cfg.height - top, 0)


def board_score(cfg: EnvConfig, state: EnvState, reward: torch.Tensor,
                done: torch.Tensor, w: HeuristicWeights) -> torch.Tensor:
    """Lower is better."""
    holes = count_holes(cfg, state.rows).float()
    height = nonempty_rows(cfg, state.rows).float()
    heights = _column_heights(cfg, state.rows).float()
    bump = torch.diff(heights, dim=0).abs().sum(dim=0)
    return (w.holes * holes + w.height * height + w.bumpiness * bump
            - w.lines * reward + w.death * done.float())


def make_heuristic_policy(cfg: EnvConfig, weights: HeuristicWeights = None):
    """Returns ``policy(state) -> action int32[B]``."""
    w = weights or HeuristicWeights()

    def policy(state: EnvState) -> torch.Tensor:
        b = state.batch_size
        tiled = _tile_state(state, NUM_ACTIONS)
        actions = torch.arange(NUM_ACTIONS, dtype=torch.int32,
                               device=state.device).repeat_interleave(b)
        out = engine_step(cfg, tiled, actions)
        score = board_score(cfg, out.state, out.reward, out.done, w)
        return torch.argmin(score.reshape(NUM_ACTIONS, b), dim=0) \
            .to(torch.int32)

    return policy
