"""The reference's replay of each entry the benchmark drives, in plain NumPy.

Each replay follows the port's promised draw schedule on its own threefry
(``threefry.py``) and the reference game (``game.py``), and returns what the
entry should have produced:

- ``rollout``: ``TetrisVectorEnv.reset(seed)`` then ``rollout`` calls with
  auto-reset and storage accumulation. The reset splits the seed's key once
  and draws the first pieces; each step splits the key for its spawn draw,
  and splits it again for the auto-reset's draw, which the games that died
  this step take. Envs are independent but for the shared key, so a sample
  of envs (their global indices, the draw counters) is replayed alone.
- ``gym``: the gym shim ``SimpleTetris-v0`` at B = 1, a log of ``reset`` and
  ``step`` calls. Every call splits the key once.
- ``vector``: the gymnasium vector core (next-step autoreset). Its reset
  key is ``fold_in(seed's key, 0)``. Each step splits the key once; an env
  whose episode ended on the step before is reset instead of stepped, from
  its state before the step, with the step's spawn draw; its reward is 0
  and its termination False.

``uniform_pieces=True`` replays the benchmark's control (``game.Games``).
"""

from __future__ import annotations

import numpy as np

from . import raster, threefry
from .game import PIECE_NAMES, Games

OBS_SIZE = 84


def observation(config: dict, boards: np.ndarray) -> np.ndarray:
    """The delivered float32 observation of boards [..., W, H]: ram the 0 /
    1 board, grayscale the 84 px image, rgb its three equal channels; a
    trailing axis of 1 with ``extend_dims`` (not for rgb)."""
    kind = config.get("obs_type", "ram")
    if kind == "ram":
        obs = boards.astype(np.float32)
    else:
        obs = raster.grayscale(boards, OBS_SIZE)
        if kind == "rgb":
            return np.repeat(obs[..., None], 3, axis=-1)
    return obs[..., None] if config.get("extend_dims", False) else obs


def state(g: Games, key) -> dict:
    """The games' state in the port's field names (``rot``: right turns
    of the base offsets), with the key's two words."""
    return dict(board=g.board.copy(), piece=g.piece.copy(), rot=g.turns(),
                ax=g.ax.copy(), ay=g.ay.copy(), lock=g.lock.copy(),
                time=g.time.copy(), score=g.score.copy(),
                holes=g.holes.copy(), lines_cleared=g.lines.copy(),
                piece_height=g.piece_height.copy(), deaths=g.deaths.copy(),
                shape_counts=g.counts.copy(), key=np.array(key, np.int64))


def _draw_keys(key, steps: int, splits: int):
    """The key after ``steps`` steps of ``splits`` splits each, and the draw
    keys [steps, splits, 2]."""
    out = np.zeros((steps, splits, 2), np.int64)
    for t in range(steps):
        for s in range(splits):
            key, draw = threefry.split(key)
            out[t, s] = draw
    return key, out


def rollout(config: dict, sample, seed: int, calls, uniform_pieces=False):
    """Replay the envs ``sample`` (global indices) of a batch from
    ``reset(seed)`` through rollout calls; ``calls`` is a list of action
    arrays [T, len(sample)]. Returns, per call, a dict: ``reward`` [T, S],
    ``done`` [T, S], ``acc`` (the storage accumulator: uint8 [S, W, H] for
    ram, [S, 84, 84] for images) and ``state``."""
    sample = np.asarray(sample, np.int64)
    g = Games(config, len(sample), uniform_pieces)
    every = np.ones(len(sample), bool)
    key, draw = threefry.split(threefry.key_from_seed(seed))
    g.clear(every, threefry.bits([draw], sample)[0])
    out = []
    for acts in calls:
        T = len(acts)
        key, draws = _draw_keys(key, T, 2)
        spawn = threefry.bits(draws[:, 0], sample)
        again = threefry.bits(draws[:, 1], sample)
        total = np.zeros(g.board.shape, np.int64)
        reward = np.zeros((T, len(sample)), np.float32)
        done = np.zeros((T, len(sample)), bool)
        for t in range(T):
            emitted, reward[t], done[t] = g.step(acts[t], spawn[t])
            g.clear(done[t], again[t])
            emitted[done[t]] = 0
            total += emitted
        if config.get("obs_type", "ram") == "ram":
            acc = total % 256
        else:
            acc = raster.image(np.swapaxes(total, 1, 2), OBS_SIZE, T) % 256
        out.append(dict(reward=reward, done=done, acc=acc.astype(np.uint8),
                        state=state(g, key)))
    return out


def gym(config: dict, seed: int, calls, uniform_pieces=False):
    """Replay the gym shim on ``calls``: ``("reset",)`` or ``("step",
    action)``. Returns per call a dict: ``obs`` and, for a step,
    ``reward`` (float), ``done`` (bool) and ``info`` (the reference's info
    dict)."""
    g = Games(config, 1, uniform_pieces)
    key = threefry.key_from_seed(seed)
    one = np.ones(1, bool)
    out = []
    for call in calls:
        key, draw = threefry.split(key)
        bits = threefry.bits([draw], [0])[0]
        if call[0] == "reset":
            g.clear(one, bits)
            out.append(dict(obs=observation(config, g.board.copy())[0]))
            continue
        emitted, reward, done = g.step([call[1]], bits)
        out.append(dict(obs=observation(config, emitted)[0],
                        reward=float(reward[0]), done=bool(done[0]),
                        info=_info(g)))
    return out


def _info(g: Games) -> dict:
    return {"time": int(g.time[0]), "current_piece": PIECE_NAMES[g.piece[0]],
            "score": int(g.score[0]), "lines_cleared": int(g.lines[0]),
            "holes": int(g.holes[0]), "deaths": int(g.deaths[0]),
            "statistics": {n: int(c) for n, c in zip(PIECE_NAMES, g.counts[0])}}


def _vector_info(g: Games) -> dict:
    return {"time": g.time.copy(), "current_piece": g.piece.copy(),
            "score": g.score.copy(), "lines_cleared": g.lines.copy(),
            "holes": g.holes.copy(), "deaths": g.deaths.copy(),
            "statistics": g.counts.copy()}


_GAME_ARRAYS = ("board", "shape", "piece", "ax", "ay", "lock", "time",
                "score", "holes", "lines", "piece_height", "deaths", "counts")


def vector(config: dict, n: int, seed: int, calls, obs_envs,
           uniform_pieces=False):
    """Replay the vector core of ``n`` envs: ``reset()`` then a step per
    action array [n] of ``calls``. Returns (reset dict of ``obs`` for the
    envs ``obs_envs`` and ``info``; per step a dict of ``reward``,
    ``terminated``, ``info`` and ``obs`` of the envs ``obs_envs``; the
    last step's also ``obs_all``, every env's observation)."""
    g = Games(config, n, uniform_pieces)
    envs = np.arange(n)
    key = threefry.fold_in(threefry.key_from_seed(seed), 0)
    key, draw = threefry.split(key)
    g.clear(np.ones(n, bool), threefry.bits([draw], envs)[0])
    first = dict(obs=observation(config, g.board[obs_envs]),
                 info=_vector_info(g))
    pending = np.zeros(n, bool)
    out = []
    for acts in calls:
        key, draw = threefry.split(key)
        bits = threefry.bits([draw], envs)[0]
        before = {f: getattr(g, f).copy() for f in _GAME_ARRAYS}
        emitted, reward, term = g.step(acts, bits)
        for f, v in before.items():
            keep = pending.reshape((n,) + (1,) * (v.ndim - 1))
            setattr(g, f, np.where(keep, v, getattr(g, f)))
        g.clear(pending, bits)
        emitted[pending] = 0
        reward = np.where(pending, np.float32(0), reward)
        term = np.where(pending, False, term)
        out.append(dict(reward=reward, terminated=term, info=_vector_info(g),
                        obs=observation(config, emitted[obs_envs])))
        pending = term
    if out:
        out[-1]["obs_all"] = observation(config, emitted)
    return first, out
