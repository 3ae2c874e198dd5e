"""The reference game in plain NumPy: N independent SimpleTetris engines.

Written from the reference's ``TetrisEngine`` (gym-simpletetris,
``gym_simpletetris/envs/tetris_env.py:125-335``, as SURVEY.md §2.2-2.3
spells it out): dense ``board[x, y]`` per game (row 0 at the top), the piece
as its list of four (dx, dy) offsets turned by the reference's two rotation
maps, per-cell collision tests in which cells above the board skip every
check, hard drop as soft drops to a fixpoint, gravity after every action,
the lock-delay counter modulo ``lock_delay + 1``, line clears by a bottom-up
row copy, the scoring table, death with its -100 overwrite and no spawn,
holes recounted only at lock, the count-balanced spawn sampler, and the
emitted board (piece burned in, then erased from the kept board: the
death-erase and spawn-overlap quirks).

The only departure from the reference is the source of the spawn draw: the
caller passes the 32 random bits of each game's draw (``threefry.bits``),
and ``r = 1 + bits mod sum(m)``. ``uniform_pieces=True`` is the control of
the benchmark: it breaks the count-balanced sampler (the piece is ``bits mod
7``), the guarantee a faster sampler would be tempted to drop.

Games are vectorized over the leading axis; every step acts on all of them.
Imports nothing but NumPy.
"""

from __future__ import annotations

import numpy as np

PIECE_NAMES = ("T", "J", "L", "Z", "S", "I", "O")
BASE = np.array([
    [(0, 0), (-1, 0), (1, 0), (0, -1)],     # T
    [(0, 0), (-1, 0), (0, -1), (0, -2)],    # J
    [(0, 0), (1, 0), (0, -1), (0, -2)],     # L
    [(0, 0), (-1, 0), (0, -1), (1, -1)],    # Z
    [(0, 0), (-1, -1), (0, -1), (1, 0)],    # S
    [(0, 0), (0, -1), (0, -2), (0, -3)],    # I
    [(0, 0), (0, -1), (-1, 0), (-1, -1)],   # O
], dtype=np.int64)
_PAD = 8          # every offset and one move lie within 8 cells of the board
NES_SCORES = np.array([0, 40, 100, 300, 1200], dtype=np.int64)
LEFT, RIGHT, HARD, SOFT, ROT_LEFT, ROT_RIGHT, IDLE = range(7)
FLAGS = ("reward_step", "penalise_height", "penalise_height_increase",
         "advanced_clears", "high_scoring", "penalise_holes",
         "penalise_holes_increase", "step_reset")


def rotate_right(shape: np.ndarray) -> np.ndarray:
    """``rotated(shape, cclk=True)``: (i, j) -> (-j, i)."""
    return np.stack([-shape[..., 1], shape[..., 0]], axis=-1)


def rotate_left(shape: np.ndarray) -> np.ndarray:
    """``rotated(shape, cclk=False)``: (i, j) -> (j, -i)."""
    return np.stack([shape[..., 1], -shape[..., 0]], axis=-1)


def _turns() -> np.ndarray:
    """[7, 4, 4, 2]: each piece's offsets after k right turns."""
    out = [BASE]
    for _ in range(3):
        out.append(rotate_right(out[-1]))
    return np.stack(out, axis=1)


TURNS = _turns()


class Games:
    """N games of one configuration (the reference env's kwargs: width,
    height, the seven reward flags, lock_delay, step_reset). A fresh
    engine: empty board, time and score -1, no piece until ``clear``."""

    def __init__(self, config: dict, n: int, uniform_pieces: bool = False):
        self.W = int(config.get("width", 10))
        self.H = int(config.get("height", 20))
        self.flags = {f: bool(config.get(f, False)) for f in FLAGS}
        self.lock_mod = max(int(config.get("lock_delay", 0)), 0) + 1
        self.uniform_pieces = uniform_pieces
        self.n = n
        z = lambda: np.zeros(n, np.int64)
        self.board = np.zeros((n, self.W, self.H), np.uint8)
        self.shape = np.zeros((n, 4, 2), np.int64)
        self.piece, self.ax, self.ay, self.lock = z(), z(), z(), z()
        self.time, self.score = z() - 1, z() - 1
        self.holes, self.lines, self.piece_height, self.deaths = z(), z(), z(), z()
        self.counts = np.zeros((n, 7), np.int64)
        self._rows = np.arange(n)[:, None]

    # -- the reference's helpers ---------------------------------------------
    def grid(self) -> np.ndarray:
        """What ``is_occupied`` reads, per game: bool [n, W + 2P, 2H + 2P],
        cell (x, y) at (x + P, y + P). Rows above the board (y < 0) read
        empty whatever x, as the reference skips such a cell before any
        other test; columns outside the board and rows below it read
        filled."""
        n, W, H, P = self.n, self.W, self.H, _PAD
        g = np.ones((n, W + 2 * P, 2 * H + 2 * P), bool)
        g[:, :, :P] = False
        g[:, P:P + W, P:P + H] = self.board != 0
        return g

    def occupied(self, grid, shape, x0, y0) -> np.ndarray:
        """``is_occupied`` per game, at anchors x0 [n], y0 [n] or [n, K]
        (then bool [n, K])."""
        xs = x0[:, None] + shape[..., 0] + _PAD
        rows = np.arange(len(x0))[:, None]
        if np.ndim(y0) == 2:
            ys = y0[..., None] + shape[..., 1][:, None, :] + _PAD
            return grid[rows[:, :, None], xs[:, None, :], ys].any(-1)
        return grid[rows, xs, y0[:, None] + shape[..., 1] + _PAD].any(-1)

    def set_piece(self, on: bool, mask=None) -> None:
        """``_set_piece``: write the piece's in-board cells (1 or 0), each
        cell bounds-checked on its own."""
        xs = self.ax[:, None] + self.shape[..., 0]
        ys = self.ay[:, None] + self.shape[..., 1]
        ok = (xs >= 0) & (xs < self.W) & (ys >= 0) & (ys < self.H)
        if mask is not None:
            ok &= mask[:, None]
        n = np.broadcast_to(self._rows, xs.shape)
        self.board[n[ok], xs[ok], ys[ok]] = 1 if on else 0

    def spawn(self, mask, draw_bits) -> None:
        """``_new_piece`` for the games in ``mask``: weights m[i] = 5 +
        max(counts) - counts[i]; r = 1 + bits mod sum(m); the piece is the
        first i at which the running ``r -= m[i]`` reaches 0 or less."""
        bits = np.asarray(draw_bits, dtype=np.uint64)
        if self.uniform_pieces:
            piece = (bits % 7).astype(np.int64)
        else:
            m = 5 + self.counts.max(axis=1, keepdims=True) - self.counts
            r = 1 + (bits % m.sum(axis=1).astype(np.uint64)).astype(np.int64)
            piece = ((r[:, None] - np.cumsum(m, axis=1)) > 0).sum(axis=1)
        self.piece = np.where(mask, piece, self.piece)
        self.counts[np.arange(self.n)[mask], piece[mask]] += 1
        self.shape = np.where(mask[:, None, None], BASE[piece], self.shape)
        self.ax = np.where(mask, self.W // 2, self.ax)
        self.ay = np.where(mask, 0, self.ay)

    def clear(self, mask, draw_bits) -> None:
        """``TetrisEngine.clear`` for the games in ``mask``: the episode's
        counters to 0, a new piece, an empty board. The lock counter, deaths
        and piece counts carry over."""
        for f in ("time", "score", "holes", "lines", "piece_height"):
            setattr(self, f, np.where(mask, 0, getattr(self, f)))
        self.spawn(mask, draw_bits)
        self.board[mask] = 0

    def count_holes(self, games) -> np.ndarray:
        """Empty cells with a filled cell above them in their column, for
        the games ``games`` (indices)."""
        filled = self.board[games] != 0
        above = np.maximum.accumulate(filled, axis=2)
        return (above & ~filled).sum(axis=(1, 2))

    def nonempty_rows(self) -> np.ndarray:
        return (self.board != 0).any(axis=1).sum(axis=1)

    def clear_lines(self, mask) -> np.ndarray:
        """``_clear_lines`` for the games in ``mask``: full rows removed,
        the rest copied down in order. Returns the rows cleared."""
        full = (self.board != 0).all(axis=1) & mask[:, None]      # [n, H]
        n_full = full.sum(axis=1)
        if not n_full.any():
            return n_full
        order = np.argsort(full, axis=1, kind="stable")       # kept rows first
        j = np.arange(self.H)[None, :]
        src = np.take_along_axis(order, (j - n_full[:, None]) % self.H, axis=1)
        moved = np.take_along_axis(self.board, np.broadcast_to(
            src[:, None, :], self.board.shape), axis=2)
        moved[np.broadcast_to((j < n_full[:, None])[:, None, :],
                              moved.shape)] = 0
        self.board = np.where(mask[:, None, None], moved, self.board)
        return n_full

    # -- one step -------------------------------------------------------------
    def step(self, action, draw_bits):
        """``TetrisEngine.step`` on every game. Returns (emitted board
        uint8 [n, W, H], reward float32 [n], done bool [n])."""
        a = np.asarray(action, dtype=np.int64)
        f = self.flags
        g = self.grid()
        sh, ax, ay = self.shape, self.ax, self.ay
        for act, dx in ((LEFT, -1), (RIGHT, 1)):
            go = (a == act) & ~self.occupied(g, sh, ax + dx, ay)
            ax = np.where(go, ax + dx, ax)
        for act, turn in ((ROT_LEFT, rotate_left), (ROT_RIGHT, rotate_right)):
            turned = turn(sh)
            go = (a == act) & ~self.occupied(g, turned, ax, ay)
            sh = np.where(go[:, None, None], turned, sh)
        soft = (a == SOFT) & ~self.occupied(g, sh, ax, ay + 1)
        # hard drop: soft drops to the fixpoint, i.e. down to the row above
        # the first offset k >= 1 at which the piece collides (k = H + 1 at
        # the latest, where its anchor cell lies below the floor)
        ay = ay + soft
        hard = np.flatnonzero(a == HARD)
        if hard.size:
            k = np.arange(1, self.H + 2)
            hit = self.occupied(g[hard], sh[hard], ax[hard],
                                ay[hard, None] + k[None, :])
            ay[hard] += hit.argmax(axis=1)
        gravity = ~self.occupied(g, sh, ax, ay + 1)
        ay = ay + gravity
        if f["step_reset"]:
            self.lock = np.where(gravity, 0, self.lock)
        self.shape, self.ax, self.ay = sh, ax, ay
        self.time = self.time + 1
        reward = np.full(self.n, 1.0 if f["reward_step"] else 0.0)

        resting = self.occupied(g, sh, ax, ay + 1)
        self.lock = np.where(resting, (self.lock + 1) % self.lock_mod,
                             self.lock)
        locked = resting & (self.lock == 0)
        self.set_piece(True, locked)
        cleared = self.clear_lines(locked)
        self.lines = self.lines + cleared
        if f["advanced_clears"]:
            gain = NES_SCORES[cleared]
            reward = reward + 2.5 * gain
        elif f["high_scoring"]:
            gain = cleared
            reward = reward + 1000.0 * cleared
        else:
            gain = cleared
            reward = reward + 100.0 * cleared
        self.score = self.score + np.where(locked, gain, 0)
        dead = locked & (self.board[:, :, 0] != 0).any(axis=1)
        alive = locked & ~dead
        holes = np.zeros(self.n, np.int64)
        holes[locked] = self.count_holes(np.flatnonzero(locked))
        old_holes = self.holes
        self.holes = np.where(locked, holes, self.holes)
        self.deaths = self.deaths + dead
        if f["penalise_height"]:
            reward = reward - np.where(alive, self.nonempty_rows(), 0)
        elif f["penalise_height_increase"]:
            nh = self.nonempty_rows()
            up = alive & (nh > self.piece_height)
            reward = reward - np.where(up, 10.0 * (nh - self.piece_height), 0)
            self.piece_height = np.where(alive, nh, self.piece_height)
        if f["penalise_holes"]:
            reward = reward - np.where(alive, 5.0 * holes, 0)
        elif f["penalise_holes_increase"]:
            reward = reward - np.where(alive, 5.0 * (holes - old_holes), 0)
        reward = np.where(dead, -100.0, reward)
        self.spawn(alive, draw_bits)

        self.set_piece(True)
        emitted = self.board.copy()
        self.set_piece(False)
        return emitted, reward.astype(np.float32), dead

    # -- reading the state ------------------------------------------------------
    def turns(self) -> np.ndarray:
        """The right turns k in [0, 4) that give each game's offsets from
        its piece's base offsets."""
        same = (TURNS[self.piece] == self.shape[:, None]).all(axis=(2, 3))
        if not same.any(axis=1).all():
            raise AssertionError("a piece's offsets are no turn of its base")
        return same.argmax(axis=1)
