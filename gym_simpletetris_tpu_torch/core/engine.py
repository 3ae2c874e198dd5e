"""Batched Tetris transition engine in plain PyTorch.

A port of ``gym_simpletetris_tpu.core.engine``: the same functions, the same
batch-minor layout and the same bits. It is the CPU path of the port and the
oracle that the CUDA step kernel (``csrc/step.cu``) is held to. The one-hot
contractions the JAX engine needs on the TPU become plain indexing here.

Layout: board rows are ``[H, B]`` for single-word boards and ``[H, NW, B]``
for wide ones (global bit ``x + XSHIFT`` in word ``(x + XSHIFT) // 32``), as
in the state. Inside, everything is word form with the word axis just before
the batch axis: rows ``[H, NW, B]``, piece masks ``[NROWS, NW, B]``. Every
bit operation extends word by word; the one cross-word operation is the
piece-mask placement (a two-word funnel shift, ``piece_masks``).

``engine_step`` dispatches on the state's device: a CUDA state goes to the
step kernel (``ops/cuda_step.py``), a CPU state to the plain body below;
``spawn_draw`` likewise to the draw kernel (``ops/cuda_draw.py``) or to
``spawn_draw_plain``; ``engine_clear`` to the reset kernel
(``ops/cuda_reset.py``) or to ``clear_plain``. ``engine_step_plain`` and
``engine_clear_plain`` run the plain bodies and the plain draw on any
device.

Words are int32 tensors holding uint32 bits. A right shift copies bit 31 down,
so every ``>>`` of a board word is masked; masks reach bit 31 at width 24 and
in the words of wide boards. Per-word column masks come from
``EnvConfig.valid_words`` (int32, a full word is -1), never from the Python
int ``valid_mask``, which is wider than 32 bits for wide boards.

Behaviour pinned by the reference (see the JAX engine's docstring): cells with
``y < 0`` skip all collision checks, x-bounds included; gravity adds one soft
drop after every action; the lock counter wraps modulo ``lock_delay + 1``; on
lock the piece burns in, full rows compact stably downward, the step is
scored, death (a cell in row 0) overwrites the reward with -100 and spawns
nothing; holes are recomputed only at lock; the persistent board is kept
piece-erased (``rows_after & ~piece``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import EnvConfig, XSHIFT
from .pieces import ROWMASKS_FLAT, NROWS, DY_OFF
from .state import EnvState
from . import threefry
from ..ops.bitops import unpack_cells
from ..utils.profiling import count, span

_I32 = torch.int32

# NES line-clear score table.
_SCORES_TAB = (0, 40, 100, 300, 1200)

# Action ids (value_action_map).
A_LEFT, A_RIGHT, A_HARD, A_SOFT, A_ROTL, A_ROTR, A_IDLE = range(7)
NUM_ACTIONS = 7

# [29, NROWS]: the 28 (piece, rot) masks plus a zero row that any index
# outside [0, 28) selects, as the JAX one-hot lookup yields zeros there.
_MASK_TABLE = np.concatenate(
    [ROWMASKS_FLAT.astype(np.int32), np.zeros((1, NROWS), np.int32)])


class StepOut(NamedTuple):
    state: EnvState
    emitted_rows: torch.Tensor  # int32[H, B] / [H, NW, B]: piece burned in
    reward: torch.Tensor        # float32[B]
    done: torch.Tensor          # bool[B]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(mask table int32[29, NROWS], NES score table int32[5]) on ``device``."""
    return (torch.as_tensor(_MASK_TABLE, device=device),
            torch.tensor(_SCORES_TAB, dtype=_I32, device=device))


@functools.lru_cache(maxsize=None)
def _word_masks(cfg: EnvConfig, device: torch.device) -> torch.Tensor:
    """int32[NW, 1]: each word's in-board column bits, batch axis ready."""
    return torch.as_tensor(cfg.valid_words(), device=device)[:, None]


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _to_words(rows: torch.Tensor) -> torch.Tensor:
    """State-layout rows -> word form [H, NW, B]."""
    return rows[:, None, :] if rows.dim() == 2 else rows


def _from_words(cfg: EnvConfig, rows_w: torch.Tensor) -> torch.Tensor:
    """Word form -> state layout ([H, B] when NW == 1)."""
    return rows_w[:, 0, :] if cfg.num_words == 1 else rows_w


# ------------------------------------------------------------------ piece masks

def piece_masks(cfg: EnvConfig, piece: torch.Tensor, rot: torch.Tensor,
                ax: torch.Tensor, rot_delta: int = 0) -> torch.Tensor:
    """Absolute per-relative-row bitmasks, word form: int32[NROWS, NW, B].
    Relative row k covers board row ``ay + k - DY_OFF``; global bit
    ``x + XSHIFT`` is column x. The table's bits are ``dx + 3``, so the
    anchor shift is ``s = ax + XSHIFT - 3``; word w takes the funnel-shifted
    slice ``(m << (s - 32w)) | (m >> (32w - s))``, shifts out of range
    masked (a single word takes ``m << s`` for 0 <= s < 32, else nothing)."""
    pr = piece * 4 + (rot + rot_delta) % 4
    pr = torch.where((pr >= 0) & (pr < 28), pr, 28)
    m = _tables(piece.device)[0][pr.long()].T                 # [NROWS, B]
    s = (ax + (XSHIFT - 3))[None, :]
    if cfg.num_words == 1:
        ok = (s >= 0) & (s < 32)
        return torch.where(ok, m << s.clamp(0, 31), 0)[:, None, :]
    words = []
    for w in range(cfg.num_words):
        d = s - 32 * w
        lv = torch.where((d >= 0) & (d < 32), m << d.clamp(0, 31), 0)
        # m < 128, so the int32 right shift brings no sign bits down
        rv = torch.where((d < 0) & (d > -32), m >> (-d).clamp(0, 31), 0)
        words.append(lv | rv)
    return torch.stack(words, dim=1)


def pad_rows(rows: torch.Tensor) -> torch.Tensor:
    """Zero rows (either layout): DY_OFF above the board, NROWS - DY_OFF
    below."""
    z = lambda n: rows.new_zeros((n,) + tuple(rows.shape[1:]))
    return torch.cat([z(DY_OFF), rows, z(NROWS - DY_OFF)], dim=0)


# -------------------------------------------------------------------- collision

def extract_window(cfg: EnvConfig, rows: torch.Tensor,
                   ay: torch.Tensor) -> torch.Tensor:
    """Board rows at y = ay-3 .. ay+3 per env, zeros outside, word form:
    int32[NROWS, NW, B]. ``rows`` in either layout."""
    H = cfg.height
    rows_w = _to_words(rows)
    y = ay[None, :] + (_iota(NROWS, rows.device)[:, None] - DY_OFF)
    inb = ((y >= 0) & (y < H))[:, None, :]
    idx = y.clamp(0, H - 1).long()[:, None, :].expand(-1, rows_w.shape[1], -1)
    return torch.where(inb, torch.gather(rows_w, 0, idx), 0)


def _collide_terms(cfg: EnvConfig, y: torch.Tensor, board: torch.Tensor,
                   m: torch.Tensor) -> torch.Tensor:
    """``is_occupied`` for mask rows m [..., NW, B] at board rows y [..., B]
    over board words [..., NW, B]: skip if y < 0 (before any x check), else
    collide on a cell outside the columns, a non-empty row at y >= H, or an
    overlap."""
    xo = ((m & ~_word_masks(cfg, m.device)) != 0).any(dim=-2)
    nonempty = (m != 0).any(dim=-2)
    hit = ((board & m) != 0).any(dim=-2)
    return (y >= 0) & (xo | ((y >= cfg.height) & nonempty) | hit)


def collide_window(cfg: EnvConfig, window: torch.Tensor, masks: torch.Tensor,
                   ay: torch.Tensor) -> torch.Tensor:
    """Collision of C candidate mask sets at one anchor row: bool[C, B].
    window: int32[NROWS, NW, B]; masks: int32[C, NROWS, NW, B]; ay: int32[B]."""
    y = ay[None, None, :] + (_iota(NROWS, ay.device)[None, :, None] - DY_OFF)
    return _collide_terms(cfg, y, window[None], masks).any(dim=1)


def collide_profile(cfg: EnvConfig, rows_pad: torch.Tensor,
                    masks: torch.Tensor) -> torch.Tensor:
    """Collision of one mask set (int32[NROWS, NW, B]) at every anchor row
    0..H: bool[H+1, B]. ``rows_pad``: padded rows, either layout.
    ``profile[H]`` is always True (the anchor cell at y = H is out of
    bounds), so drop distances are well defined."""
    H = cfg.height
    rp = _to_words(rows_pad)
    yp = _iota(H + 1, masks.device)[:, None]
    coll = torch.zeros((H + 1, masks.shape[-1]), dtype=torch.bool,
                       device=masks.device)
    for k in range(NROWS):
        coll |= _collide_terms(cfg, yp + (k - DY_OFF), rp[k:k + H + 1],
                               masks[k][None])
    return coll


def profile_at(prof: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """prof[idx[b], b] -> bool[B]; False where idx is outside the profile."""
    n = prof.shape[0]
    inb = (idx >= 0) & (idx < n)
    v = torch.gather(prof, 0, idx.clamp(0, n - 1).long()[None, :])[0]
    return v & inb


def _place_bits_w(cfg: EnvConfig, masks: torch.Tensor,
                  ay: torch.Tensor) -> torch.Tensor:
    """Burn a piece into an empty board, word form: int32[H, NW, B]. Cells
    outside the board are dropped, like the reference's per-cell bounds
    check."""
    rel = (_iota(cfg.height, masks.device)[:, None] - ay[None, :]
           + DY_OFF)[:, None, :]                              # [H, 1, B]
    valid = _word_masks(cfg, masks.device)
    pb = torch.zeros((cfg.height,) + tuple(masks.shape[1:]), dtype=_I32,
                     device=masks.device)
    for k in range(NROWS):
        pb |= torch.where(rel == k, (masks[k] & valid)[None], 0)
    return pb


def place_bits(cfg: EnvConfig, masks: torch.Tensor,
               ay: torch.Tensor) -> torch.Tensor:
    """``_place_bits_w`` in the state layout ([H, B] when NW == 1)."""
    return _from_words(cfg, _place_bits_w(cfg, masks, ay))


# ---------------------------------------------------------------- board queries

def count_holes(cfg: EnvConfig, rows: torch.Tensor) -> torch.Tensor:
    """Empty cells with a filled cell anywhere above them: int32[B]. The
    prefix OR is per column, so it runs on the unpacked cells."""
    cells = unpack_cells(cfg, rows, dtype=_I32)               # [H, W, B]
    above = torch.cummax(cells, dim=0).values
    return ((1 - cells) & above).sum(dim=(0, 1)).to(_I32)


def nonempty_rows(cfg: EnvConfig, rows: torch.Tensor) -> torch.Tensor:
    """Count of rows with any filled cell (the reference's "height")."""
    rows_w = _to_words(rows)
    return ((rows_w & _word_masks(cfg, rows.device)) != 0).any(dim=1) \
        .sum(dim=0).to(_I32)


def _clear_lines_w(cfg: EnvConfig, rows_w: torch.Tensor):
    """Full-row removal with stable downward compaction, word form: each kept
    row i lands at ``i + (#full rows below i)``; a row is full when every
    word holds all its in-board bits. Returns (rows, n_full int32[B])."""
    H, NW, B = rows_w.shape
    valid = _word_masks(cfg, rows_w.device)
    full = ((rows_w & valid) == valid).all(dim=1)             # [H, B]
    n_full = full.sum(dim=0).to(_I32)
    below = n_full[None, :] - torch.cumsum(full.to(_I32), dim=0)
    dest = _iota(H, rows_w.device)[:, None] + below
    dest = torch.where(full, H, dest)                         # full rows -> spill
    idx = dest.long()[:, None, :].expand(-1, NW, -1)
    out = rows_w.new_zeros((H + 1, NW, B)).scatter(0, idx, rows_w)
    return out[:H], n_full


def clear_lines(cfg: EnvConfig, rows: torch.Tensor):
    """``_clear_lines_w`` in the state layout."""
    out, n_full = _clear_lines_w(cfg, _to_words(rows))
    return _from_words(cfg, out), n_full


# ---------------------------------------------------------------------- sampler

def sample_piece(counts: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Count-balanced piece choice: weights m[i] = 5 + max(counts) -
    counts[i]; piece = #{i : cumsum(m)[i] < r} for r in [1, sum(m)]."""
    m = 5 + counts.max(dim=0, keepdim=True).values - counts
    c = torch.cumsum(m, dim=0)
    return (c < r[None, :]).sum(dim=0).to(_I32)


def piece_weight_sum(counts: torch.Tensor) -> torch.Tensor:
    m = 5 + counts.max(dim=0, keepdim=True).values - counts
    return m.sum(dim=0).to(_I32)


def spawn_draw_plain(state: EnvState,
                     injected_r: Optional[torch.Tensor] = None):
    """``spawn_draw`` in plain PyTorch on any device: ``threefry.split`` and
    ``threefry.draw_spawn_r`` (the draw kernel's oracle)."""
    carry_key, draw_key = threefry.split(state.key)
    if injected_r is None:
        r = threefry.draw_spawn_r(draw_key, state.shape_counts,
                                  state.env_offset)
    else:
        r = torch.as_tensor(injected_r, device=state.device).to(_I32)
    return carry_key, r.contiguous()


@span("engine.draw")
def spawn_draw(state: EnvState, injected_r: Optional[torch.Tensor] = None):
    """Advance the engine key and take this step's spawn draws:
    (carry key, r int32[B]), for the envs from ``state.env_offset`` of the
    global batch. ``injected_r`` replaces the threefry draws. A CUDA state
    goes to the draw kernel (``ops/cuda_draw.py``), any other to
    ``spawn_draw_plain``. Counted as ``engine.draws``."""
    count("engine.draws")
    if state.key.is_cuda:
        from ..ops.cuda_draw import draw
        return draw(state.key, state.shape_counts, state.env_offset,
                    injected_r)
    return spawn_draw_plain(state, injected_r)


# ------------------------------------------------------------------------- step

def candidate_collisions(cfg: EnvConfig, rows, piece, rot, ax, ay):
    """Collision of the four in-place move candidates (left, right,
    rotate-left, rotate-right) at the current anchor row."""
    win = extract_window(cfg, rows, ay)
    cand = torch.stack([
        piece_masks(cfg, piece, rot, ax - 1),
        piece_masks(cfg, piece, rot, ax + 1),
        piece_masks(cfg, piece, rot, ax, rot_delta=-1),
        piece_masks(cfg, piece, rot, ax, rot_delta=+1),
    ], dim=0)
    c4 = collide_window(cfg, win, cand, ay)
    return c4[0], c4[1], c4[2], c4[3]


def transition_plain(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
                     r_draw: torch.Tensor, key: torch.Tensor) -> StepOut:
    """One batched transition given this step's spawn draws ``r_draw`` and the
    advanced key. Operation order tracks the reference's ``step``."""
    H = cfg.height
    piece, rot, ax, ay, lock = (state.piece, state.rot, state.ax, state.ay,
                                state.lock)
    rows = _to_words(state.rows)                              # [H, NW, B]
    action = action.to(_I32)
    dev = rows.device

    c_left, c_right, c_rotl, c_rotr = candidate_collisions(
        cfg, rows, piece, rot, ax, ay)
    is_h, is_s = action == A_HARD, action == A_SOFT
    ax1 = (ax - ((action == A_LEFT) & ~c_left).to(_I32)
           + ((action == A_RIGHT) & ~c_right).to(_I32))
    rot1 = (rot - ((action == A_ROTL) & ~c_rotl).to(_I32)
            + ((action == A_ROTR) & ~c_rotr).to(_I32)) % 4

    # one dense collision profile at the post-action pose: soft drop, hard
    # drop, gravity and the resting check all read it
    masks1 = piece_masks(cfg, piece, rot1, ax1)
    coll = collide_profile(cfg, pad_rows(rows), masks1)
    c_soft = profile_at(coll, ay + 1)
    idxs = _iota(H + 1, dev)[:, None]
    blocked = torch.where((idxs > ay[None, :]) & coll, idxs, H + 2)
    ay_hard = blocked.min(dim=0).values - 1
    ay1 = torch.where(is_h, ay_hard, torch.where(is_s & ~c_soft, ay + 1, ay))

    # gravity: one extra soft drop every step
    ay2 = ay1 + (~profile_at(coll, ay1 + 1)).to(_I32)
    lock0 = torch.where(ay2 != ay1, 0, lock) if cfg.step_reset else lock
    reward = torch.full(ay.shape, 1.0 if cfg.reward_step else 0.0,
                        dtype=torch.float32, device=dev)

    # lock-delay FSM
    resting = profile_at(coll, ay2 + 1)
    lock1 = torch.where(resting, (lock0 + 1) % cfg.lock_modulus, lock0)
    locked = resting & (lock1 == 0)

    # lock: burn piece, clear lines, score, death, penalties
    lk = locked[None, None, :]
    rows_locked = rows | torch.where(lk, _place_bits_w(cfg, masks1, ay2), 0)
    rows_cleared, n_full = _clear_lines_w(cfg, rows_locked)
    n_clear = torch.where(locked, n_full, 0)
    rows_after = torch.where(lk, rows_cleared, rows)

    if cfg.advanced_clears:
        sc = torch.where(n_clear <= 4,
                         _tables(dev)[1][n_clear.clamp(0, 4).long()], 0)
        reward = reward + 2.5 * sc.to(torch.float32)
        score_inc = sc
    elif cfg.high_scoring:
        reward = reward + 1000.0 * n_clear.to(torch.float32)
        score_inc = n_clear
    else:
        reward = reward + 100.0 * n_clear.to(torch.float32)
        score_inc = n_clear

    death = locked & ((rows_after[0] & _word_masks(cfg, dev)) != 0).any(dim=0)
    alive_lock = locked & ~death
    holes_new = count_holes(cfg, rows_after)
    f32 = lambda c, v: torch.where(c, v, 0).to(torch.float32)

    piece_height_next = state.piece_height
    if cfg.penalise_height:
        reward = reward - f32(alive_lock, nonempty_rows(cfg, rows_after))
    elif cfg.penalise_height_increase:
        nh = nonempty_rows(cfg, rows_after)
        inc = nh - state.piece_height
        reward = reward - f32(alive_lock & (inc > 0), 10 * inc)
        piece_height_next = torch.where(alive_lock, nh, state.piece_height)
    if cfg.penalise_holes:
        reward = reward - f32(alive_lock, 5 * holes_new)
    elif cfg.penalise_holes_increase:
        reward = reward - f32(alive_lock, 5 * (holes_new - state.holes))
    # death overwrites everything accumulated this step
    reward = torch.where(death, -100.0, reward)

    # spawn, only on an alive lock
    piece_new = sample_piece(state.shape_counts, r_draw)
    piece_next = torch.where(alive_lock, piece_new, piece)
    rot_next = torch.where(alive_lock, 0, rot1)
    ax_next = torch.where(alive_lock, cfg.spawn_x, ax1)
    ay_next = torch.where(alive_lock, 0, ay2)
    spawn_oh = _iota(7, dev)[:, None] == piece_new[None, :]
    counts_next = state.shape_counts + (alive_lock[None, :] & spawn_oh).to(_I32)

    # emit: burn piece, copy, erase (the spawn-overlap and death erase quirks)
    pb_emit = _place_bits_w(
        cfg, piece_masks(cfg, piece_next, rot_next, ax_next), ay_next)
    new_state = state.replace(
        rows=_from_words(cfg, rows_after & ~pb_emit), piece=piece_next, rot=rot_next,
        ax=ax_next, ay=ay_next, lock=lock1, time=state.time + 1,
        score=state.score + torch.where(locked, score_inc, 0),
        holes=torch.where(locked, holes_new, state.holes),
        lines_cleared=state.lines_cleared + n_clear,
        piece_height=piece_height_next, deaths=state.deaths + death.to(_I32),
        shape_counts=counts_next, key=key)
    return StepOut(new_state, _from_words(cfg, rows_after | pb_emit), reward,
                   death)


def engine_step_plain(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
                      injected_r: Optional[torch.Tensor] = None) -> StepOut:
    """The plain PyTorch transition on any device, its draw included (the
    kernels' oracle)."""
    key, r = spawn_draw_plain(state, injected_r)
    return transition_plain(cfg, state, action, r, key)


def engine_step(cfg: EnvConfig, state: EnvState, action: torch.Tensor,
                injected_r: Optional[torch.Tensor] = None) -> StepOut:
    """One batched transition: the CUDA step kernel for a CUDA state, the
    plain body for a CPU state. ``injected_r``: optional int32[B] of raw
    ``randint(1, sum(m))`` draws (ignored where nothing spawns)."""
    from ..ops.cuda_step import step
    key, r = spawn_draw(state, injected_r)
    action = torch.as_tensor(action, device=state.device).to(_I32).contiguous()
    return step(cfg, state, action, r, key)


def clear_plain(cfg: EnvConfig, state: EnvState, r: torch.Tensor,
                key: torch.Tensor):
    """``engine_clear``'s body in plain PyTorch with the spawn draws ``r``
    and the carry ``key`` given: (state, emitted rows)."""
    piece_new = sample_piece(state.shape_counts, r)
    spawn_oh = _iota(7, state.device)[:, None] == piece_new[None, :]
    zeros = torch.zeros_like(state.time)
    rows0 = torch.zeros_like(state.rows)
    new_state = state.replace(
        rows=rows0, piece=piece_new, rot=zeros,
        ax=torch.full_like(state.ax, cfg.spawn_x), ay=zeros, time=zeros,
        score=zeros, holes=zeros, lines_cleared=zeros, piece_height=zeros,
        shape_counts=state.shape_counts + spawn_oh.to(_I32), key=key)
    return new_state, rows0


def engine_clear_plain(cfg: EnvConfig, state: EnvState,
                       injected_r: Optional[torch.Tensor] = None):
    """The plain PyTorch episode reset on any device, its draw included
    (the reset kernel's oracle)."""
    key, r = spawn_draw_plain(state, injected_r)
    return clear_plain(cfg, state, r, key)


@span("engine.clear")
def engine_clear(cfg: EnvConfig, state: EnvState,
                 injected_r: Optional[torch.Tensor] = None):
    """Episode reset (``TetrisEngine.clear``): zero the board and the
    per-episode counters and spawn a piece, carrying over the lock counter,
    deaths and shape counts. Returns (state, emitted rows): the reset
    observation is the empty board, without the spawned piece. A CUDA state
    goes to the reset kernel (``ops/cuda_reset.py``) with no mask, a CPU
    state to ``clear_plain``."""
    key, r = spawn_draw(state, injected_r)
    if state.rows.is_cuda:
        from ..ops.cuda_reset import reset
        return reset(cfg, state, r, key)
    return clear_plain(cfg, state, r, key)


def render_rows(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """Board with the active piece burned in (``TetrisEngine.render``)."""
    m = piece_masks(cfg, state.piece, state.rot, state.ax)
    return state.rows | place_bits(cfg, m, state.ay)


def valid_action_count(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """Number of actions that would change (shape, anchor): rotations and
    sideways moves count iff unobstructed; soft and hard drop each count iff
    one soft drop is possible; idle never counts."""
    c4 = torch.stack(candidate_collisions(
        cfg, state.rows, state.piece, state.rot, state.ax, state.ay), dim=0)
    win_dn = extract_window(cfg, state.rows, state.ay + 1)
    m_cur = piece_masks(cfg, state.piece, state.rot, state.ax)
    c_soft = collide_window(cfg, win_dn, m_cur[None], state.ay + 1)[0]
    return ((~c4).sum(dim=0) + 2 * (~c_soft).to(_I32)).to(_I32)
