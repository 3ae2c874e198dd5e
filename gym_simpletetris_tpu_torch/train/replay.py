"""Replay rings of the DQN trainer (port of
``gym_simpletetris_tpu.train.replay``), with prioritized sampling: the
legacy ring of matured transitions, and the frame ring / obs ring of one
row per actor step (below ``FrameRingState``).

**Slot-major ring [S, B]**: B is the env batch (one actor step inserts one
slot row of B transitions at the ring pointer), S = capacity / B slots. A
transition's flat index is ``slot * B + env``. Observations are stored
flattened as uint8 (ram is 0/1, images {0, 128, 190}) and reshaped when a
batch is gathered. Each transition carries ``discount = gamma**m * (1 -
done)``, so the TD target is always ``reward + discount * Q(next_obs)``.

Prioritized replay (Schaul et al. 2015) is the two-level inverse CDF over
the [S, B] priority grid: level 1 picks the slot row from the cumulative
slot sums, level 2 the env within it; sampling is with replacement, so the
importance weights ``(N * P(i))**-beta`` are exact.

Unlike the functional JAX rings, the inserts and the priority updates
write into the ring's tensors in place (a copy of a ring of gigabytes per
step is not an option); the returned state shares them. Clone a state
before stepping it twice.

The draws are ``jax.random``'s (``core/threefry``), and the float32 sums
that pick the sampled indices follow XLA's CPU order, so a sample is the
JAX ring's bit for bit: row sums ``_sum_f32`` (XLA rewrites a reduce over
more than 32 elements into windows of 32), cumulative sums ``_cumsum_f32``
(a blocked scan), and ``x ** y`` ``_powf`` (XLA's CPU backend calls
glibc's ``powf``).
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import threefry
from ..utils.profiling import span


@dataclasses.dataclass
class ReplayState:
    obs: torch.Tensor           # uint8[S, B, prod(obs_shape)] (flattened)
    next_obs: torch.Tensor      # uint8[S, B, prod(obs_shape)]
    action: torch.Tensor        # int8[S, B]
    reward: torch.Tensor        # float32[S, B], the n-step return when n > 1
    discount: torch.Tensor      # float32[S, B], gamma**m * (1 - done)
    done: torch.Tensor          # bool[S, B]
    priority: torch.Tensor      # float32[S, B], p**alpha, 0 for empty slots
    max_p: torch.Tensor         # float32[], running max priority
    ptr: torch.Tensor           # int32[], next insert slot (row)
    filled_slots: torch.Tensor  # int32[], number of valid slot rows
    obs_shape: Tuple[int, ...] = ()

    @property
    def width(self) -> int:
        return self.obs.shape[1]

    @property
    def slots(self) -> int:
        return self.obs.shape[0]

    @property
    def capacity(self) -> int:
        return self.obs.shape[0] * self.obs.shape[1]

    @property
    def filled(self) -> torch.Tensor:
        """Number of valid transitions (every env row fills in lockstep)."""
        return self.filled_slots * self.width

    def replace(self, **kw) -> "ReplayState":
        return dataclasses.replace(self, **kw)


def replay_init(capacity: int, obs_shape: Tuple[int, ...], insert_width: int,
                device="cuda") -> ReplayState:
    if capacity % insert_width:
        raise ValueError(
            f"capacity {capacity} must be a multiple of the env batch "
            f"{insert_width} (each env owns capacity/B ring slots)")
    b, s = insert_width, capacity // insert_width
    f = math.prod(int(d) for d in obs_shape)
    z = lambda *shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return ReplayState(
        obs_shape=tuple(obs_shape),
        obs=z(s, b, f, dt=torch.uint8), next_obs=z(s, b, f, dt=torch.uint8),
        action=z(s, b, dt=torch.int8), reward=z(s, b, dt=torch.float32),
        discount=z(s, b, dt=torch.float32), done=z(s, b, dt=torch.bool),
        priority=z(s, b, dt=torch.float32),
        max_p=torch.ones((), dtype=torch.float32, device=device),
        ptr=z(dt=torch.int32), filled_slots=z(dt=torch.int32))


def replay_insert(rs: ReplayState, obs, next_obs, action, reward, done,
                  discount=None, *, gamma: float = None) -> ReplayState:
    """Write one env-batch slot row of B transitions at the ring pointer,
    in place. Exactly one of ``discount`` (precomputed, e.g. the n-step
    ``gamma**n * alive``) or ``gamma`` (the 1-step ``gamma * (1 - done)``)
    must be given. New rows get the running max priority."""
    b = obs.shape[0]
    if b != rs.width:
        raise ValueError(f"insert width {b} != ring width {rs.width}")
    if (discount is None) == (gamma is None):
        raise TypeError("pass exactly one of discount= or gamma=")
    if discount is None:
        discount = gamma * (1.0 - done.float())
    at = rs.ptr.long().view(1)
    for buf, val in ((rs.obs, obs.to(torch.uint8).reshape(b, -1)),
                     (rs.next_obs, next_obs.to(torch.uint8).reshape(b, -1)),
                     (rs.action, action.to(torch.int8)),
                     (rs.reward, reward.float()),
                     (rs.discount, discount.float()),
                     (rs.done, done.bool()),
                     (rs.priority, rs.max_p.expand(b))):
        buf.index_put_((at,), val[None])     # deterministic on the card
    return rs.replace(ptr=(rs.ptr + 1) % rs.slots,
                      filled_slots=torch.clamp(rs.filled_slots + 1,
                                               max=rs.slots))


def _take(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of the flattened [S * B, ...] view of a ring buffer."""
    return buf.reshape((-1,) + buf.shape[2:]).index_select(0, idx.long())


def _gather_batch(rs: ReplayState, idx: torch.Tensor) -> dict:
    """Flat transition indices (slot * B + env) -> the learner batch;
    observations stay uint8, reshaped to obs_shape."""
    obs = lambda buf: _take(buf, idx).reshape((idx.shape[0],) + rs.obs_shape)
    return {
        "obs": obs(rs.obs),
        "next_obs": obs(rs.next_obs),
        "action": _take(rs.action, idx).to(torch.int32),
        "reward": _take(rs.reward, idx),
        "discount": _take(rs.discount, idx),
        "done": _take(rs.done, idx),
    }


def replay_sample(rs: ReplayState, key: torch.Tensor, batch: int) -> dict:
    """Uniform sample of ``batch`` transitions from the filled region: a
    uniform valid slot and a uniform env."""
    slot, env, _ = sample_draw(rs, key, batch)
    return gather_rows(rs, slot, env)


def _recip_f32(c) -> float:
    """The float32 reciprocal of an integer constant: XLA rewrites ``x / c``
    for such a c into ``x * (1 / c)`` (measured; a division by a constant
    like 4.4 it keeps)."""
    return float(torch.tensor(1.0 / c, dtype=torch.float32))


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from 0 in index order."""
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _sum_f32(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """float32 sum over the last axis in XLA's CPU order: a reduce over
    more than ``window`` elements becomes a window-sum (zero padding split
    low / high, each window summed in order) and a reduce of the window
    sums, again and again."""
    while x.shape[-1] > window:
        n = x.shape[-1]
        nb = -(-n // window)
        pad = nb * window - n
        x = F.pad(x, (pad // 2, pad - pad // 2))
        x = _seq_sum(x.reshape(x.shape[:-1] + (nb, window)))
    return _seq_sum(x)


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    parts, acc = [], torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        parts.append(acc)
    return torch.stack(parts, dim=-1)


def _cumsum_f32(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """float32 inclusive cumulative sum over the last axis in XLA's CPU
    order (``jnp.cumsum``): blocks of ``base`` scanned in order, the block
    totals scanned the same way, each block's exclusive prefix added after.
    ``torch.cumsum`` runs in another order (1.2e-4 apart at n = 4096)."""
    n = x.shape[-1]
    if n <= base:
        return _seq_cumsum(x)
    nb = -(-n // base)
    inner = _seq_cumsum(F.pad(x, (0, nb * base - n))
                        .reshape(x.shape[:-1] + (nb, base)))
    outer = _cumsum_f32(inner[..., -1], base)
    excl = F.pad(outer[..., :-1], (1, 0))
    return (inner + excl[..., None]).reshape(x.shape[:-1] + (nb * base,))[..., :n]


# glibc's powf (its log2 table and polynomial, and exp2's): the f32 ``x**y``
# of XLA's CPU backend
_POWF_LOG2_TAB = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
)
_POWF_LOG2_POLY = tuple(float.fromhex(c) for c in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_POWF_EXP2_POLY = tuple(float.fromhex(c) for c in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
# bits of 2**(j / 32), j = 0..31
_POWF_EXP2_TAB = tuple(struct.unpack("<q", struct.pack("<d", 2.0 ** (j / 32)))[0]
                       for j in range(32))


def _powf(x: torch.Tensor, y) -> torch.Tensor:
    """float32 ``x ** y`` bit for bit as glibc's ``powf`` gives it, which
    is what ``jnp.power`` runs on XLA's CPU backend (``torch.pow`` differs
    in about 2% of values, the correctly rounded power in 0.06%): log2 of
    x from a 16-entry table and a degree-5 polynomial, times y, then exp2
    from a 32-entry table and a cubic, all in float64, rounded once. For
    x positive and normal (0 and inf give 0 and inf) and ``y * log2(x)``
    inside (-126, 126)."""
    dev = x.device
    m32 = 0xFFFFFFFF
    invc = torch.tensor([float.fromhex(a) for a, _ in _POWF_LOG2_TAB],
                        dtype=torch.float64, device=dev)
    logc = torch.tensor([float.fromhex(b) for _, b in _POWF_LOG2_TAB],
                        dtype=torch.float64, device=dev)
    a = _POWF_LOG2_POLY
    ix = x.contiguous().view(torch.int32).to(torch.int64) & m32
    tmp = (ix - 0x3F330000) & m32
    i = (tmp >> 19) % 16
    top = tmp & 0xFF800000
    k = (top - ((top >> 31) << 32)) >> 23           # int32(top) >> 23
    iz = (ix - top) & m32
    z = (iz - ((iz >> 31) << 32)).to(torch.int32).view(torch.float32).double()
    r = z * invc[i] - 1
    r2 = r * r
    q = (a[2] * r + a[3]) * r2 + (a[4] * r + (logc[i] + k.double()))
    log2x = (a[0] * r + a[1]) * (r2 * r2) + q
    yd = torch.as_tensor(y, dtype=torch.float32, device=dev).double()
    xd = yd * log2x
    m = torch.round(xd * 32)                        # k / 32 nearest, ties even
    r = xd - m / 32
    mi = m.to(torch.int64)
    tab = torch.tensor(_POWF_EXP2_TAB, dtype=torch.int64, device=dev)
    s = (tab[mi & 31] + (mi >> 5) * (1 << 52)).view(torch.float64)
    c = _POWF_EXP2_POLY
    p = (c[0] * r + c[1]) * (r * r) + (c[2] * r + 1)
    out = (p * s).float()
    out = torch.where(x == 0, torch.zeros_like(out), out)
    return torch.where(torch.isinf(x), x, out)


def _per_draw(grid: torch.Tensor, key: torch.Tensor, batch: int, n_valid,
              beta):
    """Priority-proportional draws with replacement over the masked priority
    grid [S, B] by the two-level inverse CDF, and their importance weights
    ``(N * P(i))**-beta`` over ``n_valid`` sampleable transitions,
    normalised by the grid-wide max weight (0 for a cell of zero priority,
    drawn only through round-off at the CDF edges). Returns (slot, env,
    flat index, weights)."""
    sl, bw = grid.shape
    s_slot = _sum_f32(grid)                               # [S]
    total = _sum_f32(s_slot)
    u = threefry.uniform(key, (batch,)) * total
    cum_slot = _cumsum_f32(s_slot)
    slot = torch.clamp((cum_slot[None, :] <= u[:, None]).sum(1), max=sl - 1)
    r = u - (cum_slot - s_slot)[slot]                     # residual in slot
    cum_in = _cumsum_f32(grid[slot])                      # [batch, B]
    row = torch.clamp((cum_in <= r[:, None]).sum(1), max=bw - 1)
    idx = slot * bw + row
    tot = torch.clamp(total, min=1e-12)
    prob = grid.reshape(-1)[idx] / tot
    n = torch.clamp(n_valid, min=1).float()
    w = _powf(1.0 / (n * torch.clamp(prob, min=1e-12)), beta)
    w = torch.where(prob > 0, w, 0.0)
    p_min = torch.where(grid > 0, grid, float("inf")).min()
    # XLA rewrites 1 / (n * p_min / tot) as tot / (n * p_min)
    w_max = _powf(tot / (n * torch.clamp(p_min, min=1e-12)), beta)
    return slot, row, idx, w / torch.clamp(w_max, min=1e-12)


def replay_sample_prioritized(rs: ReplayState, key: torch.Tensor, batch: int,
                              beta):
    """Priority-proportional sample with replacement (``rs.priority``
    holds p**alpha) by the two-level inverse CDF. Returns (batch dict,
    flat indices, importance weights ``(N * P(i))**-beta`` normalised by
    the buffer-wide max weight; 0 for a row of zero priority, drawn only
    through round-off at the CDF edges)."""
    slot, env, w = sample_draw(rs, key, batch, beta, prioritized=True)
    return gather_rows(rs, slot, env), slot * rs.width + env, w


def _slot_rows(slot: torch.Tensor, width: int) -> torch.Tensor:
    """Flat indices of whole slot rows, slot-contiguous."""
    ar = torch.arange(width, device=slot.device)
    return (slot.long()[:, None] * width + ar[None, :]).reshape(-1)


def replay_sample_slots(rs: ReplayState, key: torch.Tensor, batch: int):
    """Uniform slot-row sample over the filled region: (batch, slots)."""
    slot, env, _ = sample_draw(rs, key, batch, slots=True)
    return gather_rows(rs, slot, env), slot[::rs.width]


def _per_slot_draw(p_s: torch.Tensor, key: torch.Tensor, nb: int, n_tr,
                   width: int, beta):
    """Slot-level PER: ``nb`` slots drawn with replacement in proportion to
    their summed priority ``p_s`` [S], each weighted by its inclusion
    probability spread uniformly over its ``width`` transitions, against
    ``n_tr`` sampleable transitions. Returns (slots, weights[nb * width])."""
    total = _sum_f32(p_s)
    u = threefry.uniform(key, (nb,)) * total
    cum = _cumsum_f32(p_s)
    slot = torch.clamp((cum[None, :] <= u[:, None]).sum(1), max=p_s.shape[0] - 1)
    tot = torch.clamp(total, min=1e-12)
    q = p_s[slot] / tot
    n_tr = torch.clamp(n_tr, min=1).float()
    inv_b = _recip_f32(width)      # XLA divides by a constant so, too
    w_slot = _powf(1.0 / (n_tr * torch.clamp(q * inv_b, min=1e-12)), beta)
    w_slot = torch.where(q > 0, w_slot, 0.0)
    q_min = torch.where(p_s > 0, p_s, float("inf")).min() / tot
    w_max = _powf(1.0 / (n_tr * torch.clamp(q_min * inv_b, min=1e-12)), beta)
    return slot, (w_slot / torch.clamp(w_max, min=1e-12)).repeat_interleave(
        width)


def replay_sample_slots_prioritized(rs: ReplayState, key: torch.Tensor,
                                    batch: int, beta):
    """Slot-level PER: slots drawn with replacement in proportion to their
    summed priority, every transition of a drawn slot in the batch,
    importance-weighted by the slot's inclusion probability (uniform within
    the row). Returns (batch, slots, weights[nb * B])."""
    slot, env, w = sample_draw(rs, key, batch, beta, prioritized=True,
                               slots=True)
    return gather_rows(rs, slot, env), slot[::rs.width], w


def replay_update_priority(rs, idx: torch.Tensor, td_abs, alpha: float,
                           eps: float = 1e-3):
    """Write p = (|delta| + eps)**alpha at the sampled flat indices, in
    place, and raise the running max (a ``ReplayState`` or a
    ``FrameRingState``). A transition drawn twice carries the same delta
    both times, so which write lands is immaterial."""
    p = _powf(td_abs.detach().abs() + eps, alpha)
    rs.priority.view(-1).index_put_((idx.long(),), p)
    return rs.replace(max_p=torch.maximum(rs.max_p, p.max()))


def replay_update_priority_slots(rs, slot: torch.Tensor, td_abs,
                                 alpha: float, eps: float = 1e-3):
    """The priority write-back of slot-row sampling: td_abs [nb * B] for
    the whole rows at ``slot``."""
    return replay_update_priority(rs, _slot_rows(slot, rs.priority.shape[1]),
                                  td_abs, alpha, eps)


# ---------------------------------------------------------------------------
# The frame ring and the obs ring: one slot per actor step, observation
# stacks rebuilt and n-step returns folded when a batch is sampled.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FrameRingState:
    """One slot per actor step: the frame f_t (or, ``stacked``, the whole
    stack the actor saw) and (a_t, r_t, d_t, priority). ``done`` starts
    True, so unfilled slots clamp stacks like episode boundaries. A sample's
    stack needs ``history_slots`` slots behind it and its n-step target
    ``n_step`` ahead, so sampling draws ring ages in [n_step,
    filled - history_slots] (age 0 is the newest complete slot)."""
    frame: torch.Tensor         # uint8[S, B, F]: the frame, or the stack
    action: torch.Tensor        # int8[S, B]
    reward: torch.Tensor        # float32[S, B], the raw 1-step reward
    done: torch.Tensor          # bool[S, B]
    priority: torch.Tensor      # float32[S, B], p**alpha, 0 for unfilled
    max_p: torch.Tensor         # float32[]
    ptr: torch.Tensor           # int32[], the slot being written
    filled_slots: torch.Tensor  # int32[]
    base_shape: Tuple[int, ...] = ()
    frame_stack: int = 1
    n_step: int = 1
    gamma: float = 0.99
    stacked: bool = False       # the obs ring: a slot row holds the stack

    @property
    def width(self) -> int:
        return self.frame.shape[1]

    @property
    def slots(self) -> int:
        return self.frame.shape[0]

    @property
    def history_slots(self) -> int:
        """Slots of backward history a sample's stack needs."""
        return 1 if self.stacked else self.frame_stack

    @property
    def valid_slots(self) -> torch.Tensor:
        """Sampleable slots: ages [n_step, filled - history_slots]."""
        return torch.clamp(self.filled_slots - self.history_slots
                           - self.n_step + 1, min=0)

    def replace(self, **kw) -> "FrameRingState":
        return dataclasses.replace(self, **kw)


def frame_ring_init(capacity: int, base_shape: Tuple[int, ...],
                    insert_width: int, frame_stack: int = 1, n_step: int = 1,
                    gamma: float = 0.99, stacked: bool = False,
                    device="cuda") -> FrameRingState:
    if capacity % insert_width:
        raise ValueError(
            f"capacity {capacity} must be a multiple of the env batch "
            f"{insert_width} (each env owns capacity/B ring slots)")
    b, s = insert_width, capacity // insert_width
    if s < frame_stack + n_step + 1:
        raise ValueError(f"ring of {s} slots cannot serve frame_stack="
                         f"{frame_stack} + n_step={n_step}")
    f = math.prod(int(d) for d in base_shape) * (frame_stack if stacked else 1)
    z = lambda *shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return FrameRingState(
        base_shape=tuple(base_shape), frame_stack=int(frame_stack),
        n_step=int(n_step), gamma=float(gamma), stacked=bool(stacked),
        frame=z(s, b, f, dt=torch.uint8), action=z(s, b, dt=torch.int8),
        reward=z(s, b, dt=torch.float32),
        done=torch.ones((s, b), dtype=torch.bool, device=device),
        priority=z(s, b, dt=torch.float32),
        max_p=torch.ones((), dtype=torch.float32, device=device),
        ptr=z(dt=torch.int32), filled_slots=z(dt=torch.int32))


def frame_ring_insert_frame(rs: FrameRingState, frame) -> FrameRingState:
    """Write f_t (or the stack) at the current slot, in place, before the
    actor acts: it reads its stack straight back out of the ring."""
    b = frame.shape[0]
    if b != rs.width:
        raise ValueError(f"insert width {b} != ring width {rs.width}")
    rs.frame.index_put_((rs.ptr.long().view(1),),
                        frame.to(torch.uint8).reshape(b, -1)[None])
    return rs


def frame_ring_insert_step(rs: FrameRingState, action, reward,
                           done) -> FrameRingState:
    """Complete the current slot with (a_t, r_t, d_t), in place, and
    advance the ring."""
    at = rs.ptr.long().view(1)
    for buf, val in ((rs.action, action.to(torch.int8)),
                     (rs.reward, reward.float()), (rs.done, done.bool()),
                     (rs.priority, rs.max_p.expand(action.shape[0]))):
        buf.index_put_((at,), val[None])
    return rs.replace(ptr=(rs.ptr + 1) % rs.slots,
                      filled_slots=torch.clamp(rs.filled_slots + 1,
                                               max=rs.slots))


def _run_length_grid(rs: FrameRingState) -> torch.Tensor:
    """int32[S, B]: how many steps back each slot's episode extends, capped
    at frame_stack - 1 (the stack clamp's offset cap)."""
    run = torch.zeros(rs.done.shape, dtype=torch.int32, device=rs.done.device)
    ok = torch.ones_like(rs.done)
    for j in range(1, rs.frame_stack):
        ok = ok & ~torch.roll(rs.done, j, 0)          # done at slot - j
        run = torch.where(ok, j, run)
    return run


def _ring_stack(rs: FrameRingState, slot: torch.Tensor, env: torch.Tensor,
                run_flat=None) -> torch.Tensor:
    """The observation stacks ending at ``slot`` for the (slot, env) pairs,
    uint8 [N, *base_shape(, k)]: position j back takes f_{slot - j} while no
    done lies between, and past an episode's start its first frame (the
    actor's reset-to-repeat stack), in one merged gather of k * N rows.
    ``run_flat``: the flat run-length grid, shared by a sample's obs and
    next stacks."""
    k, S, B = rs.frame_stack, rs.slots, rs.width
    flat = rs.frame.reshape(S * B, -1)
    n = slot.shape[0]
    if rs.stacked or k == 1:
        out = flat.index_select(0, (slot * B + env).long())
        tail = (k,) if rs.stacked and k > 1 else ()
        return out.reshape((n,) + rs.base_shape + tail)
    if run_flat is None:
        run_flat = _run_length_grid(rs).reshape(S * B)
    run = run_flat[(slot * B + env).long()]
    idx = torch.stack([((slot - torch.clamp(run, max=j)) % S) * B + env
                       for j in range(k)])             # [k, N], newest first
    frames = flat.index_select(0, idx.reshape(-1).long()).reshape(k, n, -1)
    stacked = frames.flip(0).permute(1, 2, 0)          # oldest first
    return stacked.reshape((n,) + rs.base_shape + (k,))


def frame_ring_stack_newest(rs: FrameRingState) -> torch.Tensor:
    """The actor's current stack straight from the ring, after
    :func:`frame_ring_insert_frame` (the newest frame sits at ptr): every
    env reads the same k slot rows, with the episode clamp as cascaded
    per-env selects."""
    k, S, B = rs.frame_stack, rs.slots, rs.width
    p = rs.ptr.long()
    row = lambda buf, j: buf.index_select(0, ((p - j) % S).view(1))[0]
    prev = row(rs.frame, 0)                            # [B, F]
    if k == 1:
        return prev.reshape((B,) + rs.base_shape)
    frames, ok = [prev], torch.ones((B, 1), dtype=torch.bool,
                                    device=prev.device)
    for j in range(1, k):
        ok = ok & ~row(rs.done, j)[:, None]
        prev = torch.where(ok, row(rs.frame, j), prev)  # carry the clamp
        frames.append(prev)
    return torch.stack(frames[::-1], dim=-1).reshape((B,) + rs.base_shape
                                                     + (k,))


def _slot_scalar_folds(rs: FrameRingState):
    """The n-step return, alive and done-any grids [S, B] of every slot,
    folded from the raw rewards and dones of the n slots from it. XLA drops
    the first term's ``0 + 1 * r`` and fuses each later one into a
    multiply-add."""
    ret, alive, done_any = rs.reward, torch.ones_like(rs.reward), rs.done
    alive = alive * (1.0 - rs.done.float())
    for i in range(1, rs.n_step):
        r_i = torch.roll(rs.reward, -i, 0)             # the value at slot + i
        d_i = torch.roll(rs.done, -i, 0)
        ret = threefry._fma((rs.gamma ** i) * alive, r_i, ret)
        done_any = done_any | d_i
        alive = alive * (1.0 - d_i.float())
    return ret, alive, done_any


def _frame_ring_batch(rs: FrameRingState, slot: torch.Tensor,
                      env: torch.Tensor) -> dict:
    """The sampled transitions (slot, env): stacks rebuilt by gather and
    clamp, the n-step return and discount from the folded grids."""
    S, B, n = rs.slots, rs.width, rs.n_step
    fidx = (slot * B + env).long()
    ret, alive, done_any = _slot_scalar_folds(rs)
    run_flat = (None if rs.frame_stack == 1 or rs.stacked
                else _run_length_grid(rs).reshape(S * B))
    return {
        "obs": _ring_stack(rs, slot, env, run_flat),
        "next_obs": _ring_stack(rs, (slot + n) % S, env, run_flat),
        "action": rs.action.reshape(-1)[fidx].to(torch.int32),
        "reward": ret.reshape(-1)[fidx],
        "discount": (rs.gamma ** n) * alive.reshape(-1)[fidx],
        "done": done_any.reshape(-1)[fidx],
    }


def _ages_to_slots(rs: FrameRingState, key: torch.Tensor, shape):
    """Uniform slots over the valid age window [n_step, filled - history]."""
    m = rs.n_step + threefry.randint(key, shape, 0,
                                     torch.clamp(rs.valid_slots, min=1))
    return (rs.ptr - 1 - m) % rs.slots


def frame_ring_sample_slots(rs: FrameRingState, key: torch.Tensor,
                            batch: int):
    """Uniform slot-row sample over the valid age window: ``batch`` is
    nb * B; needs the obs ring or frame_stack 1, where a slot row is the
    observation. Returns (batch, slots)."""
    slot, env, _ = sample_draw(rs, key, batch, slots=True)
    return gather_rows(rs, slot, env), slot[::rs.width]


def _frame_ring_valid_mask(rs: FrameRingState) -> torch.Tensor:
    """[S] bool: the slots whose age lies in the sampleable window."""
    ar = torch.arange(rs.slots, dtype=torch.int32, device=rs.ptr.device)
    age = (rs.ptr - 1 - ar) % rs.slots
    return (age >= rs.n_step) & (age < rs.n_step + rs.valid_slots)


def frame_ring_sample_slots_prioritized(rs: FrameRingState, key: torch.Tensor,
                                        batch: int, beta):
    """Slot-level PER over the valid window (see
    :func:`replay_sample_slots_prioritized`): (batch, slots,
    weights[nb * B])."""
    slot, env, w = sample_draw(rs, key, batch, beta, prioritized=True,
                               slots=True)
    return gather_rows(rs, slot, env), slot[::rs.width], w


def frame_ring_sample(rs: FrameRingState, key: torch.Tensor,
                      batch: int) -> dict:
    """Uniform sample over the valid age window and the envs. Needs
    ``rs.valid_slots > 0`` (the trainer gates on it): an under-filled ring
    gives garbage, not an error."""
    slot, env, _ = sample_draw(rs, key, batch)
    return gather_rows(rs, slot, env)


def frame_ring_sample_prioritized(rs: FrameRingState, key: torch.Tensor,
                                  batch: int, beta):
    """Priority-proportional sample with replacement over the valid window,
    the legacy ring's two-level inverse CDF on the masked grid. Returns
    (batch, flat indices, weights). Needs ``rs.valid_slots > 0``."""
    slot, env, w = sample_draw(rs, key, batch, beta, prioritized=True)
    return gather_rows(rs, slot, env), slot * rs.width + env, w


# ---------------------------------------------------------------------------
# The draws and the gather that every sampler above composes. Under a
# data-parallel mesh each rank holds the env columns [offset, offset +
# width) of the global [S, B] ring: the learner draws its batch over the
# global ring on every rank alike, the owner of each drawn column gathers
# its rows, and the priority write-back lands on the owner.
# ---------------------------------------------------------------------------


def sample_draw(rs, key: torch.Tensor, batch: int, beta=None, *,
                prioritized: bool = False, slots: bool = False,
                width: Optional[int] = None,
                priority: Optional[torch.Tensor] = None):
    """The draws of a learner batch without its gather, for every layout,
    uniform or PER, transitions or whole slot rows, over a ring of
    ``width`` env columns (this ring's by default) whose priority grid is
    ``priority`` [S, width] (the global ring's under a mesh, so every rank
    draws alike). Returns (slot, env, weights or None), one entry per batch
    row; whole slot rows are env-major within each drawn slot."""
    frame = isinstance(rs, FrameRingState)
    width = rs.width if width is None else width
    priority = rs.priority if priority is None else priority
    if frame:
        n_valid = rs.valid_slots * width
        grid = lambda: torch.where(_frame_ring_valid_mask(rs)[:, None],
                                   priority, 0.0)
    else:
        n_valid = rs.filled_slots * width
        grid = lambda: torch.where(
            (torch.arange(rs.slots, device=priority.device)
             < rs.filled_slots)[:, None], priority, 0.0)
    weights = None
    if slots:
        nb, rem = divmod(batch, width)
        if rem:
            raise ValueError(f"slot-row batch {batch} must be a multiple of "
                             f"the ring width {width}")
        if frame and not (rs.stacked or rs.frame_stack == 1):
            raise ValueError("slot-row sampling needs ring_stacks=True or "
                             "frame_stack == 1 (no per-env stack clamping)")
        if prioritized:
            slot, weights = _per_slot_draw(_sum_f32(grid()), key, nb, n_valid,
                                           width, beta)
        elif frame:
            slot = _ages_to_slots(rs, key, (nb,))
        else:
            slot = threefry.randint(key, (nb,), 0,
                                    torch.clamp(rs.filled_slots, min=1))
        env = torch.arange(width, device=slot.device).repeat(nb)
        return slot.repeat_interleave(width), env, weights
    if prioritized:
        slot, env, _, weights = _per_draw(grid(), key, batch, n_valid, beta)
        return slot, env, weights
    kb, ks = threefry.split(key)
    if frame:
        slot = _ages_to_slots(rs, ks, (batch,))
    else:
        slot = threefry.randint(ks, (batch,), 0,
                                torch.clamp(rs.filled_slots, min=1))
    return slot, threefry.randint(kb, (batch,), 0, width), weights


def gather_rows(rs, slot: torch.Tensor, env: torch.Tensor) -> dict:
    """The batch rows (slot, env) of this ring's own columns (obs, next_obs,
    action, reward, discount, done), as its samplers build them."""
    if isinstance(rs, FrameRingState):
        return _frame_ring_batch(rs, slot, env)
    return _gather_batch(rs, slot * rs.width + env)


@span("replay.priority")
def update_priority_block(rs, slot: torch.Tensor, env: torch.Tensor, td_abs,
                          alpha: float, eps: float, env_offset: int):
    """``replay_update_priority`` on the rank that holds the env columns
    [env_offset, env_offset + width) of a sharded ring: the global batch's
    (slot, env) and TD errors; the owned rows are written, and the running
    max takes every row, as the unsharded ring's does."""
    p = _powf(td_abs.detach().abs() + eps, alpha)
    own = (env >= env_offset) & (env < env_offset + rs.width)
    idx = (slot.long() * rs.width + env - env_offset)[own]
    rs.priority.view(-1).index_put_((idx,), p[own])
    return rs.replace(max_p=torch.maximum(rs.max_p, p.max()))
