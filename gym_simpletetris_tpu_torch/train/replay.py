"""Replay ring of the DQN trainer, the legacy layout (port of the first half
of ``gym_simpletetris_tpu.train.replay``), with prioritized sampling.

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

Unlike the functional JAX ring, ``replay_insert`` and the priority updates
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
from typing import Tuple

import torch
import torch.nn.functional as F

from ..core import threefry


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
                device="cpu") -> ReplayState:
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
    kb, ks = threefry.split(key)
    s = threefry.randint(ks, (batch,), 0, torch.clamp(rs.filled_slots, min=1))
    b = threefry.randint(kb, (batch,), 0, rs.width)
    return _gather_batch(rs, s * rs.width + b)


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


def replay_sample_prioritized(rs: ReplayState, key: torch.Tensor, batch: int,
                              beta):
    """Priority-proportional sample with replacement (``rs.priority``
    holds p**alpha) by the two-level inverse CDF. Returns (batch dict,
    flat indices, importance weights ``(N * P(i))**-beta`` normalised by
    the buffer-wide max weight; 0 for a row of zero priority, drawn only
    through round-off at the CDF edges)."""
    bw, sl = rs.width, rs.slots
    dev = rs.priority.device
    valid = (torch.arange(sl, device=dev) < rs.filled_slots)[:, None]
    grid = torch.where(valid, rs.priority, 0.0)
    s_slot = _sum_f32(grid)                               # [S]
    total = _sum_f32(s_slot)
    u = threefry.uniform(key, (batch,)) * total
    cum_slot = _cumsum_f32(s_slot)
    slot = torch.clamp((cum_slot[None, :] <= u[:, None]).sum(1), max=sl - 1)
    r = u - (cum_slot - s_slot)[slot]                     # residual in slot
    cum_in = _cumsum_f32(grid[slot])                      # [batch, B]
    row = torch.clamp((cum_in <= r[:, None]).sum(1), max=bw - 1)
    idx = slot * bw + row
    out = _gather_batch(rs, idx)
    tot = torch.clamp(total, min=1e-12)
    prob = grid.reshape(-1)[idx] / tot
    n = torch.clamp(rs.filled, min=1).float()
    w = _powf(1.0 / (n * torch.clamp(prob, min=1e-12)), beta)
    w = torch.where(prob > 0, w, 0.0)
    p_min = torch.where(valid & (grid > 0), grid, float("inf")).min()
    w_max = _powf(1.0 / (n * torch.clamp(p_min, min=1e-12) / tot), beta)
    return out, idx, w / torch.clamp(w_max, min=1e-12)


def _slot_rows(slot: torch.Tensor, width: int) -> torch.Tensor:
    """Flat indices of whole slot rows, slot-contiguous."""
    ar = torch.arange(width, device=slot.device)
    return (slot.long()[:, None] * width + ar[None, :]).reshape(-1)


def _legacy_slot_batch(rs: ReplayState, slot: torch.Tensor) -> dict:
    """The batch of whole slot rows: nb * B transitions."""
    return _gather_batch(rs, _slot_rows(slot, rs.width))


def _slot_count(rs: ReplayState, batch: int) -> int:
    nb, rem = divmod(batch, rs.width)
    if rem:
        raise ValueError(f"slot-row batch {batch} must be a multiple of the "
                         f"ring width {rs.width}")
    return nb


def replay_sample_slots(rs: ReplayState, key: torch.Tensor, batch: int):
    """Uniform slot-row sample over the filled region: (batch, slots)."""
    nb = _slot_count(rs, batch)
    slot = threefry.randint(key, (nb,), 0, torch.clamp(rs.filled_slots, min=1))
    return _legacy_slot_batch(rs, slot), slot


def replay_sample_slots_prioritized(rs: ReplayState, key: torch.Tensor,
                                    batch: int, beta):
    """Slot-level PER: slots drawn with replacement in proportion to their
    summed priority, every transition of a drawn slot in the batch,
    importance-weighted by the slot's inclusion probability (uniform within
    the row). Returns (batch, slots, weights[nb * B])."""
    nb = _slot_count(rs, batch)
    B, S = rs.width, rs.slots
    dev = rs.priority.device
    valid = (torch.arange(S, device=dev) < rs.filled_slots)[:, None]
    p_s = _sum_f32(torch.where(valid, rs.priority, 0.0))
    total = _sum_f32(p_s)
    u = threefry.uniform(key, (nb,)) * total
    cum = _cumsum_f32(p_s)
    slot = torch.clamp((cum[None, :] <= u[:, None]).sum(1), max=S - 1)
    tot = torch.clamp(total, min=1e-12)
    q = p_s[slot] / tot
    n_tr = torch.clamp(rs.filled, min=1).float()
    inv_b = _recip_f32(B)          # XLA divides by a constant so, too
    w_slot = _powf(1.0 / (n_tr * torch.clamp(q * inv_b, min=1e-12)), beta)
    w_slot = torch.where(q > 0, w_slot, 0.0)
    q_min = torch.where(p_s > 0, p_s, float("inf")).min() / tot
    w_max = _powf(1.0 / (n_tr * torch.clamp(q_min * inv_b, min=1e-12)), beta)
    weights = (w_slot / torch.clamp(w_max, min=1e-12)).repeat_interleave(B)
    return _legacy_slot_batch(rs, slot), slot, weights


def replay_update_priority(rs: ReplayState, idx: torch.Tensor, td_abs,
                           alpha: float, eps: float = 1e-3) -> ReplayState:
    """Write p = (|delta| + eps)**alpha at the sampled flat indices, in
    place, and raise the running max. A transition drawn twice carries the
    same delta both times, so which write lands is immaterial."""
    p = _powf(td_abs.detach().abs() + eps, alpha)
    rs.priority.view(-1).index_put_((idx.long(),), p)
    return rs.replace(max_p=torch.maximum(rs.max_p, p.max()))


def replay_update_priority_slots(rs: ReplayState, slot: torch.Tensor, td_abs,
                                 alpha: float,
                                 eps: float = 1e-3) -> ReplayState:
    """The priority write-back of slot-row sampling: td_abs [nb * B] for
    the whole rows at ``slot``."""
    return replay_update_priority(rs, _slot_rows(slot, rs.priority.shape[1]),
                                  td_abs, alpha, eps)
