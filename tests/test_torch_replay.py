"""The port's legacy replay ring (``train/replay.py``) against the JAX
package's on the same inserts and keys.

- contents bitwise after the ring wraps;
- uniform and slot-row samples: the same indices (and batches) bitwise;
- prioritized samples: indices bitwise, on dyadic priorities (exact
  float32 sums) and on random ones (the sums follow XLA's order); weights
  bitwise on the dyadic ones and within 1e-6 relative on the random ones
  (a few ulp: XLA rearranges the weight's quotients, not emulated);
- the priority write-back bitwise (``_powf`` is glibc's ``powf``);
- ``project_distribution`` within 1e-6, the support edges included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu.train import dqn as jax_dqn
from gym_simpletetris_tpu.train import replay as jr
from gym_simpletetris_tpu_torch.core.state import _key_tensor
from gym_simpletetris_tpu_torch.train import dqn
from gym_simpletetris_tpu_torch.train import replay as tr
from port_harness import assert_bitwise

FIELDS = ("obs", "next_obs", "action", "reward", "discount", "done",
          "priority", "max_p", "ptr", "filled_slots")


def _filled_pair(slots=5, width=4, shape=(3, 2), inserts=7, seed=0):
    """The JAX and port rings after ``inserts`` random inserts (wrapping
    once when inserts > slots), half with a given discount."""
    rng = np.random.RandomState(seed)
    js = jr.replay_init(slots * width, shape, width)
    ts = tr.replay_init(slots * width, shape, width, device="cpu")
    for t in range(inserts):
        o = rng.randint(0, 200, (width,) + shape).astype(np.float32)
        n = rng.randint(0, 200, (width,) + shape).astype(np.float32)
        a = rng.randint(0, 7, width).astype(np.int32)
        r = rng.choice([1.0, -100.0, 0.5, 3.25], width).astype(np.float32)
        d = rng.rand(width) < 0.3
        disc = (rng.rand(width) * (~d)).astype(np.float32) if t % 2 else None
        kw = dict(discount=disc) if disc is not None else dict(gamma=0.99)
        js = jr.replay_insert(js, jnp.asarray(o), jnp.asarray(n), jnp.asarray(a),
                              jnp.asarray(r), jnp.asarray(d),
                              **{k: (jnp.asarray(v) if k == "discount" else v)
                                 for k, v in kw.items()})
        ts = tr.replay_insert(ts, torch.from_numpy(o), torch.from_numpy(n),
                              torch.from_numpy(a), torch.from_numpy(r),
                              torch.from_numpy(d),
                              **{k: (torch.from_numpy(v) if k == "discount"
                                     else v) for k, v in kw.items()})
    return js, ts


def _assert_ring_equal(js, ts, msg=""):
    for f in FIELDS:
        assert_bitwise(getattr(ts, f), np.asarray(getattr(js, f)), f"{msg} {f}")


def _assert_batch_equal(jb, tb):
    assert set(jb) == set(tb)
    for k in jb:
        assert_bitwise(tb[k], np.asarray(jb[k]), k)


def _keys(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2 ** 31, n)


@pytest.mark.parametrize("inserts", [3, 5, 7, 12])
def test_contents_match_after_wrap(inserts):
    js, ts = _filled_pair(inserts=inserts)
    _assert_ring_equal(js, ts, f"after {inserts} inserts")
    assert int(ts.filled) == int(js.filled) == min(inserts, 5) * 4


def test_insert_errors():
    ts = tr.replay_init(8, (2,), 4, device="cpu")
    z = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="width"):
        tr.replay_insert(ts, torch.zeros(3, 2), torch.zeros(3, 2),
                         torch.zeros(3), torch.zeros(3),
                         torch.zeros(3, dtype=torch.bool), gamma=0.9)
    with pytest.raises(TypeError, match="exactly one"):
        tr.replay_insert(ts, z, z, torch.zeros(4), torch.zeros(4),
                         torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple"):
        tr.replay_init(10, (2,), 4, device="cpu")


@pytest.mark.parametrize("inserts", [3, 9])
def test_uniform_and_slot_samples_match(inserts):
    js, ts = _filled_pair(inserts=inserts)
    for seed in _keys(6, inserts):
        jb = jr.replay_sample(js, jax.random.PRNGKey(seed), 16)
        tb = tr.replay_sample(ts, _key_tensor(int(seed), "cpu"), 16)
        _assert_batch_equal(jb, tb)
        jb, jslot = jr.replay_sample_slots(js, jax.random.PRNGKey(seed), 12)
        tb, tslot = tr.replay_sample_slots(ts, _key_tensor(int(seed), "cpu"),
                                           12)
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        _assert_batch_equal(jb, tb)
    with pytest.raises(ValueError, match="multiple"):
        tr.replay_sample_slots(ts, _key_tensor(0, "cpu"), 10)


def _set_priorities(js, ts, p):
    js = js.replace(priority=jnp.asarray(p), max_p=jnp.asarray(p.max()))
    ts.priority.copy_(torch.from_numpy(p))
    return js, ts.replace(max_p=torch.tensor(p.max()))


@pytest.mark.parametrize("kind", ["dyadic", "random"])
@pytest.mark.parametrize("inserts", [3, 9])
def test_prioritized_samples_match(kind, inserts):
    """Per-transition and slot-level PER: indices bitwise on dyadic
    priorities (float32 sums exact in any order) and on random ones (the
    row sums and cumulative sums in XLA's order); weights bitwise on the
    dyadic ones, within 1e-6 relative on the random ones."""
    js, ts = _filled_pair(slots=6, width=40, inserts=inserts)
    rng = np.random.RandomState(inserts)
    if kind == "dyadic":
        p = rng.choice([0.25, 0.5, 1.0, 2.0, 4.0], (6, 40)).astype(np.float32)
    else:
        p = (rng.rand(6, 40) ** 3 * 5).astype(np.float32)
    js, ts = _set_priorities(js, ts, p)
    for seed in _keys(5, inserts + 1):
        for beta in (0.4, 0.7123):
            jk, tk = jax.random.PRNGKey(seed), _key_tensor(int(seed), "cpu")
            jb, jidx, jw = jax.jit(jr.replay_sample_prioritized,
                                   static_argnums=2)(js, jk, 64, beta)
            tb, tidx, tw = tr.replay_sample_prioritized(ts, tk, 64, beta)
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
            _assert_batch_equal(jb, tb)
            _assert_weights(tw, jw, kind)
            jb, jslot, jw = jax.jit(jr.replay_sample_slots_prioritized,
                                    static_argnums=2)(js, jk, 120, beta)
            tb, tslot, tw = tr.replay_sample_slots_prioritized(ts, tk, 120,
                                                               beta)
            np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
            _assert_batch_equal(jb, tb)
            _assert_weights(tw, jw, kind)


def _assert_weights(got, want, kind):
    if kind == "dyadic":
        assert_bitwise(got, np.asarray(want), "weights")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


def test_priority_update_matches():
    """The write-back p = (|delta| + eps)**alpha at the sampled indices
    (duplicates carry one value), and the slot-row variant."""
    js, ts = _filled_pair(slots=6, width=40, inserts=8)
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 240, 64).astype(np.int32)
    idx[10] = idx[3]
    td = (rng.randn(64) * rng.choice([0.01, 1, 30], 64)).astype(np.float32)
    td[10] = td[3]
    js = jax.jit(jr.replay_update_priority)(js, jnp.asarray(idx),
                                            jnp.asarray(td), 0.6)
    ts = tr.replay_update_priority(ts, torch.from_numpy(idx),
                                   torch.from_numpy(td), 0.6)
    _assert_ring_equal(js, ts, "after update")
    slot = np.array([4, 1, 4], np.int32)
    td = np.repeat(rng.rand(3) * 7, 40).astype(np.float32)
    td[80:] = td[:40]
    js = jax.jit(jr.replay_update_priority_slots)(js, jnp.asarray(slot),
                                                  jnp.asarray(td), 0.5, 1e-2)
    ts = tr.replay_update_priority_slots(ts, torch.from_numpy(slot),
                                         torch.from_numpy(td), 0.5, 1e-2)
    _assert_ring_equal(js, ts, "after slot update")


def test_sums_and_powers_follow_xla():
    """``_sum_f32`` against ``jnp.sum`` at sizes around its 32-element
    windows (padding split low / high), and ``_powf`` against ``x ** y``
    over the priorities' and weights' ranges."""
    rng = np.random.RandomState(5)
    for shape in [(7,), (33,), (100,), (1000,), (1025,), (65536,), (64, 48),
                  (256, 1024)]:
        x = rng.rand(*shape).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: a.sum(-1))(jnp.asarray(x)))
        got = tr._sum_f32(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(np.atleast_1d(got).view(np.int32),
                                      np.atleast_1d(want).view(np.int32),
                                      err_msg=str(shape))
    x = np.concatenate([np.abs(rng.randn(100000)) * rng.choice(
        [1e-3, 1.0, 100.0, 1e6], 100000) + 1e-3, [1.0, 2.0, 0.5, 1e12]]) \
        .astype(np.float32)
    for y in (0.6, 0.4, 0.5123, 1.0):
        want = np.asarray(jax.jit(lambda a, b: a ** b)(jnp.asarray(x),
                                                       jnp.float32(y)))
        got = tr._powf(torch.from_numpy(x), y).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert tr._powf(torch.tensor([0.0, float("inf")]), 0.4).tolist() == \
        [0.0, float("inf")]


@pytest.mark.parametrize("v_min,v_max,n", [(-110.0, 110.0, 51),
                                           (-10.0, 10.0, 21)])
def test_project_distribution_matches_jax(v_min, v_max, n):
    rng = np.random.RandomState(0)
    logits = rng.randn(32, n).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    z = np.linspace(v_min, v_max, n, dtype=np.float32)
    reward = rng.choice([0.0, 1.0, -5.0, -100.0, 250.0], size=(32, 1))
    disc = rng.choice([0.0, 0.99, 0.99 ** 3], size=(32, 1))
    tz = (reward + disc * z[None, :]).astype(np.float32)
    want = np.asarray(jax_dqn.project_distribution(
        jnp.asarray(probs), jnp.asarray(tz), v_min, v_max, n))
    got = dqn.project_distribution(torch.from_numpy(probs),
                                   torch.from_numpy(tz), v_min, v_max, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_project_distribution_support_edges():
    n = 11
    probs = torch.ones((1, n)) / n
    for fill, at in ((-999.0, 0), (999.0, -1)):
        m = dqn.project_distribution(probs, torch.full((1, n), fill), -1.0,
                                     1.0, n)
        want = np.asarray(jax_dqn.project_distribution(
            jnp.ones((1, n)) / n, jnp.full((1, n), fill), -1.0, 1.0, n))
        np.testing.assert_allclose(m.numpy(), want, rtol=0, atol=1e-6)
        assert abs(float(m[0, at]) - 1.0) <= 1e-6


def test_support_matches_jnp_linspace():
    """The C51 support: the ends exact, every point within 1e-6 of the
    span of ``jnp.linspace``'s (measured: up to 2 ulp; XLA's fusion order
    is not emulated)."""
    for v_min, v_max, n in ((-110.0, 110.0, 51), (-10.0, 10.0, 21),
                            (-1.0, 3.0, 7)):
        want = np.asarray(jnp.linspace(v_min, v_max, n))
        got = dqn.support_f32(v_min, v_max, n, device="cpu").numpy()
        assert got[0] == want[0] == v_min and got[-1] == want[-1] == v_max
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * (v_max - v_min))
