"""The port's DQN learner against the JAX package's (see
``test_torch_dqn.py`` for the configurations and the trajectory checks):
the first learner step in float32 networks, the target sync, the
``learn_every`` slots, slot-row sampling and ``DQNConfig``'s validation.

float32 networks (both trainers' networks swapped for float32 ones, as the
PPO tests do): after the first learner step every parameter within 1e-4
(measured up to 3e-5: torch sums in another order than XLA, and Adam's
first step divides by |g|).

bf16 dueling (the defaults): the port's dueling head rounds its backward
otherwise than XLA's CPU backend rounds jitted flax's (ROADMAP Queue 3):
autograd keeps the mean's cotangent unrounded and sums V's in float32,
where XLA rounds each, and a Dense bias's gradient is summed in float32
and rounded once, where XLA rounds each partial sum. A weight whose
gradient nearly cancels then takes the other sign, and Adam's first step
moves it by up to 2 lr. Held at the measured rates.
"""

import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu.models import dqn as jax_models
from gym_simpletetris_tpu.train import dqn as jax_dqn
from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.core.state import _key_tensor
from gym_simpletetris_tpu_torch.models import dqn as models
from gym_simpletetris_tpu_torch.train import dqn
from port_harness import flax_to_state_dict
from test_torch_dqn import _pair, _run_to_first_learn


@pytest.mark.parametrize("name", ["a_ram_default", "d_gray_rainbow"])
def test_first_learner_step_f32_params_within_1e_4(monkeypatch, name):
    jb, tb = jax_dqn.build_q_network, dqn.build_q_network
    monkeypatch.setattr(jax_dqn, "build_q_network",
                        lambda *a, **k: jb(*a, **k).clone(dtype=jnp.float32))
    monkeypatch.setattr(dqn, "build_q_network",
                        functools.partial(tb, dtype=torch.float32))
    jcfg, js, jm, ts, tm = _run_to_first_learn(name)
    for k in ("loss", "mean_q", "td_abs_err"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    jp = flax_to_state_dict(js.params)
    assert set(jp) == set(ts.params)
    for k, v in jp.items():
        np.testing.assert_allclose(ts.params[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
        assert not torch.equal(ts.params[k], ts.target_params[k]) or \
            (int(ts.learn_steps) % jcfg.target_update_period == 0), k


@pytest.mark.parametrize("head,over,most,head_most", [
    ("plain", {}, 89, 0), ("c51", {"distributional": True}, 85, 15)])
def test_first_learner_step_bf16_dueling_rate_against_jax(head, over, most,
                                                          head_most):
    """PER, 3-step returns and a dueling head in bf16 on RamDQN, after the
    first learner step against JAX's: every parameter within 2 lr plus
    rtol 2e-4, atol 2e-6, and outside rtol 2e-4, atol 2e-6 at most the
    measured count (plain head: 89 of 158,472, none in the head, up to
    6.0e-4; C51 head: 85 of 261,272, 15 in the head, up to 5.9e-4)."""
    jcfg, js, _, ts, _ = _run_to_first_learn("b_per_nstep_dueling", **over)
    jp = flax_to_state_dict(js.params)
    assert set(jp) == set(ts.params)
    outside = []
    for k, v in jp.items():
        got, want = ts.params[k].numpy(), v.numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-6 + 2 * jcfg.lr, err_msg=k)
        bad = np.abs(got - want) > 2e-6 + 2e-4 * np.abs(want)
        outside += [k] * int(bad.sum())
    assert len(outside) <= most, len(outside)
    assert sum("Head" in k for k in outside) <= head_most, outside


class _FlaxHead(flax_nn.Module):
    """A dueling head under its network's name, so that its noise keys
    fold in the port's module paths."""
    atoms: int
    noisy: bool

    @flax_nn.compact
    def __call__(self, x):
        if self.atoms:
            return jax_models.C51Head(7, self.atoms, True, self.noisy)(x)
        return jax_models.DuelingHead(7, self.noisy)(x)


@pytest.mark.parametrize("atoms,noisy", [(0, False), (0, True), (51, False),
                                         (51, True)])
def test_dueling_backward_within_its_roundings_of_xla(atoms, noisy):
    """Random rows and cotangents (numpy seed) through the flax head under
    the jitted ``jax.grad`` and the port's under autograd. The two
    backwards round V's, A's and the mean's cotangents, and the bias sums,
    at other points (module docstring), so half the weight gradients
    differ; each is held within a bound on what those roundings can move
    it (a few bf16 roundings, 2**-8 relative, of each term of its row's
    cotangent; below). Dropping the mean's term, or the 1 / A, exceeds it.
    A noisy sigma's gradient is its mu's times the noise."""
    rng = np.random.RandomState(11 + atoms + noisy)
    rows, fin, acts = 16, 64, 7
    x = rng.randn(rows, fin).astype(np.float32)
    g = rng.randn(*((rows, acts, atoms) if atoms else (rows, acts))).astype(
        np.float32)
    head = _FlaxHead(atoms, noisy)
    params = head.init({"params": jax.random.PRNGKey(3),
                        "noise": jax.random.PRNGKey(4)}, x)

    def loss(p, x, g):
        q = head.apply(p, x, rngs={"noise": jax.random.PRNGKey(9)})
        return jnp.sum(q.astype(jnp.float32) * g)

    want = flax_to_state_dict(jax.jit(jax.grad(loss))(params, x, g))
    port = (models.C51Head(fin, acts, atoms, True, noisy) if atoms
            else models.DuelingHead(fin, acts, noisy))
    prefix = port.NAME + "."
    port.load_state_dict({k[len(prefix):]: v for k, v in
                          flax_to_state_dict(params).items()})
    key = _key_tensor(9, "cpu") if noisy else None
    q = port(torch.from_numpy(x), key)
    (q * torch.from_numpy(g)).sum().backward()
    grads = {prefix + k: p.grad for k, p in port.named_parameters()}
    assert set(grads) == set(want)
    # what the roundings can move, per row b, action a, atom z: A's
    # cotangent a bf16 rounding of its terms (|g| and the mean's, at most
    # the row's |g| sum over A), V's A roundings of that sum; the weights
    # sum them against |x|, the biases over the rows, where each rounding
    # of the sum adds one of its terms
    g3 = np.abs(g).reshape(rows, acts, -1)
    row = g3.sum(1)                                            # [rows, Z]
    e_a = 2.0 ** -6 * g3 + 2.0 ** -5 * row[:, None] / acts
    e_v = acts * 2.0 ** -7 * row
    ax = np.abs(x)
    bounds = {
        "advantage.weight": np.einsum("bi,baz->azi", ax, e_a).reshape(-1, fin),
        "value.weight": np.einsum("bi,bz->zi", ax, e_v),
        "advantage.bias": (e_a.sum(0) + rows * 2.0 ** -8 * (
            g3 + row[:, None] / acts).sum(0)).reshape(-1),
        "value.bias": e_v.sum(0) + rows * 2.0 ** -8 * row.sum(0)}
    differ = 0
    for k, w in want.items():
        got, w = grads[k].numpy(), w.numpy()
        name = k[len(prefix):]
        wide = "weight" in name
        bound = bounds[name.split("_")[0]].reshape(got.shape)
        if k.endswith("sigma"):
            layer = getattr(port, name.split(".")[0])
            noise = _noise(layer, key, wide)
            bound = bound * np.abs(noise) * (1 + 1e-6) + 1e-12
        assert np.all(np.abs(got - w) <= bound), (k, float(
            (np.abs(got - w) / bound).max()))
        differ += int((got != w).sum())
    assert differ > 0     # the roundings do differ: no bitwise claim


def _noise(layer, key, wide):
    """A NoisyDense's factorised noise, weight or bias: its noisy
    parameter less mu, over sigma."""
    w, b = layer.noisy_weights(key)
    if wide:
        return ((w - layer.weight_mu) / layer.weight_sigma).detach().numpy()
    return ((b - layer.bias_mu) / layer.bias_sigma).detach().numpy()


def test_target_syncs_every_period():
    """target_update_period = 2: the target stays at the init params after
    the first learner step and equals the params after the second."""
    _, tcfg = _pair("a_ram_default")
    init_fn, step_fn, _, _ = dqn.make_train(tcfg, "cpu")
    s = init_fn(0)
    p0 = s.params
    seen = []
    for _ in range(12):
        s, m = step_fn(s)
        n = int(s.learn_steps)
        same = all(torch.equal(s.target_params[k], s.params[k]) for k in p0)
        orig = all(torch.equal(s.target_params[k], p0[k]) for k in p0)
        seen.append((n, same, orig))
    assert (1, False, True) in seen and (2, True, False) in seen
    assert (3, False, False) in seen and (4, True, False) in seen


def test_learn_every_flags():
    """learn_every = 4: learner steps only on every fourth actor step of a
    chunk once warm, and the learner metrics average over those slots."""
    _, tcfg = _pair("a_ram_default", learn_every=4, learn_starts=8)
    init_fn, _, chunk_fn, _ = dqn.make_train(tcfg, "cpu")
    s = init_fn(1)
    s, m = chunk_fn(s, 8)
    assert int(s.step) == 8 and int(s.learn_steps) == 2
    assert float(m["loss"]) > 0
    s, m = chunk_fn(s, 12)
    assert int(s.learn_steps) == 5
    with pytest.raises(ValueError, match="multiple of learn_every"):
        chunk_fn(s, 6)


def test_config_validation_and_frame_ring():
    with pytest.raises(ValueError, match="multiple of num_envs"):
        dqn.DQNConfig(num_envs=10, buffer_capacity=25)
    with pytest.raises(ValueError, match="learn_every"):
        dqn.DQNConfig(learn_every=0)
    with pytest.raises(ValueError, match="ring_stacks"):
        dqn.DQNConfig(ring_stacks=True)
    with pytest.raises(ValueError, match="whole slot rows"):
        dqn.DQNConfig(sample_slots=True, num_envs=16, buffer_capacity=64,
                      learn_batch=24)
    with pytest.raises(ValueError, match="ring_stacks=True or frame_stack"):
        dqn.DQNConfig(sample_slots=True, frame_ring=True, frame_stack=4,
                      num_envs=16, buffer_capacity=64, learn_batch=32)
    with pytest.raises(ValueError, match="auto_reset"):
        dqn.make_train(dqn.DQNConfig(env=EnvConfig()), "cpu")
    # the frame ring and the obs ring build (ROADMAP item 11d), and run_dqn
    # runs on each layout
    from gym_simpletetris_tpu_torch.train.replay import FrameRingState
    from gym_simpletetris_tpu_torch.train.run_dqn import main
    for stacks in (False, True):
        init_fn = dqn.make_train(dqn.DQNConfig(
            num_envs=4, buffer_capacity=32, frame_ring=True,
            ring_stacks=stacks), "cpu")[0]
        assert isinstance(init_fn(0).replay, FrameRingState)
    for layout in ("frame-ring", "obs-ring"):
        state = main(["--replay-layout", layout, "--device", "cpu",
                      "--num-envs", "4", "--buffer", "32", "--chunk", "2",
                      "--total-steps", "2", "--width", "6", "--height", "8"])
        assert state.replay.stacked == (layout == "obs-ring")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dqn.make_train(dqn.DQNConfig(), "cuda")


def test_sample_slots_trains():
    """Slot-row sampling, uniform and prioritized, runs and learns."""
    for per in (False, True):
        _, tcfg = _pair("a_ram_default", sample_slots=True, prioritized=per)
        init_fn, _, chunk_fn, _ = dqn.make_train(tcfg, "cpu")
        s, m = chunk_fn(init_fn(2), 8)
        assert int(s.learn_steps) == 4 and np.isfinite(float(m["loss"]))
