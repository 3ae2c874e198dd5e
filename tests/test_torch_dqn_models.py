"""The port's Q-networks (``models/dqn.py``) against the JAX package's flax
ones, flax parameters carried across (``params_from_flax``), on
observations from play.

- Every head (plain, dueling, C51, C51 + dueling), each noisy and not, on
  ram with ``frame_stack`` 1 and 4 and on grayscale with ``frame_stack`` 4:
  bf16 outputs against the jitted flax forward, the noisy ones under the
  same noise key. All but a few elements in 10,000 are bitwise (measured
  up to 4 in 10,000 at a random init), the rest one bf16 rounding away:
  the float32 sum inside a bf16 product runs in another order in torch's
  sgemm than in XLA's dot, and a rounding tie goes the other way (ROADMAP
  Queue 3). Held: under 2e-3 of the elements differ (of the rows under a
  plain dueling head, where such a flip moves the whole row), every
  element within one bf16 ulp of its row's largest |output|, and the
  greedy action equal wherever the top-two margin exceeds twice that.
- Grayscale with one frame: within one bf16 ulp of the row's largest
  |output| (the tolerance of the PPO conv test, ``test_torch_models.py``):
  the single-channel convolution also sums in another order than XLA's,
  and differs in a few percent of the elements.
- float32 networks: within 1e-5 relative of the row's largest |output|
  (torch's sgemm sums in another order than XLA's dot).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu import TetrisVectorEnv as JaxEnv
from gym_simpletetris_tpu.models import dqn as jax_dqn
from gym_simpletetris_tpu_torch.core.state import _key_tensor
from gym_simpletetris_tpu_torch.models import dqn
from port_harness import flax_to_state_dict, state_dict_to_flax

HEADS = list(itertools.product([False, True], [0, 51]))   # dueling, atoms


@functools.lru_cache(maxsize=None)
def _play_obs(obs_type, frame_stack, batch, steps):
    """Observations of ``steps`` random-policy steps of the JAX env
    (6 x 8 ram boards, 84 px images), stacked over the last
    ``frame_stack`` steps as the trainer stacks them."""
    kw = dict(width=6, height=8) if obs_type == "ram" else {}
    env = JaxEnv(JaxConfig(obs_type=obs_type, auto_reset=True, **kw), batch)
    obs, s = env.reset(jax.random.PRNGKey(1))
    rng = np.random.RandomState(0)
    frames = [np.asarray(obs)] * frame_stack
    out = []
    for _ in range(steps):
        obs, s, *_ = env.step(s, jnp.asarray(rng.randint(0, 7, batch),
                                             jnp.int32))
        frames = frames[1:] + [np.asarray(obs)]
        out.append(np.stack(frames, -1) if frame_stack > 1 else frames[-1])
    return np.concatenate(out)


def _pair(obs_type, shape, dueling, atoms, noisy, jdt=jnp.bfloat16,
          tdt=torch.bfloat16, seed=1):
    jnet = jax_dqn.build_q_network(obs_type, shape, dueling=dueling,
                                   num_atoms=atoms, noisy=noisy)
    jnet = jnet.clone(dtype=jdt)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + shape))
    tnet = dqn.build_q_network(obs_type, shape, dueling=dueling,
                               num_atoms=atoms, noisy=noisy, dtype=tdt)
    tnet.load_state_dict(flax_to_state_dict(params))
    return jnet, params, tnet


def _forwards(jnet, params, tnet, x, noise_seed=None):
    if noise_seed is None:
        want = jax.jit(jnet.apply)(params, jnp.asarray(x))
        with torch.no_grad():
            got = tnet(torch.from_numpy(x))
    else:
        want = jax.jit(lambda p, o, k: jnet.apply(p, o, rngs={"noise": k}))(
            params, jnp.asarray(x), jax.random.PRNGKey(noise_seed))
        with torch.no_grad():
            got = tnet(torch.from_numpy(x), _key_tensor(noise_seed, "cpu"))
    return got.numpy(), np.asarray(want)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("obs_type,fs,noisy", [
    ("ram", 1, False), ("ram", 1, True), ("ram", 4, True),
    ("grayscale", 4, False), ("grayscale", 4, True)])
def test_forward_on_play_observations(obs_type, fs, noisy):
    x = _play_obs(obs_type, fs, 32 if obs_type == "ram" else 2,
                  24 if obs_type == "ram" else 4)
    shape = x.shape[1:]
    for dueling, atoms in HEADS:
        jnet, params, tnet = _pair(obs_type, shape, dueling, atoms, noisy)
        got, want = _forwards(jnet, params, tnet, x, 7 if noisy else None)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape == (len(x), 7) + ((atoms,) if atoms else ())
        what = f"{obs_type} fs={fs} dueling={dueling} atoms={atoms}"
        diff = _bits(got) != _bits(want)
        if dueling and not atoms:     # a flip in V or the mean moves a row
            diff = diff.any(axis=1)
        assert diff.mean() < 2e-3, what
        _assert_within_an_ulp(got, want, atoms, what)


def _assert_within_an_ulp(got, want, atoms, what):
    """Every element within one bf16 ulp of its row's largest |output|, and
    the greedy action (over E[atom index] for C51) equal where the top-two
    margin exceeds twice that."""
    axes = tuple(range(1, want.ndim))
    tol = 2.0 ** -7 * np.abs(want).max(axis=axes, keepdims=True)
    assert (np.abs(got - want) <= tol).all(), what
    if atoms:
        idx = np.arange(atoms, dtype=np.float32)
        q = lambda o: (np.exp(o - o.max(-1, keepdims=True))
                       / np.exp(o - o.max(-1, keepdims=True)).sum(-1,
                                                                  keepdims=True)
                       * idx).sum(-1)
        got, want = q(got), q(want)
        tol = 2.0 ** -7 * atoms * np.ones((len(want), 1))
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol[:, 0].reshape(-1)
    np.testing.assert_array_equal(got.argmax(1)[clear], want.argmax(1)[clear],
                                  err_msg=what)


@pytest.mark.parametrize("noisy", [False, True])
def test_grayscale_single_frame_within_an_ulp(noisy):
    x = _play_obs("grayscale", 1, 2, 4)
    for dueling, atoms in HEADS:
        jnet, params, tnet = _pair("grayscale", (84, 84), dueling, atoms,
                                   noisy)
        got, want = _forwards(jnet, params, tnet, x, 3 if noisy else None)
        _assert_within_an_ulp(got, want, atoms, f"dueling={dueling} "
                              f"atoms={atoms}")


@pytest.mark.parametrize("obs_type,shape", [("ram", (6, 8)),
                                            ("grayscale", (84, 84, 4))])
def test_f32_forward_within_1e_5(obs_type, shape):
    x = _play_obs(obs_type, shape[-1] if len(shape) == 3 else 1,
                  32 if obs_type == "ram" else 2, 12 if obs_type == "ram" else 3)
    for (dueling, atoms), noisy in itertools.product(HEADS, [False, True]):
        jnet, params, tnet = _pair(obs_type, shape, dueling, atoms, noisy,
                                   jnp.float32, torch.float32)
        got, want = _forwards(jnet, params, tnet, x, 5 if noisy else None)
        scale = np.abs(want).max(axis=tuple(range(1, want.ndim)),
                                 keepdims=True)
        assert (np.abs(got - want) <= 1e-5 * scale).all(), (dueling, atoms,
                                                            noisy)


def test_noisy_without_a_key_is_the_mu_network():
    """No noise key: the deterministic mu-only net, flax's apply without a
    "noise" rng; a key changes the output, and the same key twice gives
    the same output."""
    x = _play_obs("ram", 1, 32, 10)
    jnet, params, tnet = _pair("ram", (6, 8), True, 51, True)
    got, want = _forwards(jnet, params, tnet, x)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    k = _key_tensor(2, "cpu")
    with torch.no_grad():
        a, b = tnet(torch.from_numpy(x), k), tnet(torch.from_numpy(x), k)
    assert torch.equal(a, b) and not np.array_equal(a.numpy(), got)


def test_params_from_flax_noisy_names_and_back():
    """NoisyDense kernels transpose into ``weight_mu`` / ``weight_sigma``,
    the head modules keep their flax names, and the bridge inverts."""
    _, params, tnet = _pair("grayscale", (84, 84, 4), True, 51, True)
    sd = flax_to_state_dict(params)
    assert set(sd) == set(tnet.state_dict())
    p = params["params"]
    np.testing.assert_array_equal(
        sd["C51Head_0.advantage.weight_sigma"].numpy(),
        np.asarray(p["C51Head_0"]["advantage"]["kernel_sigma"]).T)
    np.testing.assert_array_equal(sd["conv1.weight"].numpy(),
                                  np.asarray(p["conv1"]["kernel"])
                                  .transpose(3, 2, 0, 1))
    back = state_dict_to_flax(sd, params)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params))


def test_fresh_init_follows_flax_defaults():
    """Dense and conv kernels LeCun-normal, biases 0; NoisyDense mu uniform
    in [-1/sqrt(in), 1/sqrt(in)), sigma 0.5/sqrt(in); the flax shapes."""
    _, params, _ = _pair("ram", (10, 20), True, 0, True)
    want = flax_to_state_dict(params)
    net = dqn.build_q_network("ram", (10, 20), dueling=True, noisy=True)
    net.reset_parameters(torch.Generator().manual_seed(0))
    for k, v in net.state_dict().items():
        assert v.shape == want[k].shape and v.dtype == torch.float32, k
        fin = v.shape[-1] if k.endswith("weight_mu") or \
            k.endswith("weight_sigma") else None
        if k.endswith("_sigma"):
            fin = want[k.replace("bias_sigma", "weight_sigma")].shape[1]
            assert torch.all(v == np.float32(0.5 / fin ** 0.5)), k
        elif k.endswith("_mu"):
            fin = want[k.replace("bias_mu", "weight_mu")].shape[1]
            assert float(v.abs().max()) <= fin ** -0.5, k
            if v.numel() > 100:
                assert abs(float(v.std()) / (fin ** -0.5 / 3 ** 0.5) - 1) < 0.1
    gray = dqn.build_q_network("grayscale", (84, 84, 4))
    gray.reset_parameters(torch.Generator().manual_seed(0))
    assert not gray.conv1.bias.any()
    std = (1.0 / gray.conv1.weight[0].numel()) ** 0.5
    assert abs(float(gray.conv1.weight.detach().std()) / std - 1) < 0.1
