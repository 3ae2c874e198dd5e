"""The noise kernel (``csrc/noise.cu``, ``ops/cuda_noise.py``) against the
plain noisy weights (``NoisyDense.noisy_weights_plain``: ``threefry``'s
``flax_rng``, ``split`` and ``normal``, the float64 multiply-adds), and the
dispatch that keeps CPU layers on the plain version.

The ``cuda`` tests need a CUDA device and nvcc; without them they skip. On
a machine with a card (``--noconftest``: tests/conftest.py sets up JAX,
which the port and this file do not use):

    python -m pytest --noconftest tests/test_torch_noise.py -q -m cuda

The rest run on the CPU.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu_torch import EnvConfig
from gym_simpletetris_tpu_torch.core import threefry
from gym_simpletetris_tpu_torch.core.state import _key_tensor
from gym_simpletetris_tpu_torch.models import dqn as models
from gym_simpletetris_tpu_torch.models.actor_critic import ModelShard
from gym_simpletetris_tpu_torch.ops import _build, cuda_noise
from gym_simpletetris_tpu_torch.train import dqn
from gym_simpletetris_tpu_torch.utils.profiling import counters
import port_harness  # noqa: F401 (torch on one CPU thread)

# cuBLAS reads it when it starts: deterministic algorithms need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# the edge keys of tests/test_torch_threefry.py, then random ones
EDGE_KEYS = ((0, 0), (0, 1), (0xFFFFFFFF, 0xFFFFFFFF),
             (0x80000000, 0x7FFFFFFF))

# every noisy network the trainers build: (obs type, obs shape, dueling,
# atoms); the first is the flagship Rainbow's
NETWORKS = [("grayscale", (84, 84, 4), True, 51),
            ("grayscale", (84, 84, 4), False, 0),
            ("ram", (10, 20), False, 0), ("ram", (10, 20), True, 0),
            ("ram", (10, 20), False, 51), ("ram", (10, 20, 4), True, 51)]


def _keys(rng, n=4):
    words = rng.randint(0, 2 ** 32, (n, 2), dtype=np.uint64)
    return [np.asarray(k, np.uint32) for k in EDGE_KEYS] + [
        w.astype(np.uint32) for w in words]


def _network(spec, device="cpu"):
    obs_type, shape, dueling, atoms = spec
    net = models.build_q_network(obs_type, shape, dueling=dueling,
                                 num_atoms=atoms, noisy=True)
    net.reset_parameters(torch.Generator().manual_seed(len(shape) + atoms))
    gen = torch.Generator().manual_seed(atoms + 7)
    with torch.no_grad():    # sigmas that differ element by element
        for m in net.modules():
            if isinstance(m, models.NoisyDense):
                for p in (m.weight_sigma, m.bias_sigma):
                    p.mul_(torch.rand(p.shape, generator=gen) * 3)
    return net.to(device)


def _noisy_layers(net):
    return [m for m in net.modules() if isinstance(m, models.NoisyDense)]


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


# ---------------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _layer_shapes():
    """(in, features, path) of every noisy layer of NETWORKS, once each."""
    seen = {}
    for spec in NETWORKS:
        for m in _noisy_layers(models.build_q_network(
                spec[0], spec[1], dueling=spec[2], num_atoms=spec[3],
                noisy=True)):
            seen.setdefault((m.weight_mu.shape[1], m.features, m.path), spec)
    return seen


LAYERS = _layer_shapes()


def _layer(shape, device):
    return next(m for m in _noisy_layers(_network(LAYERS[shape], device))
                if (m.weight_mu.shape[1], m.features, m.path) == shape)


def _blocks(features):
    """(at, rows) of the whole layer and of the last rank's block at 2 and
    4 model ranks, where the features split."""
    return [(0, features)] + [((n - 1) * features // n, features // n)
                              for n in (2, 4) if features % n == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(LAYERS), ids=str)
def test_noise_kernel_matches_plain(dev, shape):
    """(w, b) and the gradients of the four parameters, bitwise against
    the plain version on the CPU (the tier-1 tests' oracle) and autograd
    through its float64 multiply-adds, for every key and block."""
    cpu = _layer(shape, "cpu")
    card = _layer(shape, dev)
    params = lambda m: (m.weight_mu, m.weight_sigma, m.bias_mu, m.bias_sigma)
    rng = np.random.RandomState(shape[0] + shape[1])
    for words in _keys(rng):
        w_p, b_p = cpu.noisy_weights_plain(_key_tensor(words, "cpu"))
        for at, rows in _blocks(shape[1]):
            gw = torch.randn(rows, shape[0], generator=torch.Generator()
                             .manual_seed(at + 1))
            gb = torch.randn(shape[1])
            want = torch.autograd.grad(
                (w_p[at:at + rows] * gw).sum() + (b_p * gb).sum(),
                params(cpu), retain_graph=True)
            mu_w, sig_w, mu_b, sig_b = (p.detach().requires_grad_()
                                        for p in params(card))
            rows_w = (mu_w[at:at + rows].detach().requires_grad_(),
                      sig_w[at:at + rows].detach().requires_grad_())
            w, b = cuda_noise.noisy_weights(
                _key_tensor(words, dev), card.fold, *rows_w, mu_b, sig_b, at)
            assert torch.equal(_bits(w), _bits(w_p[at:at + rows])), \
                (words, at)
            assert torch.equal(_bits(b), _bits(b_p)), (words, at)
            got = torch.autograd.grad(
                (w * gw.to(dev)).sum() + (b * gb.to(dev)).sum(),
                rows_w + (mu_b, sig_b))
            for name, g, h in zip(("weight_mu", "weight_sigma"), got,
                                  want):
                assert torch.equal(_bits(g), _bits(h[at:at + rows])), \
                    (name, words, at)
            for name, g, h in zip(("bias_mu", "bias_sigma"), got[2:],
                                  want[2:]):
                assert torch.equal(_bits(g), _bits(h)), (name, words, at)


@pytest.mark.cuda
def test_noise_kernel_vectors_over_many_draws(dev):
    """e_in over 2**22 draws a key (most float32 mantissas a uniform can
    take, over the keys), bitwise the plain normals under f on the card."""
    in_f, features = 1 << 22, 32
    z = lambda *s: torch.zeros(s, device=dev)
    fold = threefry.flax_fold("dense", 1)
    rng = np.random.RandomState(3)
    for words in _keys(rng):
        key = _key_tensor(words, dev)
        _, _, e = cuda_noise._launch(key, fold, z(features, in_f),
                                     z(features, in_f), z(features),
                                     z(features), 0)
        ki, ko = threefry.split(threefry.flax_rng(key, "dense", 1))
        for got, k, n in ((e[:in_f], ki, in_f), (e[in_f:], ko, features)):
            want = models._signed_sqrt(threefry.normal(k, (n,)))
            assert torch.equal(_bits(got), _bits(want)), words


@pytest.mark.cuda
def test_noisy_layer_on_the_card_is_one_launch(dev):
    """A CUDA NoisyDense's draw is one launch, equal to its plain version,
    in a model-axis block too."""
    card = _layer((3136, 512, ("dense",)), dev)
    key = _key_tensor(np.array([5, 9], np.uint32), dev)
    for shard in (None, ModelShard(None, 1, 2)):
        if shard is not None:   # the rank's rows, as train.sharding holds
            card.shard = shard
            for name in ("weight_mu", "weight_sigma"):
                p = getattr(card, name)
                setattr(card, name, torch.nn.Parameter(p[256:].clone()))
        n = counters()
        got = card.noisy_weights(key)
        m = counters()
        assert m["kernel.noise.launches"] - n["kernel.noise.launches"] == 1
        assert m["model.noise_draws"] - n["model.noise_draws"] == 1
        want = card.noisy_weights_plain(key)
        assert counters()["kernel.noise.launches"] == \
            m["kernel.noise.launches"]     # the plain version launches none
        assert got[0].shape == (256 if shard else 512, 3136)
        for g, h in zip(got, want):
            assert torch.equal(_bits(g), _bits(h))


def _clone(x):
    """A deep copy of a trainer state's tensors (the ring is written in
    place)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


@pytest.mark.cuda
def test_train_chunk_on_the_kernel_equals_the_plain_noise(dev, monkeypatch):
    """One ``train_chunk_fn`` call of a small grayscale Rainbow (the
    flagship's network and obs ring, 32 envs), learning on: every noisy
    draw is one launch, and the call's parameters, Adam state and
    priorities are bitwise those of the same call on the plain noise,
    deterministic algorithms on."""
    cfg = dqn.DQNConfig(
        env=EnvConfig(obs_type="grayscale", auto_reset=True,
                      reward_step=True, penalise_height=True),
        num_envs=32, buffer_capacity=32 * 64, learn_batch=64,
        learn_starts=256, frame_stack=4, n_step=3, prioritized=True,
        distributional=True, dueling=True, noisy=True, learn_every=4,
        frame_ring=True, ring_stacks=True)
    init_fn, _, chunk_fn, _ = dqn.make_train(cfg, "cuda")
    state, _ = chunk_fn(init_fn(7), 16)        # learning on from here
    steps = 16
    torch.use_deterministic_algorithms(True)
    try:
        n = counters()
        s_k, _ = chunk_fn(_clone(state), steps)
        m = counters()
        monkeypatch.setattr(models.NoisyDense, "noisy_weights",
                            models.NoisyDense.noisy_weights_plain)
        s_p, _ = chunk_fn(_clone(state), steps)
    finally:
        torch.use_deterministic_algorithms(False)
    draws = m["model.noise_draws"] - n["model.noise_draws"]
    updates = steps // cfg.learn_every
    assert int(s_k.learn_steps) - int(state.learn_steps) == updates
    assert draws == 3 * (steps + 3 * updates)   # three layers a forward
    assert m["kernel.noise.launches"] - n["kernel.noise.launches"] == draws
    assert counters()["kernel.noise.launches"] == m["kernel.noise.launches"]
    pairs = {"priority": (s_k.replay.priority, s_p.replay.priority),
             "count": (s_k.opt_state["count"], s_p.opt_state["count"])}
    for k in s_k.params:
        pairs["params." + k] = (s_k.params[k], s_p.params[k])
        for mom in ("mu", "nu"):
            pairs[f"{mom}.{k}"] = (s_k.opt_state[mom][k],
                                   s_p.opt_state[mom][k])
    assert not torch.equal(s_k.params["dense.weight_sigma"],
                           state.params["dense.weight_sigma"])
    diff = [k for k, (a, b) in pairs.items() if not torch.equal(a, b)]
    assert not diff, diff[:8]


# ----------------------------------------------------------------- the CPU


@pytest.mark.parametrize("spec", NETWORKS, ids=str)
def test_cached_fold_is_what_flax_rng_folds_in(spec):
    """Each layer's cached fold constant keys the same noise as
    ``flax_rng`` over its path and rng counter 1, and is the SHA-1 prefix
    of that path."""
    import hashlib
    layers = _noisy_layers(models.build_q_network(
        spec[0], spec[1], dueling=spec[2], num_atoms=spec[3], noisy=True))
    assert layers
    for m in layers:
        sha = hashlib.sha1("".join(m.path).encode() + b"\x01").digest()
        assert m.fold == int.from_bytes(sha[:4], "big")
        for words in _keys(np.random.RandomState(len(m.path)), 2):
            key = _key_tensor(words, "cpu")
            assert torch.equal(threefry.fold_in(key, m.fold),
                               threefry.flax_rng(key, *m.path, 1))


@pytest.mark.parametrize("spec", NETWORKS, ids=str)
def test_cpu_noisy_layers_stay_plain(spec, monkeypatch):
    """A CPU network never reaches the noise kernel's wrapper, and each
    layer's noisy weights are bitwise the plain formula (flax_rng, split,
    two normals under f, float64 multiply-adds)."""
    def refuse(*a, **k):
        raise AssertionError("a CPU layer reached ops/cuda_noise")
    monkeypatch.setattr(cuda_noise, "noisy_weights", refuse)
    monkeypatch.setattr(cuda_noise, "_launch", refuse)
    net = _network(spec)
    key = _key_tensor(np.array([3, 0xFFFFFFFF], np.uint32), "cpu")
    n = counters()["model.noise_draws"]
    with torch.no_grad():
        out = net(torch.zeros((2,) + spec[1]), key)
    assert torch.isfinite(out).all()
    assert counters()["model.noise_draws"] - n == len(_noisy_layers(net))
    for m in _noisy_layers(net):
        w, b = m.noisy_weights(key)
        ki, ko = threefry.split(threefry.flax_rng(key, *m.path, 1))
        e_in = models._signed_sqrt(threefry.normal(ki, (m.weight_mu.shape[1],
                                                        1)))
        e_out = models._signed_sqrt(threefry.normal(ko, (1, m.features)))
        want_w = models._fma_f32(m.weight_sigma, (e_in * e_out).T,
                                 m.weight_mu)
        want_b = models._fma_f32(m.bias_sigma, e_out[0], m.bias_mu)
        assert torch.equal(_bits(w), _bits(want_w)), m.path
        assert torch.equal(_bits(b), _bits(want_b)), m.path


def _args(**over):
    a = dict(key=torch.zeros(2, dtype=torch.int32), fold=1,
             w_mu=torch.zeros(4, 3), w_sigma=torch.zeros(4, 3),
             b_mu=torch.zeros(4), b_sigma=torch.zeros(4))
    a.update(over)
    return a


@pytest.mark.parametrize("over,err,match", [
    ({}, ValueError, "CUDA device"),
    ({"key": torch.zeros(2, dtype=torch.int64)}, TypeError, "key has dtype"),
    ({"w_mu": torch.zeros(4, 3, dtype=torch.float64)}, TypeError,
     "weight_mu has dtype"),
    ({"w_sigma": torch.zeros(4, 3, dtype=torch.bfloat16)}, TypeError,
     "weight_sigma has dtype"),
    ({"b_sigma": torch.zeros(4, dtype=torch.float16)}, TypeError,
     "bias_sigma has dtype"),
], ids=["cpu", "key_int64", "mu_f64", "sigma_bf16", "bias_f16"])
def test_wrapper_rejects_cpu_tensors_and_wrong_dtypes(over, err, match,
                                                      monkeypatch):
    """The wrapper refuses before it loads the library (no nvcc here)."""
    def no_build():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(_build, "load_library", no_build)
    with pytest.raises(err, match=match):
        cuda_noise.noisy_weights(**_args(**over))
