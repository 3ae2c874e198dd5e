"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and nvcc; without them every test skips. On a
machine with a card (``--noconftest``: tests/conftest.py sets up JAX, which
the port and this file do not use):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.core import engine as E
from gym_simpletetris_tpu_torch.core.state import FIELDS, init_state
from gym_simpletetris_tpu_torch.ops import cuda_raster, cuda_step, raster
from gym_simpletetris_tpu_torch.utils.profiling import counters
import port_harness  # noqa: F401 (torch on one CPU thread)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("flags,B,mix", [
    (dict(), 333, "random"),                     # a ragged tail tile
    (dict(width=9, height=12, lock_delay=3, high_scoring=True,
          penalise_holes_increase=True), 333, "random"),
    (dict(width=24, advanced_clears=True, penalise_height_increase=True),
     333, "random"),
    (dict(width=25, penalise_height=True, penalise_holes=True), 333, "random"),
    (dict(width=32, advanced_clears=True, lock_delay=1, step_reset=True),
     333, "random"),
    (dict(width=57, height=12, penalise_height_increase=True), 333, "random"),
    (dict(width=100, reward_step=True), 333, "random"),
    (dict(width=1024, height=6, high_scoring=True), 333, "random"),
    # the warp instance's edges (a lane per row; anchor 32 by a second
    # ballot) and the thread-per-env instance for taller boards
    (dict(height=2), 333, "random"),
    (dict(height=31, penalise_height=True), 333, "random"),
    (dict(height=32, advanced_clears=True, penalise_holes=True), 333,
     "random"),
    (dict(height=33), 333, "random"),
    (dict(height=40, penalise_height_increase=True), 333, "random"),
    # batches at a warp's and a tile's edges
    (dict(), 1, "random"), (dict(), 31, "random"), (dict(), 33, "random"),
    (dict(height=32), 33, "random"),
    # every env locks; pieces against both walls
    (dict(), 333, "hard"), (dict(height=32, width=32), 333, "hard"),
    (dict(), 333, "walls"), (dict(width=9, height=12), 333, "walls"),
    (dict(width=40), 333, "walls"),
    # NW = 33 at the warp instance's tallest board (135 KB of tile), and
    # past the staged thread instance's tile (the global one)
    (dict(width=1024, height=32, penalise_holes_increase=True), 333,
     "random"),
    (dict(width=1024, height=40, penalise_height=True), 33, "hard")])
def test_step_kernel_matches_plain(dev, flags, B, mix):
    from gym_simpletetris_tpu_torch.utils.kernel_timing import (
        mix_actions, prefilled_state)
    cfg = EnvConfig(**flags)
    rng = np.random.RandomState(0)
    s_k = s_p = prefilled_state(cfg, B, rng, dev)
    n = counters()["kernel.step.launches"]
    for t in range(60):
        a = torch.as_tensor(mix_actions(mix, B, rng), device=dev)
        r = torch.as_tensor(rng.randint(1, 36, B), device=dev)
        o_k = E.engine_step(cfg, s_k, a, injected_r=r)
        o_p = E.engine_step_plain(cfg, s_p, a, injected_r=r)
        for f in FIELDS:
            assert torch.equal(getattr(o_k.state, f), getattr(o_p.state, f)), \
                (f, t)
        assert torch.equal(o_k.emitted_rows, o_p.emitted_rows), t
        assert torch.equal(o_k.reward.view(torch.int32),
                           o_p.reward.view(torch.int32)), t
        assert torch.equal(o_k.done, o_p.done), t
        s_k, s_p = o_k.state, o_p.state
    assert counters()["kernel.step.launches"] == n + 60


@pytest.mark.parametrize("w,h,B", [(10, 20, 4096), (10, 20, 33),
                                   (32, 20, 1000), (100, 31, 64),
                                   (300, 31, 64), (10, 40, 300),
                                   (57, 12, 129)])
def test_step_kernel_instances_agree(dev, w, h, B):
    """Every instance the board takes (the warp, the staged thread, the
    global thread) on the same inputs, both action mixes: every output
    bitwise equal. The staged thread instance runs 64 threads a block, and
    32 at 300 x 31 (its tile would pass 48 KB at 64)."""
    from gym_simpletetris_tpu_torch.utils.kernel_timing import step_inputs
    cfg = EnvConfig(width=w, height=h, penalise_holes=True)
    s, a, r, key = step_inputs(cfg, B, np.random.RandomState(B), dev)
    forced = cuda_step.instances_for(h, cfg.num_words)
    assert ("warp" in forced) == (h <= cuda_step.WARP_MAX_H)
    assert "thread" in forced and "thread_global" in forced
    for act in (a, torch.full_like(a, 2)):
        o = [cuda_step._launch(cfg, s, act, r, key, inst) for inst in forced]
        for x in o[1:]:
            for f in FIELDS:
                assert torch.equal(getattr(o[0].state, f),
                                   getattr(x.state, f)), f
            assert torch.equal(o[0].emitted_rows, x.emitted_rows)
            assert torch.equal(o[0].reward.view(torch.int32),
                               x.reward.view(torch.int32))
            assert torch.equal(o[0].done, x.done)


@pytest.mark.parametrize("w,h,size", [(10, 20, 84), (9, 12, 84), (24, 20, 84),
                                      (10, 20, 160), (4, 5, 83), (25, 8, 84),
                                      (32, 20, 84), (41, 20, 84),
                                      (40, 26, 512), (57, 6, 512)])
def test_raster_kernels_match_plain(dev, w, h, size):
    cfg = EnvConfig(width=w, height=h)
    rng = np.random.RandomState(w * h)
    shape = (h, 257) if cfg.num_words == 1 else (h, cfg.num_words, 257)
    words = rng.randint(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    rows = torch.from_numpy(words.view(np.int32)).to(dev)
    img = cuda_raster.rasterize_rows(cfg, rows, size)
    assert torch.equal(img, raster.rasterize_rows_plain(cfg, rows, size))
    acc = torch.as_tensor(rng.randint(0, 256, img.shape, dtype=np.uint8),
                          device=dev)
    want = raster.raster_accumulate_plain(cfg, rows, acc.clone(), size)
    assert torch.equal(cuda_raster.raster_accumulate(cfg, rows, acc, size), want)


@pytest.mark.parametrize("w,h,size,B,offset", [
    (4, 5, 83, 3, 0), (10, 20, 83, 256, 0), (10, 20, 84, 3, 0),
    (10, 20, 84, 256, 0), (10, 20, 160, 256, 0), (40, 26, 512, 3, 0),
    (32, 20, 84, 256, 0), (10, 20, 84, 256, 4), (10, 20, 84, 3, 8),
    (4, 5, 83, 3, 4), (32, 20, 84, 256, 12), (40, 26, 512, 3, 4)])
def test_raster_kernels_at_batch_sizes_and_offsets(dev, w, h, size, B, offset):
    """Kernels B and C at PPO's batch (256) and at B = 3, at 83 px (an
    image that ends mid-chunk), 160 px, 512 px on word-form rows (NW = 2),
    and into an image tensor that is a view at a 4-byte offset: bitwise
    equal to the plain versions, and nothing outside the view is written."""
    cfg = EnvConfig(width=w, height=h)
    rng = np.random.RandomState(size * B + offset)
    shape = (h, B) if cfg.num_words == 1 else (h, cfg.num_words, B)
    words = rng.randint(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    rows = torch.from_numpy(words.view(np.int32)).to(dev)
    n = B * size * size
    buf = torch.full((n + 16,), 77, dtype=torch.uint8, device=dev)
    img = buf[offset:offset + n].view(B, size, size)
    acc0 = torch.as_tensor(rng.randint(0, 256, (B, size, size), dtype=np.uint8),
                           device=dev)
    want = raster.rasterize_rows_plain(cfg, rows, size)
    if offset == 0:
        assert torch.equal(cuda_raster.rasterize_rows(cfg, rows, size), want)
    cuda_raster._launch(cfg, rows, img, size, accumulate=False)
    assert torch.equal(img, want)
    img.copy_(acc0)
    for _ in range(2):
        cuda_raster.raster_accumulate(cfg, rows, img, size)
    assert torch.equal(img, acc0 + want + want)
    assert (buf[:offset] == 77).all() and (buf[offset + n:] == 77).all()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    cfg = EnvConfig()
    rows = torch.zeros((20, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        cuda_raster.rasterize_rows(cfg, rows.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_raster.rasterize_rows(cfg, torch.zeros((8, 20), dtype=torch.int32,
                                                    device=dev).T)
    acc = torch.zeros((8, 84, 84), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="shape"):
        cuda_raster.raster_accumulate(cfg, rows, acc[:4])
    wide = EnvConfig(width=32)                   # rows must be [H, NW, B]
    with pytest.raises(ValueError, match="shape"):
        cuda_raster.rasterize_rows(wide, rows)
    s = init_state(wide, 8, 0, dev)
    with pytest.raises(ValueError, match="shape"):
        E.engine_step(wide, s.replace(rows=s.rows[:, 0]),
                      torch.zeros(8, dtype=torch.int32, device=dev))


def test_heuristic_on_the_card_matches_the_cpu(dev):
    """The lookahead policy (kernel A at 7 * B) against the CPU policy."""
    from gym_simpletetris_tpu_torch.models.heuristic import make_heuristic_policy
    cfg = EnvConfig(auto_reset=True, reward_step=True)
    policy = make_heuristic_policy(cfg)
    envs = [TetrisVectorEnv(cfg, 64, device=d) for d in ("cpu", "cuda")]
    states = [env.reset(0)[1] for env in envs]
    n = counters()["kernel.step.launches"]
    for t in range(40):
        acts = [policy(s) for s in states]
        assert torch.equal(acts[0], acts[1].cpu()), t
        states = [env.step(s, a)[1] for env, s, a in zip(envs, states, acts)]
    # lookahead + env step
    assert counters()["kernel.step.launches"] == n + 80


def test_ppo_update_on_the_card_matches_the_cpu_collection(dev, monkeypatch):
    """One float32 ram PPO update on each device from the same init: the
    collected trajectory is the same (same draws, kernel-exact env, logits
    an ulp apart at most: float32 matmuls run without TF32 by default), and
    the metrics are finite and close."""
    import functools
    from gym_simpletetris_tpu_torch.models.actor_critic import ActorCritic
    from gym_simpletetris_tpu_torch.train import ppo
    monkeypatch.setattr(ppo, "ActorCritic",
                        functools.partial(ActorCritic, dtype=torch.float32))
    cfg = ppo.PPOConfig(env=EnvConfig(obs_type="ram", auto_reset=True,
                                      reward_step=True, width=6, height=8),
                        num_envs=32, rollout_len=8, num_minibatches=2)
    runs = []
    for d in ("cpu", "cuda"):
        init_fn, update_fn, _ = ppo.make_ppo(cfg, d)
        s = init_fn(1)
        _, _, traj, _ = update_fn.collect(s)
        s2, m = update_fn(s)
        runs.append((traj, m))
    (tc, mc), (tg, mg) = runs
    for k in ("action", "done", "obs"):
        assert torch.equal(tc[k], tg[k].cpu()), k
    for k, v in mg.items():
        assert torch.isfinite(v), k
        assert abs(float(v) - float(mc[k])) <= 1e-2 * max(1.0, abs(float(mc[k]))), k


def test_f32_conv_forward_on_the_card_matches_the_cpu(dev):
    """The float32 grayscale actor-critic on the card against the CPU, within
    relative 1e-5 of the row's largest |logit| (the tolerance of the CPU
    test against flax): cuDNN's default TF32 would miss it by far."""
    from gym_simpletetris_tpu_torch.models.actor_critic import ActorCritic
    net = ActorCritic((84, 84), obs_type="grayscale", dtype=torch.float32)
    net.reset_parameters(torch.Generator().manual_seed(5))
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.choice([0.0, 128.0, 190.0], size=(48, 84, 84))
                         .astype(np.float32))
    with torch.no_grad():
        lc, vc = net(x)
        lg, vg = (t.cpu() for t in net.to(dev)(x.to(dev)))
    tol = 1e-5 * lc.abs().max(dim=1).values
    assert ((lg - lc).abs() <= tol[:, None]).all()
    assert ((vg - vc).abs() <= 1e-5 * vc.abs().max()).all()


@pytest.mark.parametrize("width", [10, 32])
def test_env_on_the_card_matches_the_cpu(dev, width):
    """The main path on CUDA (kernels) against the same path on the CPU."""
    for o in ("ram", "grayscale", "rgb"):
        cfg = EnvConfig(width=width, obs_type=o, auto_reset=True)
        envs = [TetrisVectorEnv(cfg, 64, device=d) for d in ("cpu", "cuda")]
        acts = np.random.RandomState(1).randint(0, 7, (40, 64))
        outs = []
        for env in envs:
            _, s = env.reset(0)
            final, acc, rew, done = env.rollout(s, acts)
            outs.append((final.rows.cpu(), acc.cpu(), rew.cpu(), done.cpu()))
        for a, b in zip(*outs):
            assert torch.equal(a, b), o


def test_f32_nature_dqn_on_the_card_matches_the_cpu(dev):
    """The float32 NatureDQN (four stacked frames, C51 + dueling + noisy,
    the same noise key) on the card against the CPU, within relative 1e-5
    of the row's largest |output|: its convolutions run in IEEE float32
    (``actor_critic._ieee_conv``), not cuDNN's default TF32."""
    from gym_simpletetris_tpu_torch.core.state import _key_tensor
    from gym_simpletetris_tpu_torch.models.dqn import build_q_network
    net = build_q_network("grayscale", (84, 84, 4), dueling=True,
                          num_atoms=51, noisy=True, dtype=torch.float32)
    net.reset_parameters(torch.Generator().manual_seed(3))
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.choice([0.0, 128.0, 190.0],
                                    size=(16, 84, 84, 4)).astype(np.float32))
    with torch.no_grad():
        for key in (None, 7):
            kc = None if key is None else _key_tensor(key, "cpu")
            kg = None if key is None else _key_tensor(key, dev)
            out_c = net.to("cpu")(x, kc)
            out_g = net.to(dev)(x.to(dev), kg).cpu()
            tol = 1e-5 * out_c.abs().amax(dim=(1, 2), keepdim=True)
            assert ((out_g - out_c).abs() <= tol).all()


def test_replay_sums_on_the_card_match_the_cpu(dev):
    """``_cumsum_f32`` and ``_sum_f32`` (XLA's order) and ``_powf`` give the
    same bits on the card as on the CPU."""
    from gym_simpletetris_tpu_torch.train import replay
    rng = np.random.RandomState(0)
    for shape in ((7,), (4097,), (100000,), (64, 1024), (256, 1024)):
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
        for fn in (replay._cumsum_f32, replay._sum_f32):
            assert torch.equal(fn(x.to(dev)).cpu(), fn(x)), (fn, shape)
    x = torch.from_numpy((rng.rand(100000) * 50 + 1e-3).astype(np.float32))
    assert torch.equal(replay._powf(x.to(dev), 0.6).cpu(),
                       replay._powf(x, 0.6))


def test_threefry_normal_and_randint_on_the_card_match_the_cpu(dev):
    from gym_simpletetris_tpu_torch.core import threefry
    from gym_simpletetris_tpu_torch.core.state import _key_tensor
    for seed in (0, 5, 123):
        kc, kg = _key_tensor(seed, "cpu"), _key_tensor(seed, dev)
        assert torch.equal(threefry.normal(kg, (3136, 1)).cpu(),
                           threefry.normal(kc, (3136, 1)))
        n = torch.tensor(1000, dtype=torch.int32)
        assert torch.equal(threefry.randint(kg, (4096,), 0, n.to(dev)).cpu(),
                           threefry.randint(kc, (4096,), 0, n))


def _clone(x):
    """A deep copy of a trainer state's tensors (the replay ring is written
    in place)."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def _plain_path(monkeypatch):
    """api.env's step and raster on their plain versions."""
    from gym_simpletetris_tpu_torch.api import env as api_env
    monkeypatch.setattr(E, "engine_step", E.engine_step_plain)
    monkeypatch.setattr(api_env, "rasterize_rows", raster.rasterize_rows_plain)


def test_obs_ring_actor_step_kernels_match_plain(dev, monkeypatch):
    """One obs-ring actor step of the grayscale Rainbow (4 frames, C51,
    dueling, noisy) through kernels A and B, bitwise equal to the same step
    on the plain step and raster: env, observation stack, key and ring."""
    from gym_simpletetris_tpu_torch.train import dqn
    cfg = dqn.DQNConfig(
        env=EnvConfig(obs_type="grayscale", auto_reset=True,
                      reward_step=True),
        num_envs=64, buffer_capacity=64 * 16, learn_batch=64,
        frame_stack=4, n_step=3, prioritized=True, distributional=True,
        dueling=True, noisy=True, frame_ring=True, ring_stacks=True)
    init_fn, _, chunk_fn, _ = dqn.make_train(cfg, dev)
    s = init_fn(0)
    for _ in range(3):
        s, _ = chunk_fn.actor_half(s)
    c = counters()
    a0, b0 = c["kernel.step.launches"], c["kernel.raster.launches"]
    k, _ = chunk_fn.actor_half(_clone(s))
    assert counters()["kernel.step.launches"] == a0 + 1
    assert counters()["kernel.raster.launches"] == b0 + 1
    _plain_path(monkeypatch)
    p, _ = chunk_fn.actor_half(_clone(s))
    assert counters()["kernel.step.launches"] == a0 + 1
    for f in FIELDS:
        assert torch.equal(getattr(k.env_state, f), getattr(p.env_state, f)), f
    assert torch.equal(k.obs, p.obs) and torch.equal(k.key, p.key)
    for f in ("frame", "action", "reward", "done", "priority", "ptr"):
        assert torch.equal(getattr(k.replay, f), getattr(p.replay, f)), f


def test_es_generation_kernels_match_plain(dev, monkeypatch):
    """One ES generation on ram (pop 16 x 2, horizon 32, RamDQN 64 / 64)
    through kernel A, bitwise equal to it on the plain step: theta, key
    and every metric."""
    from gym_simpletetris_tpu_torch.train import es
    cfg = es.ESConfig(pop_size=16, envs_per_member=2, horizon=32)
    init_fn, gen_fn, _ = es.make_es(cfg, dev)
    s0 = init_fn(0)
    a0 = counters()["kernel.step.launches"]
    k, mk = gen_fn(_clone(s0))
    assert counters()["kernel.step.launches"] == a0 + 32
    _plain_path(monkeypatch)
    p, mp = gen_fn(_clone(s0))
    assert counters()["kernel.step.launches"] == a0 + 32
    assert torch.equal(k.theta, p.theta) and torch.equal(k.key, p.key)
    for name in mk:
        assert torch.equal(mk[name], mp[name]), name
    assert not torch.equal(k.theta, s0.theta)


def _shim_run(kw, steps, seed):
    """``steps`` random actions (out-of-range ones included) of the gym
    shim on the card, resetting on done: every output, and the renders at
    the end."""
    from gym_simpletetris_tpu_torch import make
    env = make("SimpleTetris-v0", backend="cuda", seed=seed, **kw)
    rng = np.random.RandomState(seed)
    out = [env.reset(return_info=True)]
    for _ in range(steps):
        r = env.step(int(rng.randint(-1, 8)))
        out.append(r)
        if r[2]:
            out.append(env.reset(return_info=True))
    out.append((env.render("rgb_array"), env.valid_action_count()))
    return out


@pytest.mark.parametrize("kw", [
    dict(obs_type="ram", reward_step=True),
    dict(obs_type="grayscale", extend_dims=True, lock_delay=1),
    dict(obs_type="rgb", width=7, height=13, advanced_clears=True)])
def test_shim_on_the_card_matches_plain(dev, monkeypatch, kw):
    """The single-env shim at B = 1 through kernels A and B, bitwise equal
    to the same run on the plain step and raster, none of which launches a
    kernel."""
    c = counters()
    a0, b0 = c["kernel.step.launches"], c["kernel.raster.launches"]
    k = _shim_run(kw, 120, 3)
    c = counters()
    a1, b1 = c["kernel.step.launches"], c["kernel.raster.launches"]
    assert a1 - a0 == 120
    assert b1 - b0 > (0 if kw["obs_type"] == "ram" else 120)
    _plain_path(monkeypatch)
    p = _shim_run(kw, 120, 3)
    c = counters()
    assert (c["kernel.step.launches"], c["kernel.raster.launches"]) == (a1, b1)
    assert len(k) == len(p)
    for x, y in zip(k, p):
        np.testing.assert_array_equal(x[0], y[0])
        assert x[1:] == y[1:]


@pytest.mark.parametrize("w,h", [(10, 20), (7, 13), (32, 20)])
def test_render_kernel_at_160_and_512(dev, w, h):
    """``render('rgb_array')`` (kernel B at 160 px) and the human image
    (kernel B at 512 px, transposed) against the host raster."""
    from gym_simpletetris_tpu_torch import TetrisEnv
    from gym_simpletetris_tpu_torch.api.gym_compat import human_image
    env = TetrisEnv(width=w, height=h, seed=1, device="cuda")
    env.reset()
    for a in [2, 0, 2, 1, 1, 2, 5, 2, 0, 0, 2]:
        env.step(a)
    board = env._board()
    b0 = counters()["kernel.raster.launches"]
    rgb = env.render("rgb_array")
    human = human_image(env.config, env._rows(), 512)
    assert counters()["kernel.raster.launches"] == b0 + 2
    np.testing.assert_array_equal(
        rgb[..., 0], raster.rasterize_host(board.T, h, w, 160))
    np.testing.assert_array_equal(
        human[..., 0], raster.rasterize_host(board, w, h, 512))
