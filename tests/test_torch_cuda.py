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

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("flags", [
    dict(), dict(width=9, height=12, lock_delay=3, high_scoring=True,
                 penalise_holes_increase=True),
    dict(width=24, advanced_clears=True, penalise_height_increase=True),
    dict(width=25, penalise_height=True, penalise_holes=True),
    dict(width=32, advanced_clears=True, lock_delay=1, step_reset=True),
    dict(width=57, height=12, penalise_height_increase=True),
    dict(width=100, reward_step=True),
    dict(width=1024, height=6, high_scoring=True)])
def test_step_kernel_matches_plain(dev, flags):
    cfg = EnvConfig(**flags)
    B = 333                                      # a ragged tail block
    rng = np.random.RandomState(0)
    s, _ = E.engine_clear(cfg, init_state(cfg, B, 0, dev))
    s_k = s_p = s
    n = cuda_step.step.launches
    for t in range(60):
        a = torch.as_tensor(rng.randint(0, 7, B), device=dev)
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
    assert cuda_step.step.launches == n + 60


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
    n = cuda_step.step.launches
    for t in range(40):
        acts = [policy(s) for s in states]
        assert torch.equal(acts[0], acts[1].cpu()), t
        states = [env.step(s, a)[1] for env, s, a in zip(envs, states, acts)]
    assert cuda_step.step.launches == n + 80     # lookahead + env step


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
