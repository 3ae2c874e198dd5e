"""The port's ``utils/`` (video, metrics, profiling) on the CPU: video frames
and recorded episodes bitwise against the JAX package's, the GIF writer,
the metric sinks, and the profiling hooks."""

import json
import os

import numpy as np
import pytest
import torch

from gym_simpletetris_tpu import EnvConfig as JaxConfig
from gym_simpletetris_tpu import TetrisVectorEnv as JaxVectorEnv
from gym_simpletetris_tpu.utils import video as jax_video
from gym_simpletetris_tpu_torch import EnvConfig, TetrisVectorEnv
from gym_simpletetris_tpu_torch.utils import video
from gym_simpletetris_tpu_torch.utils.metrics import MetricLogger
from gym_simpletetris_tpu_torch.utils.profiling import (
    block, cost_analysis, debug_mode, trace)
import port_harness  # noqa: F401 (torch on one CPU thread)


@pytest.mark.parametrize("kw,size", [(dict(), 160), (dict(width=7, height=13), 96),
                                     (dict(width=30, height=9), 160)])
def test_frames_from_rows_against_jax(kw, size):
    """The port's frames of a rows history (torch tensors, or the uint32
    numpy rows JAX holds) equal the JAX package's, for each env index."""
    cfg = EnvConfig(auto_reset=True, **kw)
    env = TetrisVectorEnv(cfg, 3, device="cpu")
    _, s = env.reset(2)
    hist = [env.render_rows(s)]
    rng = np.random.RandomState(0)
    for _ in range(12):
        _, s, *_ = env.step(s, rng.randint(0, 7, 3))
        hist.append(env.render_rows(s))
    as_u32 = [r.numpy().view(np.uint32) for r in hist]
    jcfg = JaxConfig(auto_reset=True, **kw)
    for i in (0, 2):
        want = jax_video.frames_from_rows(jcfg, as_u32, size=size,
                                          env_index=i)
        got = video.frames_from_rows(cfg, hist, size=size, env_index=i)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            video.frames_from_rows(cfg, as_u32, size=size, env_index=i), want)


def test_record_episode_against_jax():
    """The same seed gives the same episode (random actions from
    ``RandomState(seed)``, the env from ``PRNGKey(seed)``) and the same
    frames; and a policy's actions are what it returns."""
    kw = dict(width=6, height=10, reward_step=True)
    jenv = JaxVectorEnv(JaxConfig(**kw), 2)
    env = TetrisVectorEnv(EnvConfig(**kw), 2, device="cpu")
    want = jax_video.record_episode(jenv, max_steps=300, seed=4)
    got = video.record_episode(env, max_steps=300, seed=4)
    assert 2 < len(got) < 301
    np.testing.assert_array_equal(got, want)
    calls = []

    def policy(obs, t):
        calls.append(t)
        return np.full(2, 2)
    got = video.record_episode(env, policy, max_steps=5, size=84, seed=1)
    assert got.shape[1:] == (84, 84, 3) and calls == list(range(len(got) - 1))


def test_write_gif(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    frames = np.zeros((3, 16, 16, 3), np.uint8)
    frames[1] = 128
    frames[2] = 190
    path = video.write_gif(frames, str(tmp_path / "ep.gif"), fps=4)
    with PIL.open(path) as im:
        assert im.n_frames == 3 and im.size == (16, 16)
        assert im.info["duration"] == 250


def test_metric_logger_sinks(tmp_path, capsys):
    jl, tb = tmp_path / "m.jsonl", tmp_path / "tb"
    with MetricLogger(jsonl_path=str(jl), tensorboard_dir=str(tb)) as log:
        log.log({"loss": 1.5, "q": np.float32(2.0)}, step=1)
        log.log({"loss": torch.tensor(1.0), "q": 3}, step=2)
    recs = [json.loads(line) for line in jl.read_text().splitlines()]
    assert recs == [{"loss": 1.5, "q": 2.0, "step": 1},
                    {"loss": 1.0, "q": 3.0, "step": 2}]
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert out == recs
    assert any(tb.iterdir())   # a tensorboard event file


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with trace(str(tmp_path / "tr")) as prof:
        block(a @ a)
    assert prof is not None
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_cost_analysis_reports_flops():
    a = torch.zeros(128, 128)
    ca = cost_analysis(torch.matmul, a, a)
    assert ca["flops"] == 2 * 128 ** 3
    assert cost_analysis(lambda x: x + 1, a)["flops"] == 0


def test_debug_mode_catches_nan():
    x = torch.zeros(4)
    with debug_mode():
        torch.ones(4) / 2 + x
        with pytest.raises(FloatingPointError):
            x / x
        w = torch.zeros(4, requires_grad=True)
        # a NaN made in the backward only (0 * the infinite slope of sqrt
        # at 0): anomaly detection raises there
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(w) * 0).sum().backward()
    x / x          # outside the scope: no check


def test_block_returns_its_argument():
    t = {"a": torch.ones(2), "b": 3}
    assert block(t) is t
    assert block([torch.ones(1), (torch.zeros(1),)])[1][0].item() == 0
