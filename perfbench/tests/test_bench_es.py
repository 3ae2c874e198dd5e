"""The ES cell (``es_gray.train_pop512``) and the hard-drop rollout
(``v0_ram.rollout_b4096_hard``): the ES entry on the CPU at a small
population (correct, and not with the control), the frozen operation and
byte counts against a hand count and torch's FLOP counter on the port's own
population forward, the three readers on a synthetic trace (their
arithmetic, and nothing without spans or on a window they cannot split),
the hard-drop entry's actions and its control, and the ES reference's
imports.

    python -m pytest perfbench/tests/test_bench_es.py -q
"""

import ast

import pytest
import torch

from gym_simpletetris_tpu_torch.core.config import EnvConfig
from gym_simpletetris_tpu_torch.train import es
from gym_simpletetris_tpu_torch.utils import profiling

from perfbench import es_flops, harness
from perfbench.trace import Event, Trace

CELL, HARD = "es_gray.train_pop512", "v0_ram.rollout_b4096_hard"
BENCH = harness.load_benchmark()
AGENT = harness.cell_parts(BENCH, CELL)[2]["agent"]
SMALL = dict(batch=8, steps_per_call=4, trace_calls=1)
READERS = ("es_train_mfu_pct", "member_forward_hbm_pct",
           "es_perturb_ms_per_gen")
US = 1000

# torch on one CPU thread in every worker of this suite (pytest-xdist
# imports every test module in each worker): six workers with a thread a
# core each oversubscribe the host, and the ES cell's passes over 1.68M
# parameters then run a hundred times slower than alone.
torch.set_num_threads(1)


def test_the_entry_is_correct_on_the_cpu_and_its_control_is_not():
    r = harness.run(CELL, 2 ** 31 + 2024, 0.2, False, device="cpu",
                    overrides=SMALL)
    assert r["correct"] is True, r["checks"]
    assert (r["compared"]["members"], r["compared"]["envs"]) == (2, 8)
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert r["compared"]["q_err"] <= 2.5
    c = harness.run(CELL, 2 ** 31 + 2025, 0.2, False, device="cpu",
                    control=True, overrides=SMALL)
    assert c["correct"] is False
    bad = {k for k, v in c["checks"].items() if v["value"] > v["limit"]}
    # the reference below bf16 in the program's place: its perturbations,
    # Q-values and update fail; the env and the fitness are the program's
    assert bad == {"eps_out_of_tol", "q_out_of_tol", "grad_out_of_tol",
                   "theta_out_of_tol"}, c["checks"]
    assert c["compared"]["q_err"] > 2.5


def test_the_counts_match_a_hand_count():
    layers = {n: (m, p) for n, m, p in es_flops.layer_shapes(AGENT)}
    assert layers == {"conv1": (20 * 20 * 32 * 8 * 8, 32 * 64 + 32),
                      "conv2": (9 * 9 * 64 * 4 * 4 * 32, 64 * 16 * 32 + 64),
                      "conv3": (7 * 7 * 64 * 3 * 3 * 64, 64 * 9 * 64 + 64),
                      "dense": (3136 * 512, 3136 * 512 + 512),
                      "q": (512 * 7, 512 * 7 + 7)}
    assert es_flops.forward_macs(AGENT) == 6_888_960
    assert es_flops.parameters(AGENT) == AGENT["parameters"] == 1_681_575
    assert es_flops.step_flops(AGENT, 2048) == 2 * 2048 * 6_888_960
    # the parameters in the bf16 compute dtype, the frames in float32
    assert AGENT["compute_dtype"] == "bfloat16"
    assert es_flops.step_bytes(AGENT, 2048) == \
        2 * 512 * 1_681_575 + 4 * 2048 * 84 * 84 == 1_779_735_552


def test_the_counts_are_what_the_port_computes():
    """torch's FLOP counter over the port's population forward of 2
    members on 2 envs each, and the parameters its network holds."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = es.ESConfig(env=EnvConfig(obs_type="grayscale", auto_reset=True,
                                    reward_step=True), pop_size=2,
                      envs_per_member=2, horizon=1)
    _, gen, net = es.make_es(cfg, "cpu")
    theta = gen.ravel(net.state_dict())
    assert theta.numel() == es_flops.parameters(AGENT)
    members = gen.unravel(torch.stack([theta, -theta]))
    obs = torch.zeros(2, 2, 84, 84)
    count = FlopCounterMode(display=False)
    with count, torch.no_grad():
        gen.member_forward(members, obs)
    assert count.get_total_flops() == es_flops.step_flops(AGENT, 4)


@pytest.fixture
def spans(monkeypatch):
    """A profiler's flag set, the recorder's clock in µs: one generation's
    spans, a perturbation [0, 50], a rollout [50, 400] of two forwards,
    an update [400, 450]."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    now = [0]
    monkeypatch.setattr(profiling.time, "time_ns", lambda: now[0])
    profiling.reset()
    stack = []
    for t, *name in ((0, "es.perturb"), (50,), (50, "es.rollout"),
                     (60, "es.forward"), (70,), (200, "es.forward"), (210,),
                     (400,), (400, "es.update"), (450,)):
        now[0] = t * US
        if name:
            stack.append(profiling.span(name[0]))
            stack[-1].__enter__()
        else:
            stack.pop().__exit__(None, None, None)
    yield
    profiling.reset()


def _steps(t0: int):
    """A step's device ops from ``t0`` µs in the port's stream order: the
    forward (2 ops), the argmax, kernel A, the draw and reset kernels, the
    info's subtraction, the image, the return's sum."""
    names = ("cudnn_conv", "gemm", "argmax", "step_warp_kernel<1>",
             "spawn_draw_kernel", "reset_kernel", "sub", "raster_kernel<4>",
             "add")
    lens = (40, 50, 1, 2, 1, 1, 1, 3, 1)
    out, t = [], t0
    for n, d in zip(names, lens):
        out.append(Event(n, t * US, (t + d) * US))
        t += d
    return out, t


def _trace(steps: int = 2):
    """One generation: the perturbation [0, 100] in two ops, the reset's
    draw, reset kernel and image, ``steps`` steps, the update's op."""
    ev = [Event("normal", 0, 60 * US), Event("fma", 60 * US, 100 * US),
          Event("spawn_draw_kernel", 100 * US, 101 * US),
          Event("reset_kernel", 101 * US, 102 * US),
          Event("raster_kernel<4>", 102 * US, 105 * US)]
    t = 105
    for _ in range(steps):
        more, t = _steps(t)
        ev += more
    ev.append(Event("update", t * US, (t + 20) * US))
    return Trace(ev, [], [], 0, 1000 * US, steps, 2048,
                 {"agent": AGENT}, 1)


def _read(name, trace):
    return harness.reader("metrics", name).read(trace)


def test_the_readers_arithmetic(spans):
    t = _trace()
    flops = 2 * es_flops.step_flops(AGENT, 2048)
    assert _read("es_train_mfu_pct", t) == pytest.approx(
        100 * flops / (1e-3 * 989.4e12))
    # the forwards: every op from the first step's to the second step's
    # image but the env kernels, and the first step's return sum: 2 x (40 +
    # 50 + 1 + 1) + 1 µs
    forward_s = (2 * 92 + 1) * 1e-6
    assert _read("member_forward_hbm_pct", t) == pytest.approx(
        100 * 2 * es_flops.step_bytes(AGENT, 2048) / 3.35e12 / forward_s)
    assert _read("es_perturb_ms_per_gen", t) == pytest.approx(0.1)


def test_the_readers_return_nothing_they_cannot_read(spans, monkeypatch):
    for name in READERS:
        # a window outside the spans; a card that ran nothing
        assert _read(name, _trace()._replace(start=500 * US)) is None
        assert _read(name, _trace()._replace(kernels=[])) is None
    # two forward spans but three steps on the card: no split
    for name in READERS[1:]:
        assert _read(name, _trace(steps=3)) is None
    monkeypatch.delattr(profiling, "spans_between")
    for name in READERS:
        assert _read(name, _trace()) is None


def test_the_hard_drop_entry_drops_every_piece():
    cell, _, env, mix = harness.cell_parts(BENCH, HARD)
    mix = dict(mix, batch=8, steps_per_call=16, compare_envs=8)
    drv = harness.entry(mix["entry"]).Entry(env, mix, harness.seeds_of(9),
                                            "cpu")
    drv.setup()
    assert drv.actions.shape == (1, 16, 8)
    assert bool((drv.actions == 2).all())
    # a locked piece a step: episodes end within a few dozen steps
    assert int(drv.got[0]["done"].sum()) > 0
    r = harness.run(HARD, 2 ** 31 + 99, 0.2, False, device="cpu",
                    overrides=dict(batch=8, steps_per_call=16,
                                   compare_envs=8))
    assert r["correct"] is True, r["checks"]
    c = harness.run(HARD, 2 ** 31 + 98, 0.2, False, device="cpu",
                    control=True, overrides=dict(batch=8, steps_per_call=16,
                                                 compare_envs=8))
    assert c["correct"] is False


def test_the_es_reference_imports_nothing_of_the_program():
    """``perfbench/reference_torch/es.py`` imports torch and its sibling's
    threefry, and names nothing of the program."""
    path = harness.ROOT / "perfbench" / "reference_torch" / "es.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + node.module)
    assert names <= {"__future__", "math", "torch", ".rainbow"}, names
    assert "gym_simpletetris_tpu" not in path.read_text()
