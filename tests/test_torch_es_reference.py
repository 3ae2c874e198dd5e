"""The port's ES trainer on pixels (``train/es.py`` with ``NatureDQN``)
against the plain float32 reference (``perfbench/reference_torch/es.py``)
and the NumPy game, on seeded random weights at the Nature widths: pop 4 x
2 envs, horizon 8, 84 px, on the CPU, under the tolerances of the
benchmark's comparison (``perfbench/entries/es_train.py`` ``TOL``):

- eps: the reference's normals within 3 ulp of the program's, most of them
  bitwise, the second half the first negated;
- the pair's Q-values within their tolerance;
- every env's pixels, rewards and dones and every member's fitness from
  the reference's replay; theta' and the gradient within their bound;
- the control (the reference below the configuration's precision in the
  program's place: eps rounded to bf16 far outside the tolerance, the
  update on it and the Q-values through float8 outside theirs) failing
  through the same counts, and a reference whose antithetic half is not
  negated failing too;
- the trainer's spans and counters;
- the reference's imports.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gym_simpletetris_tpu_torch.core.config import EnvConfig
from gym_simpletetris_tpu_torch.train import es
from gym_simpletetris_tpu_torch.utils import profiling
from perfbench import harness
from perfbench.entries import es_train
from perfbench.entries.es_train import TOL
from perfbench.reference_torch import es as R
import port_harness  # noqa: F401 (torch on one CPU thread)

ROOT = Path(__file__).resolve().parents[1]
AGENT = harness.cell_parts(harness.load_benchmark(),
                           "es_gray.train_pop512")[2]["agent"]
POP, K, T = 4, 2, 8


def _make():
    cfg = es.ESConfig(env=EnvConfig(obs_type="grayscale", auto_reset=True,
                                    reward_step=True, penalise_holes=True),
                      pop_size=POP, envs_per_member=K, horizon=T)
    init_fn, gen, net = es.make_es(cfg, "cpu")
    state = init_fn(2 ** 31 - 7)
    # every bias and weight moved off the fresh init
    noise = torch.randn(state.theta.shape,
                        generator=torch.Generator().manual_seed(4))
    return cfg, gen, net, state.replace(theta=state.theta + 0.02 * noise)


@pytest.fixture(scope="module")
def generation():
    """One recorded generation of the port under a profiler (its spans and
    counters), and its comparison."""
    cfg, gen, _, state = _make()
    before = profiling.counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        lo = profiling.time.time_ns()
        rec = es_train.record_generation(es, gen, state, 1, cfg.sigma)
        hi = profiling.time.time_ns()
    assert int(rec.pop("state").generation) == 1
    rec["counters"] = profiling.counters() - before
    rec["spans"] = profiling.spans_between(lo, hi)
    readings, out = es_train.generation_checks(rec, cfg, AGENT)
    return cfg, rec, readings, out


def test_the_policy_has_the_configurations_widths():
    cfg, _, net, state = _make()
    es_train._check_network(net, state.theta, AGENT)
    lay = R.layout(AGENT["frame_size"], 1, AGENT["convs"], AGENT["dense"],
                   AGENT["num_actions"])
    assert state.theta.numel() == AGENT["parameters"] == 1_681_575
    assert [(m, leaf) for m, leaf, _ in lay] == [
        (m, leaf) for m in ("conv1", "conv2", "conv3", "dense", "q")
        for leaf in ("bias", "kernel")]
    # the reference's layout is the port's ravel of its state_dict
    params = R.unflatten(state.theta, lay)
    sd = es.greedy_params(cfg, state.theta)
    assert torch.equal(params["conv2", "kernel"],
                       sd["conv2.weight"].permute(2, 3, 1, 0))
    assert torch.equal(params["dense", "kernel"], sd["dense.weight"].T)
    assert torch.equal(params["q", "bias"], sd["q.bias"])


def test_eps_is_the_references_within_3_ulp(generation):
    _, rec, readings, out = generation
    eps, dim = rec["eps"], rec["theta"].numel()
    cols = (dim - 2 ** 16, dim)
    want = R.normal(rec["keys"][0], (0, POP // 2), cols, dim, "cpu")
    ulps = es_train._ulps(eps[:POP // 2, cols[0]:], want)
    assert int(ulps.max()) <= 3 < TOL["eps_ulps"]
    assert float((ulps == 0).float().mean()) > 0.99
    assert torch.equal(eps[POP // 2:], -eps[:POP // 2])
    assert out["eps_out_of_tol"] == 0 and readings["eps_max_ulps"] <= 3


def test_the_generation_is_within_every_tolerance(generation):
    _, rec, readings, out = generation
    assert rec["q"].shape == (2, T, K, 7)
    assert all(v == 0 for v in out.values()), (readings, out)
    assert readings["q_err"] <= TOL["q"]
    assert readings["grad_err"] <= TOL["update"]
    assert readings["theta_err"] <= TOL["update"]


def test_below_the_configurations_precision_fails(generation):
    """The reference's eps rounded to bf16, its Q-values through float8
    and its update on eps rounded to bf16 each leave their tolerance (the
    readings of the control)."""
    cfg, rec, _, _ = generation
    readings = es_train.generation_checks(rec, cfg, AGENT, control=True)[0]
    assert readings["eps_max_ulps"] > 100 * TOL["eps_ulps"]
    assert readings["q_err"] > TOL["q"]
    assert readings["grad_err"] > TOL["update"]
    assert readings["theta_err"] > TOL["update"]


def test_every_env_and_fitness_against_the_replay(generation):
    cfg, rec, _, _ = generation
    kw = {k: getattr(cfg.env, k) for k in ("obs_type", "reward_step",
                                           "penalise_holes")}
    envs = es_train.replay_envs(kw, rec["keys"][1], rec["actions"],
                                rec["obs"], rec["rewards"], rec["dones"],
                                "cpu")
    fit = es_train._fitness(envs.pop("rewards"), K)
    assert envs == dict(pixel=0, reward=0, done=0)
    assert rec["obs_not_u8"] == 0
    assert rec["obs"].shape == (T + 1, POP * K, 84, 84)
    assert (fit == rec["fitness"]).all()


def test_the_control_fails(generation):
    """The reference below the configuration's precision in the program's
    place fails every count it enters."""
    cfg, rec, _, _ = generation
    readings, out = es_train.generation_checks(rec, cfg, AGENT, control=True)
    for k in ("eps_out_of_tol", "q_out_of_tol", "grad_out_of_tol",
              "theta_out_of_tol"):
        assert out[k] > 0, (k, readings, out)


def test_an_unnegated_antithetic_half_fails(generation):
    cfg, rec, _, _ = generation
    readings, out = es_train.generation_checks(rec, cfg, AGENT, negate=False)
    for k in ("eps_out_of_tol", "q_out_of_tol", "grad_out_of_tol",
              "theta_out_of_tol"):
        assert out[k] > 0, (k, readings, out)


def test_the_trainer_records_its_spans_and_counters(generation):
    rec = generation[1]
    got, spans = rec["counters"], rec["spans"]
    names = [s.name for s in spans]
    assert got["es.generations"] == 1
    assert got["es.noise_elements"] == POP // 2 * rec["theta"].numel()
    assert got["es.member_forwards"] == POP * T
    for name, n in (("es.perturb", 1), ("es.rollout", 1), ("es.update", 1),
                    ("es.forward", T)):
        assert names.count(name) == n, name
    rollout = spans[names.index("es.rollout")].index
    assert all(s.parent == rollout for s in spans if s.name == "es.forward")


def test_the_reference_imports_nothing_of_the_port():
    path = ROOT / "perfbench" / "reference_torch" / "es.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." + node.module if node.level else
                      node.module.split(".")[0])
    assert names <= {"__future__", "math", "torch", ".rainbow"}, names
    code = ("import sys\n"
            "import perfbench.reference_torch.es\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gym_simpletetris_tpu', "
            "'gym_simpletetris_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
