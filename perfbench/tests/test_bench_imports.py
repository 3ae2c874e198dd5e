"""The import guard: nothing the benchmark runs loads JAX or the JAX package
(top-level module names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import subprocess
import sys
import textwrap

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "gym_simpletetris_tpu"}
PROGRAM = "gym_simpletetris_tpu_torch"


def _imports(path):
    """Top-level names of the modules a file imports (absolute imports)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    bench = harness.ROOT / "perfbench"
    return [p for p in bench.rglob("*.py") if "tests" not in p.parts]


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_numpy_and_nothing_of_the_program():
    ref = harness.ROOT / "perfbench" / "reference"
    for path in ref.glob("*.py"):
        names = set(_imports(path))
        assert names <= {"numpy", "__future__", "functools"}, (path, names)
        assert PROGRAM not in path.read_text()


def test_no_jax_module_is_loaded_by_a_rehearsal_of_every_cell():
    """A CPU rehearsal of each cell's traffic, window, traced window and
    comparison in a fresh process, then ``sys.modules``."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(harness.ROOT)!r})
        from perfbench import harness
        sys.path.insert(0, {str(harness.ROOT / 'perfbench')!r})
        import run
        small = dict(batch=8, steps_per_call=8, compare_envs=4, trace_calls=2,
                     warmup_calls=2)
        for w in harness.load_benchmark()["workloads"]:
            for trace in (False, True):
                r = harness.run(w["name"], 2 ** 31 + 5, 0.2, trace,
                                device="cpu", overrides=small)
                assert r["correct"] is True, (w["name"], r)
        print("LOADED", run.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"
