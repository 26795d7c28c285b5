"""What the benchmark imports: nothing of JAX or the JAX package anywhere
under nanobench/, and nothing of the program in the reference.  Names are
compared by their top-level part, whole."""

import ast
import os
import subprocess
import sys

import pytest

from nanobench import harness

JAX = set(harness.JAX_NAMES)
FILES = sorted(p for p in harness.HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_import(path):
    assert not (top_level_imports(path) & JAX)


def test_reference_imports_nothing_of_the_program_or_the_harness():
    for path in (harness.HERE / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert "smart_nanogrid_gym_torch" not in names and "nanobench" not in names, path
        assert names <= {"__future__", "math", "pathlib", "typing", "numpy", "torch"}, (path, names)


def test_a_cpu_run_loads_no_jax():
    code = ("import sys, time, torch; from nanobench import harness; "
            "c = harness.load_cell('rbc8-eval-10kdays', overrides=dict(batch=4, days=1, check_calls=1, check_envs=2)); "
            "r = harness.run_cell(c, 7, 0.05, False, torch.device('cpu'), time.perf_counter()); "
            "assert r['correct'], r; print(harness.jax_loaded())")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "nanobench.run", "--workload", "rbc8-eval-10kdays", "--seed",
                          str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
