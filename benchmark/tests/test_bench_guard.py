"""What a run may load: no JAX, no JAX package, none of the scripts that
drive it; and the reference nothing of the program. Names are compared
whole, by the part before the first dot."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from harness.guard import FORBIDDEN, forbidden_loaded

BENCH = Path(__file__).resolve().parents[1]
PROGRAM = {"nr3d_lib_tpu_torch", "examples_torch"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_whole_names_are_compared():
    assert forbidden_loaded(["nr3d_lib_tpu_torch.ops.lotd_brick4",
                             "examples_torch.common", "benchmark",
                             "bench_small", "jaxtyping"]) == []
    assert forbidden_loaded(["nr3d_lib_tpu.ops", "jax", "jaxlib.xla",
                             "flax.linen", "bench", "experiments.x"]) == \
        sorted(FORBIDDEN)


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_a_forbidden_module(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | PROGRAM)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import reference.neus, reference.nerf\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    loaded = set(eval(out.strip()))
    assert not loaded & (FORBIDDEN | PROGRAM)


def test_a_run_without_the_program_fails_without_a_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "nerf_w4_render_800", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
