"""What the benchmark may import: never JAX or the JAX package (compared by
whole top-level name: the port's own name begins with the JAX package's),
and in the plain references nothing of the program at all."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.BENCH_DIR)
JAX_SIDE = {"jax", "jaxlib", "flax", "k8s_operator_libs_tpu"}
PORT = "k8s_operator_libs_tpu_torch"


def _imports(path: Path):
    """Top-level names of every absolute import in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not JAX_SIDE & set(_imports(path))


REFERENCE = sorted((BENCH / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in set(_imports(path))
    # relative imports stay inside the benchmark: the reference's own
    # modules, the sizes and the seeded weights
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1 or node.module in ("models", "weights")


def test_loading_the_references_loads_no_program_module():
    code = ("import sys; import benchmark.reference.model, "
            "benchmark.reference.train, benchmark.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert PORT not in loaded and not JAX_SIDE & loaded


def test_the_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules([PORT, f"{PORT}.server", "numpy"]) == []
    assert harness.forbidden_modules(
        ["k8s_operator_libs_tpu.models", "jax.numpy", PORT]) == [
            "jax", "k8s_operator_libs_tpu"]
    assert harness.forbidden_modules(["jaxlib", "flax.linen"]) == [
        "flax", "jaxlib"]
