"""No module under ``perfbench/`` imports JAX or the JAX package, and the
reference imports nothing of the port; top-level names compared whole (the
port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "bayesian_inference_tpu"}
PORT = "bayesian_inference_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources() -> list[Path]:
    return [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_comparison_is_by_whole_top_level_name():
    tree = ast.parse("import bayesian_inference_tpu_torch.mcmc\nfrom bayesian_inference_tpu.ops import x\n")
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            found.add(node.module.split(".")[0])
    assert found & FORBIDDEN == {"bayesian_inference_tpu"}


def test_the_reference_imports_nothing_of_the_port_or_the_harness():
    for path in (BENCH / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert PORT not in names and "pbench" not in names, path
        assert names <= {"__future__", "dataclasses", "fnmatch", "math", "os", "numpy", "torch", "reference"}, path


def test_only_the_program_module_imports_the_port():
    importers = {p.relative_to(BENCH).as_posix() for p in sources() if PORT in top_level_imports(p)}
    assert importers <= {"pbench/program.py", "control.py", "tests/test_perfbench_faults.py"}, importers
