"""Nothing under portbench imports JAX, Flax or the JAX package, and the
reference imports nothing of the program: top-level module names are
compared whole (pvd_tpu_torch begins with pvd_tpu and is not it)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(harness.BENCH_DIR)
JAXLIKE = {"jax", "jaxlib", "flax", "pvd_tpu"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(node.args[0].value.split(".")[0])
    return tops


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & JAXLIKE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert "pvd_tpu_torch" not in imported_tops(path)
    assert imported_tops(path) <= {"__future__", "dataclasses", "math",
                                   "numpy", "torch", "portbench"}


def test_reference_modules_pull_in_no_program():
    code = ("import sys; import portbench.reference.nerf, "
            "portbench.reference.train, portbench.reference.render, "
            "portbench.reference.poses; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'pvd_tpu_torch', 'pvd_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pvd_tpu_torch_fake", object())
    assert "pvd_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax", object())
    assert "flax" in harness.forbidden_modules()
