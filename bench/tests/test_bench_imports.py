"""The benchmark imports neither JAX nor the JAX package nor the JAX
package's harness, and its reference imports nothing of the program: every
import of every file under bench/, by its top-level name compared whole."""
from __future__ import annotations

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = [p for p in FILES if "reference" in p.relative_to(BENCH).parts]
    assert len(ref) >= 4
    for path in ref:
        got = top_level_imports(path)
        assert "repro_torch" not in got, path
        assert got <= {"__future__", "importlib", "math", "typing", "torch", "bench"}, (path, got)


def test_the_guard_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom jax import numpy as jnp\nimport repro.core\n")
    assert top_level_imports(bad) & FORBIDDEN == {"jax", "repro"}
    ok = tmp_path / "ok.py"
    ok.write_text("import repro_torch.core\nfrom reprox import y\n")
    assert not top_level_imports(ok) & FORBIDDEN
