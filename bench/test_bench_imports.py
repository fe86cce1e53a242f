"""What the benchmark imports and reads: no JAX, no JAX package, nothing of
the older benchmarks; the plain references import nothing of the program."""
import ast
from pathlib import Path

import pytest

from bench.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            out |= {a.value.split(".")[0] for a in node.args[:1] if isinstance(a, ast.Constant)}
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_nothing_of_the_old_benchmarks(path):
    assert not top_level_imports(path) & FORBIDDEN
    text = path.read_text()
    if path.name != Path(__file__).name:
        assert "BENCH_" not in text and "benchmarks/" not in text and "benchmarks." not in text


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch", "bench"})
