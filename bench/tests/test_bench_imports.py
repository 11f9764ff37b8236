"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either.  Top-level
module names are compared whole: the program's package name begins
with the JAX package's."""
import ast

import pytest

import bench_tiny_cells as tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in tiny.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(tiny.BENCH).as_posix())
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_is_plain(path):
    names = set(imported(path))
    assert "repro_torch" not in names and "harness" not in names
    assert names <= {"__future__", "typing", "torch", "numpy", "math",
                     "reference"}


def test_each_architecture_reference_is_checked():
    """Every architecture's plain forward is among the files held plain
    above."""
    plain = {p.name for p in SOURCES if "reference" in p.parts}
    archs = {p.name for p in (tiny.BENCH / "archs").glob("*.py")}
    assert {"model.py", "llama.py", "qwen3.py"} | archs <= plain


def test_whole_names():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN
