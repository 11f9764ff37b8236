"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package ``repro``, so the port runs on a
machine that has neither.  Only the tests import both."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path) -> set[str]:
    """Top-level package of every import in ``path`` (absolute imports;
    relative ones stay inside the package that holds the file)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_has_the_reference_layout():
    for sub in ("core", "gateway", "serving", "models", "configs",
                "kernels", "launch", "training", "checkpointing", "data",
                "analysis", "analysis/passes"):
        assert (PORT / sub / "__init__.py").is_file(), sub
    for mod in ("training/loss.py", "training/optimizer.py",
                "training/grad_compress.py", "training/train_loop.py",
                "checkpointing/checkpoint.py", "data/pipeline.py",
                "launch/train.py", "tree.py", "analysis/__main__.py",
                "analysis/core.py", "analysis/manifest.py",
                "analysis/runtime.py", "analysis/passes/chaos_api.py",
                "analysis/passes/dtype.py", "analysis/passes/hotpath.py",
                "analysis/passes/mirror.py", "analysis/passes/parity.py",
                "analysis/passes/retrace.py",
                "analysis/passes/telemetry.py"):
        assert PORT / mod in FILES, mod
    assert (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 30      # every port module imported
