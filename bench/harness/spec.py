"""Resolve a cell of ``BENCHMARK.json`` by name: its entry, its model
configuration file, its traffic file and its limits file.  Everything
that belongs to one configuration, one traffic mix or one cell is a
file of its own; this module only finds them."""
from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def process_env(root: Path = ROOT) -> None:
    """Point the program's build and kernel caches at fixed directories
    inside the checkout, keep libraries from loading JAX, and put the
    program's sources on the path.  Call before importing torch."""
    import sys
    build = root / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    if str(root / "src") not in sys.path:
        sys.path.insert(0, str(root / "src"))


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(path: Path, prefix: str):
    """The Python file at ``path``, loaded by path as a module named
    from ``prefix`` and its stem."""
    mod_spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration, traffic and limits
    files read: ``{"cell", "config", "traffic", "limits"}``.  What the
    configuration means is its architecture's (``harness.arch``)."""
    w = cell(bench, workload)
    conf = read_json(root / config_entry(bench, w["config"])["file"])
    traffic = read_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = read_json(BENCH / "limits" / f"{w['name']}.json")
    return {"cell": w, "config": conf, "traffic": traffic,
            "limits": limits}
