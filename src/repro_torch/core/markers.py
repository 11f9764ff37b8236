"""Structural marker consumed by the static analyzer (``python -m
repro.analysis`` scans every package under ``src/``).

:func:`hot_path` marks a function as a vectorized hot path: the
hot-path-scalar-loop pass forbids per-row Python ``for`` loops /
comprehensions over store or table row containers inside it (waive
with ``# repro: allow[hot-path-scalar-loop] -- <reason>``).  It is
ZERO overhead at call time — it records the function in a module-level
registry and returns it unchanged.

The reference package's second marker, ``kernel``, registers jit
kernels by function name; the port has no jit kernels and does not
carry it (a port ``control_tick`` registered under the same name would
shadow the reference's declaration).
"""
from __future__ import annotations

__all__ = ["HOT_PATHS", "hot_path"]

#: "module.qualname" of every function marked :func:`hot_path`.
HOT_PATHS: dict[str, str] = {}


def hot_path(fn):
    """Mark ``fn`` as a vectorized hot path (see module docstring)."""
    HOT_PATHS[f"{fn.__module__}.{fn.__qualname__}"] = fn.__module__
    return fn
