"""Structural markers consumed by the port's static analyzer
(``python -m repro_torch.analysis``; the reference's ``python -m
repro.analysis`` scans ``src/repro_torch`` as well).

Two decorators, both ZERO overhead at call time — they record the
function in a module-level registry and return it unchanged:

* :func:`device_kernel` — registers a control-plane kernel entry point
  together with the dotted path of the oracle it is held against (for
  the port's kernels, the JAX counterpart, e.g.
  ``"repro.core.vectorized.admit_quantum"``: a string, never an
  import).  The port's ``oracle-parity`` pass keys it on its qualified
  name ``module.qualname`` and requires a test module that references
  both the kernel's module and the oracle.
* :func:`hot_path` — marks a function as a vectorized hot path: the
  hot-path-scalar-loop pass forbids per-row Python ``for`` loops /
  comprehensions over store or table row containers inside it (waive
  with ``# repro: allow[hot-path-scalar-loop] -- <reason>``).

Why the kernel marker is not named ``kernel``, as the reference's is:
the reference's analyzer registers every ``@kernel(...)`` it finds
under ``src/`` by BARE function name, so a port ``control_tick``
decorated ``@kernel`` would shadow the reference's declaration (and a
port test naming both would hide a deleted reference parity test).
``device_kernel`` is invisible to it.

Both analyzers read the DECORATIONS from the AST (they never import the
annotated modules); the registries below let tests assert the adoption
surface and keep the decorators honest about overhead.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DEVICE_KERNELS", "DeviceKernelSpec", "HOT_PATHS",
           "device_kernel", "hot_path"]


@dataclasses.dataclass(frozen=True)
class DeviceKernelSpec:
    """One registered kernel entry point and the oracle that pins it."""

    name: str            # "module.qualname"
    oracle: str          # dotted path, e.g. "repro.core.fleet.plan_fleet"


#: "module.qualname" → spec, filled at import time by :func:`device_kernel`.
DEVICE_KERNELS: dict[str, DeviceKernelSpec] = {}

#: "module.qualname" of every function marked :func:`hot_path`.
HOT_PATHS: dict[str, str] = {}


def device_kernel(*, oracle: str):
    """Register a control-plane kernel entry point with the dotted path
    of its parity oracle::

        @device_kernel(oracle="repro.core.fleet.plan_fleet")
        @torch.no_grad()
        def plan_fleet(...): ...
    """

    def register(fn):
        name = f"{fn.__module__}.{fn.__qualname__}"
        DEVICE_KERNELS[name] = DeviceKernelSpec(name=name, oracle=oracle)
        return fn

    return register


def hot_path(fn):
    """Mark ``fn`` as a vectorized hot path (see module docstring)."""
    HOT_PATHS[f"{fn.__module__}.{fn.__qualname__}"] = fn.__module__
    return fn
