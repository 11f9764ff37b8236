"""Control-plane sanitizer of the port — AST invariant passes over
``src/repro_torch`` for the repo's three docstring-enforced contracts
(mirror invalidation, dtype discipline, shape bucketing) plus hot-path
loop hygiene, telemetry batching, the chaos harness's public surface
and kernel↔oracle parity coverage.  stdlib ``ast`` only; run as
``python -m repro_torch.analysis --strict src/repro_torch`` (blocking
in CI).

Rules:

* ``mirror-invalidation`` — host writes to device-mirrored store
  columns must ``mark_dirty()``;
* ``dtype-discipline`` — no f64 into kernel args, no f32 truncation of
  f64 accumulator columns;
* ``retrace-hazard`` — kernel calls shape-bucketed, meshes from the
  cached providers;
* ``hot-path-scalar-loop`` — ``@hot_path`` functions never loop over
  store/table rows in Python;
* ``telemetry-hot-path`` — ``@hot_path`` functions record telemetry
  through batch row-ops;
* ``oracle-parity`` — every control-plane kernel registers an oracle
  (``@device_kernel``) with a test referencing both, keyed on
  qualified names;
* ``chaos-public-api`` — the chaos harness reaches no private state.

Waive a finding in place with ``# repro: allow[<rule>] -- <reason>``
(the reference's analyzer reads the same comments).
"""
from repro_torch.analysis.core import (  # noqa: F401
    Finding,
    PASS_REGISTRY,
    Pass,
    Project,
    Report,
    SourceFile,
    analyze,
    register_pass,
)
from repro_torch.analysis.manifest import (  # noqa: F401
    Manifest,
    default_manifest,
)

__all__ = [
    "Finding", "Manifest", "PASS_REGISTRY", "Pass", "Project", "Report",
    "SourceFile", "analyze", "default_manifest", "register_pass",
]
