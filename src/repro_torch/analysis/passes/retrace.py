"""Pass 3 — ``retrace-hazard``.

The port runs eagerly, so nothing is traced; what takes a retrace's
place is a rebuild.  The mirrors, staging buffers and kernel scratch
the control plane reuses are sized by pow2-bucketed widths
(``bucket_width`` rows, ``quantum_width`` requests), so churn in
membership or quantum size reuses them — an unbucketed call site makes
every distinct width a fresh allocation and a fresh upload, and breaks
the positional tree reductions' parity with the reference.  The
runtime side is guarded by ``repro_torch.analysis.runtime``
(``assert_no_rebuild``: no kernel build, no whole-mirror upload); this
pass guards it statically.  Two hazard shapes, both reported under one
rule:

* **unbucketed call** — a call site of a registered kernel in a
  function that never touches a shape-bucketing provider
  (``bucket_width`` / ``quantum_width`` / ``pad_state`` / the resident
  store's cached views, which are pow2 by construction);
* **inline mesh construction** — a sharded kernel call site passing
  ``mesh=RowMesh(...)`` or a process group made in place
  (``dist.new_group(...)``, ``dist.new_subgroups(...)``): making a group
  is a collective every rank must enter together, and a fresh mesh
  object per call leaks groups — meshes must come from the cached
  providers (``row_mesh`` / ``pool_mesh`` in ``core.shard_plane``).

Two checks of the reference's pass have no eager counterpart and are
not made here: ``static_argnames`` hygiene (literal, hashable static
arguments of a ``jax.jit``) and trace-time capture of mutable host
state (a jit body reading a module-level dict runs once, at trace
time; an eager body reads it on every call).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (
    Finding,
    Pass,
    Project,
    iter_functions,
    mentions,
    register_pass,
)
from repro_torch.analysis.passes.dtype import _call_name

#: functions/attributes that yield pow2-bucketed shapes: the padding
#: helpers themselves plus the resident-store views that are pow2 by
#: construction (store capacity is a bucket_width).
SHAPE_PROVIDERS = {
    "bucket_width", "quantum_width", "pad_rows", "pad_state",
    "stack_states", "device_state", "_kernel_inputs", "_arrays",
    "arrays_from_pool", "quantum_snapshot",
    # sharded plane: mesh-aligned pow2 widths and the cached meshes
    # (``core.shard_plane``)
    "shard_width", "row_mesh", "pool_mesh",
}

#: calls that build a row mesh or a process group in place
INLINE_MESHES = {"RowMesh", "new_group", "new_subgroups"}


@register_pass
class RetraceHazardPass(Pass):
    rule = "retrace-hazard"
    description = ("kernel call sites must shape-bucket; meshes come "
                   "from the cached providers")

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for f in project.files:
            for func, qualname in iter_functions(f.tree):
                if f"{f.module}.{qualname}" in project.kernels:
                    continue        # kernels composing kernels is fine
                calls = project.kernel_calls(f, func)
                if not calls:
                    continue
                bucketed = mentions(func, SHAPE_PROVIDERS)
                for call, decl in calls:
                    if not bucketed:
                        findings.append(Finding(
                            rule=self.rule, path=f.path, line=call.lineno,
                            message=(
                                f"call to kernel {decl.qualname!r} in "
                                f"{qualname} without bucket_width/"
                                f"quantum_width padding — array-shape "
                                f"churn rebuilds what the kernel reuses")))
                    for kw in call.keywords:
                        if kw.arg == "mesh" and isinstance(
                                kw.value, ast.Call) and \
                                _call_name(kw.value) in INLINE_MESHES:
                            findings.append(Finding(
                                rule=self.rule, path=f.path,
                                line=kw.value.lineno,
                                message=(
                                    f"inline {_call_name(kw.value)}(...) "
                                    f"passed as mesh of kernel "
                                    f"{decl.qualname!r} in {qualname} — "
                                    f"every fresh mesh is a new process "
                                    f"group; use the cached row_mesh/"
                                    f"pool_mesh providers")))
        return findings
