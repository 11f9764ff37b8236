"""Pass 1 — ``mirror-invalidation``.

The resident store mirrors its kernel-facing columns as a cached
device ``ControlState``.  A host-side write to a mirrored column that
is not followed by ``mark_dirty()`` (or ``adopt_device`` /
``_membership_changed``) on its own suite chain silently feeds STALE
burst/debt to every later admission kernel — the worst control-plane
failure mode, invisible to parity tests that run on fresh stores.

Flags every assignment / aug-assignment / ``np.<ufunc>.at`` scatter
targeting a mirrored column (per the column manifest, through one
level of ``x = store.col`` / ``w = c["burst"]`` aliasing) unless the
write is inside a sanctioned mutator or an invalidation call follows
it unconditionally.  Dynamic keys (``c[name][slot] = v``) are out of
scope — the repo's only such site is ``_col_property``, whose
``dirty=True`` variant invalidates by construction.
"""
from __future__ import annotations

from repro_torch.analysis.core import (
    Finding,
    Pass,
    Project,
    col_writes,
    followed_by_invalidation,
    iter_functions,
    register_pass,
)


@register_pass
class MirrorInvalidationPass(Pass):
    rule = "mirror-invalidation"
    description = ("writes to device-mirrored store columns must be "
                   "followed by mark_dirty()/adopt_device()")

    def run(self, project: Project) -> list[Finding]:
        mirrored = project.manifest.mirrored
        sanctioned = project.manifest.sanctioned_mutators
        findings: list[Finding] = []
        for f in project.files:
            for func, qualname in iter_functions(f.tree):
                if qualname in sanctioned:
                    continue
                for w in col_writes(func):
                    if w.column not in mirrored:
                        continue
                    if followed_by_invalidation(func, w.node):
                        continue
                    findings.append(Finding(
                        rule=self.rule, path=f.path, line=w.node.lineno,
                        message=(
                            f"write to device-mirrored column "
                            f"{w.column!r} in {qualname} is not followed "
                            f"by mark_dirty()/adopt_device() — the cached "
                            f"ControlState goes stale")))
        return findings
