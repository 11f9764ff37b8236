"""Pass 7 — ``chaos-public-api``.

The chaos harness (``src/repro_torch/chaos/``) observes and perturbs the
control plane FROM OUTSIDE: scenarios inject churn through
``TokenPool.add_entitlement`` / ``PoolManager.migrate_entitlement``,
checkers read ``TokenPool.audit_snapshot()`` / ``Ledger.level_audit``.
If the harness ever reached into private state (``pool._authorized``,
``store._free``, a stray ``col["bucket_level"]`` poke through a
private handle), its invariants would assert implementation details
instead of the public contract — and a checker could itself corrupt
the state it audits.

The pass flags any ``_``-prefixed attribute access (read or write) on
a value other than ``self``/``cls`` inside the chaos package.  Dunder
attributes are exempt (they are protocol, not privacy).  Tests are
NOT covered — the deliberately-broken fixtures in ``test_torch_chaos.py``
poke private columns on purpose to prove each checker fires.

A justified exception takes a line waiver::

    x = pool._authorized  # repro: allow[chaos-public-api] -- <why>
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, Pass, Project, register_pass

#: path fragment selecting the harness package
CHAOS_FRAGMENT = "repro_torch/chaos/"


@register_pass
class ChaosPublicApiPass(Pass):
    rule = "chaos-public-api"
    description = ("the chaos harness must drive the control plane "
                   "through public entry points only — no private "
                   "attribute reach-ins")

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for f in project.files:
            path = f.path.replace("\\", "/")
            if CHAOS_FRAGMENT not in path:
                continue
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Attribute):
                    continue
                attr = node.attr
                if not attr.startswith("_") or attr.startswith("__"):
                    continue
                base = node.value
                if isinstance(base, ast.Name) \
                        and base.id in ("self", "cls"):
                    continue
                findings.append(Finding(
                    rule=self.rule, path=f.path, line=node.lineno,
                    message=(
                        f"private attribute .{attr} accessed from the "
                        f"chaos harness — use the public TokenPool/"
                        f"Ledger/simulator surface (audit_snapshot, "
                        f"level_audit, row_accounting, step_hooks) or "
                        f"waive with a reason")))
        return findings
