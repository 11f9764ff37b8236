"""Pass 4 — ``hot-path-scalar-loop``.

Functions marked ``@hot_path`` are the vectorized per-quantum/per-tick
paths: their Python cost must be O(batch) or O(1), never O(rows).  The
pass flags any ``for`` loop or comprehension inside a hot path whose
iterable touches a store/table ROW container — the membership dicts
(``slot_of`` / ``rid_of`` / ``name_of``), the row-view facades
(``in_flight`` / ``status`` / ``entitlements``), the live-row caches,
or the legacy per-request dicts (``_charges`` / ``_buckets``).

Iterating the incoming batch (requests, completions, per-entitlement
group dicts) is fine — that's O(batch) by definition.  A hot path that
must walk rows for a documented reason takes a line waiver::

    for rid, slot in self.table.slot_of.items():  # repro: allow[hot-path-scalar-loop] -- <why>
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (
    Finding,
    Pass,
    Project,
    mentions,
    register_pass,
)

#: attribute/name spellings that denote per-row containers.
ROW_CONTAINERS = {
    "slot_of", "rid_of", "name_of", "in_flight", "status",
    "entitlements", "live_names", "live_slots", "_charges", "_buckets",
    "spill_from",
}

_LOOPS = (ast.For, ast.AsyncFor)
_COMPS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


@register_pass
class HotPathScalarLoopPass(Pass):
    rule = "hot-path-scalar-loop"
    description = ("@hot_path functions may not loop over store/table "
                   "rows in Python")

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for hp in project.hot_paths:
            for sub in ast.walk(hp.node):
                iters: list[ast.AST] = []
                if isinstance(sub, _LOOPS):
                    iters = [sub.iter]
                elif isinstance(sub, _COMPS):
                    iters = [g.iter for g in sub.generators]
                for it in iters:
                    if mentions(it, ROW_CONTAINERS):
                        kind = ("loop" if isinstance(sub, _LOOPS)
                                else "comprehension")
                        findings.append(Finding(
                            rule=self.rule, path=hp.file.path,
                            line=sub.lineno,
                            message=(
                                f"per-row Python {kind} over a "
                                f"store/table container in hot path "
                                f"{hp.qualname} — vectorize or waive "
                                f"with a reason")))
        return findings
