"""Pass 6 — ``telemetry-hot-path``.

Telemetry inside ``@hot_path`` functions must use the BATCH recording
APIs (``observe_rows`` / ``inc_rows`` / ``record_batch`` /
``incr_many``): one row-op per quantum.  The scalar twins re-introduce
exactly the per-row Python the vectorized lifecycle eliminated — a
10k-request quantum calling ``store.incr`` per key or
``histogram.observe`` per value is O(requests) dict/ufunc work on the
hot path.

The pass flags any call whose attribute name is a scalar recorder
(``observe``, ``incr``) inside a ``@hot_path`` function.  Scalar
recorders remain legal everywhere else — they are the parity oracles
and the cold-path convenience API.  A deliberate scalar call in a hot
path takes a line waiver::

    self.store.incr(k, 1.0, now)  # repro: allow[telemetry-hot-path] -- <why>
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, Pass, Project, register_pass

#: scalar recording spellings forbidden in hot paths (their batch
#: twins — observe_rows / inc_rows / incr_many / record_batch — have
#: different attribute names and never match).
SCALAR_RECORDERS = {"observe", "incr"}


@register_pass
class TelemetryHotPathPass(Pass):
    rule = "telemetry-hot-path"
    description = ("@hot_path functions must record telemetry through "
                   "batch row-ops, not scalar observe()/incr()")

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for hp in project.hot_paths:
            for sub in ast.walk(hp.node):
                if not isinstance(sub, ast.Call):
                    continue
                fn = sub.func
                if isinstance(fn, ast.Attribute) \
                        and fn.attr in SCALAR_RECORDERS:
                    findings.append(Finding(
                        rule=self.rule, path=hp.file.path,
                        line=sub.lineno,
                        message=(
                            f"scalar recorder .{fn.attr}() in hot path "
                            f"{hp.qualname} — use the batch API "
                            f"(observe_rows/inc_rows/record_batch/"
                            f"incr_many) or waive with a reason")))
        return findings
