"""Pass 5 — ``oracle-parity``.

Every kernel of the control plane must be pinned against a retained
oracle.  Mechanically:

* a KERNEL DEFINITION — a function under ``repro_torch/core`` or
  ``repro_torch/gateway`` that launches a hand-written kernel, directly
  (``kernels.build.function``) or through a wrapper of
  ``repro_torch.kernels`` — must carry
  ``@device_kernel(oracle="<dotted path>")`` (the registration decorator
  from ``repro_torch.core.markers`` — zero overhead at call time);
* for every registered kernel there must exist a test module under
  ``tests/`` that references BOTH the kernel by its qualified module
  (``repro_torch.core.fleet.plan_fleet``, imported or reached through
  an imported module) and its oracle (the dotted path, or the class
  when the oracle is a method) — delete a kernel's parity test and this
  pass fails CI.  A test that only shares the bare names does not
  count;
* a function that calls a collective (``torch.distributed``, or the
  port's ``distributed/collectives.py``) is a SHARDED kernel — it must
  register an oracle wherever it lives (``distributed/`` and
  ``models/`` included): multi-device decisions are pinned against the
  single-device kernel, which is itself pinned against the reference
  (``core.shard_plane`` is the template).  The collective layer itself
  (the collectives module, the row mesh's combines, the model runtime's
  tp entry and exit) is not a kernel.

Model/serving code that launches kernels without a collective
(``repro_torch/kernels``, ``repro_torch/serving``, ...) is otherwise
outside the control-plane contract and exempt.
"""
from __future__ import annotations

from repro_torch.analysis.core import Finding, Pass, Project, register_pass

#: path fragments whose kernel definitions MUST register an oracle.
REGISTRATION_SCOPE = ("repro_torch/core/", "repro_torch/gateway/")


def _oracle_targets(oracle: str) -> set[str]:
    parts = oracle.split(".")
    targets = {oracle}
    if len(parts) > 1 and parts[-2][:1].isupper():
        targets.add(".".join(parts[:-1]))   # method oracle: the class counts
    return targets


@register_pass
class OracleParityPass(Pass):
    rule = "oracle-parity"
    description = ("every control-plane kernel registers an oracle and "
                   "has a parity test referencing both")

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for fd in project.launch_defs:
            if fd.name in project.kernels:
                continue
            if any(s in fd.file.path.replace("\\", "/")
                   for s in REGISTRATION_SCOPE):
                findings.append(Finding(
                    rule=self.rule, path=fd.file.path, line=fd.node.lineno,
                    message=(
                        f"kernel {fd.qualname!r} is not registered via "
                        f"@device_kernel(oracle=...) — every control-plane "
                        f"kernel needs a parity oracle")))
        for fd in project.collective_defs:
            if fd.name in project.kernels:
                continue
            findings.append(Finding(
                rule=self.rule, path=fd.file.path, line=fd.node.lineno,
                message=(
                    f"sharded kernel {fd.qualname!r} (calls a collective) "
                    f"is not registered via @device_kernel(oracle=...) — "
                    f"multi-device decisions must be pinned against the "
                    f"single-device kernel")))
        for decl in project.kernels.values():
            if decl.oracle is None:
                findings.append(Finding(
                    rule=self.rule, path=decl.path, line=decl.line,
                    message=(
                        f"@device_kernel on {decl.qualname!r} has no "
                        f"literal oracle=\"<dotted path>\" argument")))
                continue
            targets = _oracle_targets(decl.oracle)
            covered = any(
                refs.names(decl.name) and any(refs.names(t)
                                              for t in targets)
                for refs in project.tests.values())
            if not covered:
                findings.append(Finding(
                    rule=self.rule, path=decl.path, line=decl.line,
                    message=(
                        f"no test module references both kernel "
                        f"{decl.qualname!r} ({decl.name}) and its oracle "
                        f"{decl.oracle!r} — parity coverage missing")))
        return findings
