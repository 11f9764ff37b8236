"""Pass 2 — ``dtype-discipline``.

The resident contract (``resident.py``): kernel-facing columns are
float32 (the kernels and every parity oracle run f32 end-to-end), the
accounting accumulators are float64 (sequential-accumulation parity
with the scalar bookkeeping, bit for bit).  Two violation shapes:

* an f64 value flowing into a registered kernel argument — either an
  explicit float64 dtype/cast in the argument expression
  (``torch.float64``, ``np.float64``, ``.double()``), or an f64
  accumulator column passed through uncast (the kernel's f32 tensors
  would be handed a double buffer, and parity drifts);
* an f32 truncation written INTO an f64 accumulator column — the
  sequential-accumulation parity the f64 contract exists for is lost.

Both are seeded from the column manifest; kernel call sites are the
calls that reach a function registered via
``@device_kernel(oracle=...)``.  A down-cast to f32 is any of the numpy
spellings (``.astype(np.float32)``, ``np.float32(x)``,
``np.asarray(x, np.float32)``) or the torch ones (``.float()``,
``.to(torch.float32)``, ``torch.as_tensor(x, dtype=torch.float32)``,
``torch.tensor(x, dtype=torch.float32)``).
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.core import (
    Finding,
    Pass,
    Project,
    col_writes,
    collect_aliases,
    iter_functions,
    register_pass,
    resolve_col,
)

#: calls accepted as an explicit down-cast to f32 when they mention
#: float32 anywhere in their arguments: .astype(...), np.float32(...),
#: np.asarray(x, np.float32), .to(torch.float32),
#: torch.as_tensor(x, dtype=torch.float32), torch.tensor(...)
_CAST_FUNCS = ("astype", "asarray", "array", "float32", "to", "as_tensor",
               "tensor")


def _is_named(node: ast.AST, name: str) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == name) or (
        isinstance(node, ast.Name) and node.id == name)


def _is_method_call(node: ast.AST, name: str) -> bool:
    """``<x>.name()`` with no arguments (``.float()``, ``.double()``)."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == name and not node.args
            and not node.keywords)


def _is_f32_cast(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    if _is_method_call(node, "float"):
        return True
    name = _call_name(node)
    if name not in _CAST_FUNCS:
        return False
    if name == "float32":
        return True
    return any(_is_named(sub, "float32") for sub in ast.walk(node))


def _mentions_f32(node: ast.AST) -> bool:
    return any(_is_named(sub, "float32") or _is_method_call(sub, "float")
               for sub in ast.walk(node))


def _mentions_f64(node: ast.AST) -> bool:
    return any(_is_named(sub, "float64") or _is_method_call(sub, "double")
               for sub in ast.walk(node))


def _call_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _uncast_f64_cols(arg: ast.AST, col_aliases, column_of,
                     f64_cols: set[str]) -> list[str]:
    """f64 columns referenced in ``arg`` with no f32 cast wrapping them
    (checked top-down: a cast anywhere above the reference sanctions
    everything below it)."""
    hits: list[str] = []

    def visit(node: ast.AST) -> None:
        if _is_f32_cast(node):
            return
        col = resolve_col(node, col_aliases, column_of)
        if col in f64_cols:
            hits.append(col)
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(arg)
    return hits


@register_pass
class DtypeDisciplinePass(Pass):
    rule = "dtype-discipline"
    description = ("no f64 into kernel args; no f32 truncation of "
                   "f64 accumulator columns")

    def run(self, project: Project) -> list[Finding]:
        f64_cols = project.manifest.f64_columns
        findings: list[Finding] = []
        for f in project.files:
            for func, qualname in iter_functions(f.tree):
                if f"{f.module}.{qualname}" in project.kernels:
                    continue        # kernels compose internally
                col_aliases, column_of = collect_aliases(func)
                for call, decl in project.kernel_calls(f, func):
                    args = list(call.args) + [
                        kw.value for kw in call.keywords]
                    for arg in args:
                        if _mentions_f64(arg):
                            findings.append(Finding(
                                rule=self.rule, path=f.path,
                                line=arg.lineno,
                                message=(
                                    f"float64 value flows into kernel "
                                    f"{decl.qualname!r} argument in "
                                    f"{qualname} (f32 kernel contract)")))
                        for col in _uncast_f64_cols(
                                arg, col_aliases, column_of, f64_cols):
                            findings.append(Finding(
                                rule=self.rule, path=f.path,
                                line=arg.lineno,
                                message=(
                                    f"f64 accumulator column {col!r} "
                                    f"passed uncast to kernel "
                                    f"{decl.qualname!r} in {qualname} "
                                    f"— cast to float32 explicitly")))
                for w in col_writes(func):
                    if w.column in f64_cols and w.value is not None and \
                            _mentions_f32(w.value):
                        findings.append(Finding(
                            rule=self.rule, path=f.path,
                            line=w.node.lineno,
                            message=(
                                f"f32-truncated value written into f64 "
                                f"accumulator column {w.column!r} in "
                                f"{qualname} — breaks sequential-"
                                f"accumulation parity")))
        return findings
