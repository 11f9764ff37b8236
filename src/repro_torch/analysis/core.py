"""Analyzer framework: findings, waivers, project model, pass registry.

Everything is stdlib ``ast`` — the analyzer never imports the code it
scans (the column manifest is the one exception, loaded from the
port's stores by ``repro_torch.analysis.manifest``; fixture tests
inject their own).

Kernels are keyed on their QUALIFIED name ``module.qualname``, the
module derived from the file's path under ``src/``: a function is a
registered kernel when it carries ``@device_kernel(oracle=...)``
(``repro_torch.core.markers``), and a call reaches it when the callee,
resolved through the file's imports, names that function or a package
above its module that re-exports it.  A function that merely shares a
kernel's bare name is not one.

Waiver syntax (line-scoped, applies to its own line, or — when written
on a comment-only line — to the next code line); the same comments
serve the reference's analyzer::

    self.store.col["burst"][slot] = v   # repro: allow[mirror-invalidation] -- adopted below

File-scoped (anywhere in the file, typically the header)::

    # repro: allow-file[retrace-hazard] -- generated shim, no kernel calls survive

A waiver without a ``-- reason`` is itself an error under ``--strict``.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Optional

WAIVER_RE = re.compile(
    r"#\s*repro:\s*allow(?P<scope>-file)?\["
    r"(?P<rules>[A-Za-z0-9_,\s-]+)\]"
    r"(?:\s*--\s*(?P<reason>\S.*?))?\s*$")

#: calls that invalidate (or wholesale replace) the device mirror
INVALIDATORS = ("mark_dirty", "mark_dirty_slot", "adopt_device",
                "_membership_changed", "_membership_changed_shard")

#: ``np.<ufunc>.at`` in-place scatter ops treated as column writes
_UFUNC_AT = ("add", "subtract", "maximum", "minimum", "multiply")

#: the package of the hand-written kernels' wrappers, and the call that
#: binds a kernel's C entry point (every launch goes through it)
KERNELS_PACKAGE = "repro_torch.kernels"
LAUNCH_ROOTS = frozenset({"repro_torch.kernels.build.function"})

#: ``torch.distributed`` calls that move data between ranks
DIST_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "reduce", "gather", "scatter", "send",
    "recv", "isend", "irecv"})

#: the port's own collectives over a model mesh
COLLECTIVES_MODULE = "repro_torch.distributed.collectives"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    waived: bool = False
    waive_reason: Optional[str] = None

    def format(self) -> str:
        tail = f"  [waived: {self.waive_reason}]" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tail}"


@dataclasses.dataclass
class Waiver:
    rules: tuple[str, ...]
    line: int                 # code line the waiver applies to (0 = file)
    reason: Optional[str]
    file_scoped: bool = False


def module_name(path: str) -> str:
    """Dotted module of a source path: the part under the last ``src``
    directory (``src/repro_torch/core/fleet.py`` →
    ``repro_torch.core.fleet``; a package's ``__init__.py`` is the
    package), else the file's stem."""
    parts = Path(path).with_suffix("").parts
    if "src" in parts:
        parts = parts[len(parts) - parts[::-1].index("src"):]
    else:
        parts = parts[-1:]
    if len(parts) > 1 and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class SourceFile:
    """One parsed source file: AST, waiver table, and the dotted names
    its imports and top-level definitions bind."""

    def __init__(self, path: str, text: str) -> None:
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.module = module_name(path)
        self.waivers: list[Waiver] = []
        self._parse_waivers(text.splitlines())
        #: local name → dotted names it may stand for (imports anywhere
        #: in the file, and the module's own top-level definitions)
        self.aliases: dict[str, set[str]] = {}
        self._collect_aliases()

    def _parse_waivers(self, lines: list[str]) -> None:
        pending: list[Waiver] = []   # comment-line waivers awaiting code
        for i, raw in enumerate(lines, start=1):
            m = WAIVER_RE.search(raw)
            code = raw.split("#", 1)[0].strip()
            if m:
                rules = tuple(r.strip() for r in m.group("rules").split(",")
                              if r.strip())
                w = Waiver(rules=rules, line=i, reason=m.group("reason"),
                           file_scoped=m.group("scope") is not None)
                if w.file_scoped:
                    w = dataclasses.replace(w, line=0)
                    self.waivers.append(w)
                elif code:               # waiver on a code line
                    self.waivers.append(w)
                else:                    # comment-only: bind to next code line
                    pending.append(w)
            elif code and pending:
                for w in pending:
                    self.waivers.append(dataclasses.replace(w, line=i))
                pending = []
        self.waivers.extend(pending)     # trailing orphans keep comment line

    def _collect_aliases(self) -> None:
        package = (self.module if self.path.endswith("__init__.py")
                   else self.module.rpartition(".")[0])
        for local, dotted in import_bindings(self.tree, package):
            self.aliases.setdefault(local, set()).add(dotted)
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                self.aliases.setdefault(node.name, set()).add(
                    f"{self.module}.{node.name}")

    def waiver_for(self, rule: str, line: int) -> Optional[Waiver]:
        for w in self.waivers:
            if rule in w.rules and (w.file_scoped or w.line == line):
                return w
        return None

    def resolve(self, node: ast.AST,
                local: Optional[dict[str, set[str]]] = None) -> set[str]:
        """Dotted names an expression may denote: a Name through the
        function's ``local`` aliases and the file's, an attribute chain
        through its root.  Empty when the root is unknown."""
        attrs: list[str] = []
        while isinstance(node, ast.Attribute):
            attrs.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return set()
        roots = (local or {}).get(node.id) or self.aliases.get(node.id, ())
        tail = "".join(f".{a}" for a in reversed(attrs))
        return {r + tail for r in roots}


def import_bindings(tree: ast.AST, package: str = ""
                    ) -> Iterable[tuple[str, str]]:
    """(local name, dotted name) for every import in ``tree``; relative
    imports resolve against ``package``.  ``import a.b`` binds ``a``."""
    for sub in ast.walk(tree):
        if isinstance(sub, ast.Import):
            for alias in sub.names:
                if alias.asname:
                    yield alias.asname, alias.name
                else:
                    root = alias.name.split(".")[0]
                    yield root, root
        elif isinstance(sub, ast.ImportFrom):
            base = sub.module or ""
            if sub.level:
                pkg = package.split(".") if package else []
                pkg = pkg[:len(pkg) - (sub.level - 1)]
                base = ".".join(pkg + ([base] if base else []))
            for alias in sub.names:
                if alias.name != "*":
                    yield alias.asname or alias.name, f"{base}.{alias.name}"


def refers_to(ref: str, target: str) -> bool:
    """Does the dotted reference ``ref`` name ``target``, a function's
    qualified name — itself, or a re-export from a package above its
    module (``repro_torch.core.admit_quantum`` for
    ``repro_torch.core.vectorized.admit_quantum``)?"""
    if ref == target:
        return True
    pkg, _, name = ref.rpartition(".")
    tpkg, _, tname = target.rpartition(".")
    return bool(pkg) and name == tname and tpkg.startswith(pkg + ".")


@dataclasses.dataclass(frozen=True)
class KernelDecl:
    """A ``@device_kernel(oracle=...)`` declaration found in the AST."""

    name: str                 # qualified: "module.qualname"
    qualname: str             # "func" or "Class.method"
    oracle: Optional[str]     # None → malformed declaration
    path: str
    line: int


@dataclasses.dataclass(frozen=True)
class FuncDecl:
    """A function of interest (hot path / kernel definition) with its
    context."""

    qualname: str             # "Class.method" or "func"
    node: ast.AST
    file: "SourceFile"

    @property
    def name(self) -> str:
        return f"{self.file.module}.{self.qualname}"


@dataclasses.dataclass
class TestRefs:
    """What one test module references: bare identifiers (Name ids,
    attribute names, imported names) and qualified names (imports, and
    attribute chains through an imported module)."""

    idents: set[str]
    qualified: set[str]

    def names(self, target: str) -> bool:
        return any(refers_to(q, target) for q in self.qualified)


class Project:
    """Everything the passes share: parsed files, the column manifest,
    kernel/hot-path declarations, the functions that launch a
    hand-written kernel and those that call a collective."""

    def __init__(self, files: list[SourceFile], manifest,
                 tests: Optional[dict[str, TestRefs]] = None) -> None:
        self.files = files
        self.manifest = manifest
        #: test file path → what it references
        self.tests = tests or {}
        self.kernels: dict[str, KernelDecl] = {}
        self.hot_paths: list[FuncDecl] = []
        #: functions outside ``repro_torch.kernels`` that launch a
        #: hand-written kernel, directly or through a wrapper
        self.launch_defs: list[FuncDecl] = []
        #: functions that call a collective (sharded kernels), outside
        #: the collective layer itself
        self.collective_defs: list[FuncDecl] = []
        #: qualified names whose call launches a kernel
        self.launchers: set[str] = set(LAUNCH_ROOTS)
        self._callees: dict[int, list[tuple[str, ast.Call]]] = {}
        self._collect()

    def functions(self) -> Iterable[tuple[SourceFile, ast.AST, str]]:
        for f in self.files:
            for node, qualname in iter_functions(f.tree):
                yield f, node, qualname

    def _collect(self) -> None:
        for f, node, qualname in self.functions():
            decs = node.decorator_list
            if any(_dec_is(d, "hot_path") for d in decs):
                self.hot_paths.append(FuncDecl(qualname, node, f))
            for d in decs:
                if isinstance(d, ast.Call) and _dec_is(d.func,
                                                       "device_kernel"):
                    oracle = None
                    for kw in d.keywords:
                        if kw.arg == "oracle" and isinstance(
                                kw.value, ast.Constant) and isinstance(
                                kw.value.value, str):
                            oracle = kw.value.value
                    name = f"{f.module}.{qualname}"
                    self.kernels[name] = KernelDecl(
                        name, qualname, oracle, f.path, node.lineno)
        # wrappers: functions of the kernels package that reach a launch
        wrappers = [(f, node, q) for f, node, q in self.functions()
                    if f.module.startswith(KERNELS_PACKAGE + ".")]
        grew = True
        while grew:
            grew = False
            for f, node, qualname in wrappers:
                name = f"{f.module}.{qualname}"
                if name not in self.launchers and self.calls_any(
                        f, node, self.launchers):
                    self.launchers.add(name)
                    grew = True
        for f, node, qualname in self.functions():
            if f.module.startswith(KERNELS_PACKAGE + "."):
                continue
            decl = FuncDecl(qualname, node, f)
            if self.calls_any(f, node, self.launchers):
                self.launch_defs.append(decl)
            if not _in_collective_layer(decl.name) and any(
                    is_collective(n) for n, _ in self.callees(f, node)):
                self.collective_defs.append(decl)

    def callees(self, f: SourceFile, func: ast.AST
                ) -> Iterable[tuple[str, ast.Call]]:
        """Dotted names of everything ``func`` calls (memoised)."""
        key = id(func)
        if key not in self._callees:
            local = local_aliases(f, func)
            self._callees[key] = [(n, call) for call in calls_in(func)
                                  for n in f.resolve(call.func, local)]
        return self._callees[key]

    def calls_any(self, f: SourceFile, func: ast.AST,
                  targets: Iterable[str]) -> bool:
        targets = tuple(targets)
        return any(refers_to(n, t) for n, _ in self.callees(f, func)
                   for t in targets)

    def kernel_calls(self, f: SourceFile, func: ast.AST
                     ) -> list[tuple[ast.Call, KernelDecl]]:
        """Calls inside ``func`` that reach a registered kernel."""
        out, seen = [], set()
        for n, call in self.callees(f, func):
            if id(call) in seen:
                continue
            hit = next((k for k in self.kernels.values()
                        if refers_to(n, k.name)), None)
            if hit is not None:
                seen.add(id(call))
                out.append((call, hit))
        return out


COLLECTIVE_LAYER = (
    # the wrappers that ARE the collectives: the model mesh's, the
    # model runtime's tp entry/exit, and the row mesh's combines
    COLLECTIVES_MODULE + ".",
    "repro_torch.models.runtime.Runtime.",
    "repro_torch.core.shard_plane.RowMesh.",
)


def _in_collective_layer(name: str) -> bool:
    return name.startswith(COLLECTIVE_LAYER)


def is_collective(dotted: str) -> bool:
    """A ``torch.distributed`` data collective, or a function of the
    port's collectives module."""
    pkg, _, fn = dotted.rpartition(".")
    return (pkg == "torch.distributed" and fn in DIST_COLLECTIVES) or \
        pkg == COLLECTIVES_MODULE


# -- AST helpers shared by the passes ----------------------------------------

def iter_functions(tree: ast.Module) -> Iterable[tuple[ast.AST, str]]:
    """Top-level and class-level functions as (node, qualname)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.name
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield sub, f"{node.name}.{sub.name}"


def calls_in(node: ast.AST) -> list[ast.Call]:
    return [sub for sub in ast.walk(node) if isinstance(sub, ast.Call)]


def local_aliases(f: SourceFile, func: ast.AST) -> dict[str, set[str]]:
    """Names a function binds to a resolvable expression
    (``fn = shard_plane.shard_admit_quantum``, also pairwise in a tuple
    assignment), resolved through the file's aliases."""
    out: dict[str, set[str]] = {}
    for sub in ast.walk(func):
        if not isinstance(sub, ast.Assign):
            continue
        for t in sub.targets:
            pairs = [(t, sub.value)]
            if isinstance(t, ast.Tuple) and isinstance(sub.value, ast.Tuple) \
                    and len(t.elts) == len(sub.value.elts):
                pairs = list(zip(t.elts, sub.value.elts))
            for tgt, val in pairs:
                if isinstance(tgt, ast.Name) and isinstance(
                        val, (ast.Name, ast.Attribute)):
                    names = f.resolve(val)
                    if names:
                        out.setdefault(tgt.id, set()).update(names)
    return out


def _dec_is(dec: ast.AST, name: str) -> bool:
    return (isinstance(dec, ast.Name) and dec.id == name) or (
        isinstance(dec, ast.Attribute) and dec.attr == name)


def mentions(node: ast.AST, names: set[str]) -> bool:
    """Does the subtree reference any of ``names`` (Name or Attribute)?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in names:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in names:
            return True
    return False


def collect_aliases(func: ast.AST) -> tuple[set[str], dict[str, str]]:
    """Scan a function for ``x = <...>.col`` aliases and
    ``y = <...>.col["name"]`` column aliases.  Returns
    (col-dict alias names, column-array alias name → column name)."""
    col_aliases: set[str] = set()
    column_of: dict[str, str] = {}
    simple = [
        sub for sub in ast.walk(func)
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1
        and isinstance(sub.targets[0], ast.Name)]
    for sub in simple:          # phase 1: dict aliases (c = store.col)
        if isinstance(sub.value, ast.Attribute) and sub.value.attr == "col":
            col_aliases.add(sub.targets[0].id)
    for sub in simple:          # phase 2: column aliases (w = c["x"])
        col = resolve_col(sub.value, col_aliases, {})
        if col is not None:
            column_of[sub.targets[0].id] = col
    return col_aliases, column_of


def resolve_col(node: ast.AST, col_aliases: set[str],
                column_of: dict[str, str]) -> Optional[str]:
    """Column name if ``node`` denotes a whole column array:
    ``<...>.col["name"]``, ``alias["name"]``, or a column alias Name."""
    if isinstance(node, ast.Name):
        return column_of.get(node.id)
    if isinstance(node, ast.Subscript):
        base, key = node.value, node.slice
        is_col_dict = (isinstance(base, ast.Attribute) and base.attr == "col"
                       ) or (isinstance(base, ast.Name)
                             and base.id in col_aliases)
        if is_col_dict and isinstance(key, ast.Constant) and isinstance(
                key.value, str):
            return key.value
    return None


@dataclasses.dataclass(frozen=True)
class ColWrite:
    column: str
    node: ast.AST             # the write statement / call
    value: Optional[ast.AST]  # RHS for assignments, None for ufunc.at


def col_writes(func: ast.AST) -> list[ColWrite]:
    """Every write to a named store/table column inside ``func``:
    subscript assignment, aug-assignment, whole-column assignment, and
    ``np.<ufunc>.at`` scatter calls — through one level of aliasing."""
    col_aliases, column_of = collect_aliases(func)
    writes: list[ColWrite] = []

    def target_col(t: ast.AST) -> Optional[str]:
        col = resolve_col(t, col_aliases, column_of)
        if col is None and isinstance(t, ast.Subscript):
            col = resolve_col(t.value, col_aliases, column_of)
        return col

    for sub in ast.walk(func):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                col = target_col(t)
                if col is not None:
                    # skip the aliasing assignment itself (x = c["a"])
                    if isinstance(t, ast.Name):
                        continue
                    writes.append(ColWrite(col, sub, sub.value))
        elif isinstance(sub, ast.AugAssign):
            col = target_col(sub.target)
            if col is not None:
                writes.append(ColWrite(col, sub, sub.value))
        elif isinstance(sub, ast.Call):
            fn = sub.func
            if (isinstance(fn, ast.Attribute) and fn.attr == "at"
                    and isinstance(fn.value, ast.Attribute)
                    and fn.value.attr in _UFUNC_AT and sub.args):
                col = resolve_col(sub.args[0], col_aliases, column_of)
                if col is not None:
                    writes.append(ColWrite(col, sub, None))
    return writes


def followed_by_invalidation(func: ast.AST, write: ast.AST) -> bool:
    """True when the statement containing ``write`` is followed — in
    its own suite or any enclosing suite of ``func`` — by a direct
    ``<...>.mark_dirty()`` / ``adopt_device(...)`` /
    ``_membership_changed()`` call, or when the containing statement
    itself ends in one (compound one-liners).  Conditional siblings
    (an ``if`` wrapping the call) do NOT count: the invalidation must
    be unconditional on the write's own path."""
    path = _statement_path(func, write)
    if path is None:
        return False
    for suite, idx in reversed(path):
        for stmt in suite[idx + 1:]:
            if _is_invalidation_stmt(stmt):
                return True
    return False


def _is_invalidation_stmt(stmt: ast.AST) -> bool:
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        fn = stmt.value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        return name in INVALIDATORS
    return False


def _statement_path(func: ast.AST, target: ast.AST
                    ) -> Optional[list[tuple[list, int]]]:
    """Suite chain [(suite, index), ...] from the function body down to
    the statement containing ``target``."""

    def search(suite: list) -> Optional[list[tuple[list, int]]]:
        for i, stmt in enumerate(suite):
            if stmt is target or any(sub is target for sub in ast.walk(stmt)):
                for field in ("body", "orelse", "finalbody"):
                    child = getattr(stmt, field, None)
                    if isinstance(child, list) and child:
                        deeper = search(child)
                        if deeper is not None and any(
                                sub is target
                                for s in child for sub in ast.walk(s)):
                            return [(suite, i)] + deeper
                if isinstance(stmt, ast.Try):
                    for handler in stmt.handlers:
                        deeper = search(handler.body)
                        if deeper is not None:
                            return [(suite, i)] + deeper
                return [(suite, i)]
        return None

    return search(func.body)


# -- pass registry ------------------------------------------------------------

class Pass:
    """Base class: subclasses set ``rule``/``description`` and
    implement :meth:`run`."""

    rule: str = ""
    description: str = ""

    def run(self, project: Project) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


PASS_REGISTRY: dict[str, type] = {}


def register_pass(cls: type) -> type:
    PASS_REGISTRY[cls.rule] = cls
    return cls


# -- report -------------------------------------------------------------------

@dataclasses.dataclass
class Report:
    findings: list[Finding]
    #: waivers missing a ``-- reason`` (strict-mode error), as
    #: (path, line, rules)
    reasonless_waivers: list[tuple[str, int, tuple[str, ...]]]
    rules_run: tuple[str, ...]
    files_scanned: int

    @property
    def unwaived(self) -> list[Finding]:
        return [f for f in self.findings if not f.waived]

    @property
    def waived(self) -> list[Finding]:
        return [f for f in self.findings if f.waived]

    def ok(self, strict: bool = False) -> bool:
        if self.unwaived:
            return False
        if strict and self.reasonless_waivers:
            return False
        return True

    def to_json(self) -> dict:
        rules: dict[str, dict] = {
            r: {"findings": 0, "waived": 0} for r in self.rules_run}
        for f in self.findings:
            entry = rules.setdefault(f.rule, {"findings": 0, "waived": 0})
            entry["findings"] += 1
            if f.waived:
                entry["waived"] += 1
        return {
            "rules": rules,
            "files_scanned": self.files_scanned,
            "unwaived_total": len(self.unwaived),
            "reasonless_waivers": [
                {"path": p, "line": ln, "rules": list(rs)}
                for p, ln, rs in self.reasonless_waivers],
            "findings": [dataclasses.asdict(f) for f in self.findings],
        }


def collect_sources(paths: Iterable[str]) -> list[SourceFile]:
    files: list[SourceFile] = []
    for p in paths:
        root = Path(p)
        candidates = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for c in candidates:
            files.append(SourceFile(str(c), c.read_text()))
    return files


def parse_tests(tests_dir: Optional[str]) -> dict[str, TestRefs]:
    """Test file path → what it references — the cross-reference table
    for the oracle-parity pass.  Qualified names come from the imports
    (``from repro_torch.core.fleet import plan_fleet as t_plan`` gives
    ``repro_torch.core.fleet.plan_fleet``) and from attribute chains
    through an imported module (``TV.admit_quantum`` after ``from
    repro_torch.core import vectorized as TV``)."""
    out: dict[str, TestRefs] = {}
    if not tests_dir:
        return out
    root = Path(tests_dir)
    if not root.is_dir():
        return out
    for p in sorted(root.rglob("*.py")):
        try:
            tree = ast.parse(p.read_text(), filename=str(p))
        except SyntaxError:
            continue
        idents: set[str] = set()
        qualified: set[str] = set()
        aliases: dict[str, set[str]] = {}
        for local, dotted in import_bindings(tree):
            aliases.setdefault(local, set()).add(dotted)
            qualified.add(dotted)
        for sub in ast.walk(tree):
            if isinstance(sub, ast.Name):
                idents.add(sub.id)
            elif isinstance(sub, ast.Attribute):
                idents.add(sub.attr)
                chain, node = [], sub
                while isinstance(node, ast.Attribute):
                    chain.append(node.attr)
                    node = node.value
                if isinstance(node, ast.Name):
                    tail = "".join(f".{a}" for a in reversed(chain))
                    qualified.update(r + tail
                                     for r in aliases.get(node.id, ()))
            elif isinstance(sub, (ast.Import, ast.ImportFrom)):
                for alias in sub.names:
                    idents.add(alias.name.rsplit(".", 1)[-1])
                    if alias.asname:
                        idents.add(alias.asname)
        out[str(p)] = TestRefs(idents, qualified)
    return out


def analyze(paths: Iterable[str], *, manifest=None,
            tests_dir: Optional[str] = "tests",
            rules: Optional[Iterable[str]] = None) -> Report:
    """Run the registered passes over ``paths`` and apply waivers."""
    from repro_torch.analysis import passes as _passes  # noqa: F401
    from repro_torch.analysis.manifest import default_manifest

    if manifest is None:
        manifest = default_manifest()
    files = collect_sources(paths)
    project = Project(files, manifest, tests=parse_tests(tests_dir))
    selected = tuple(rules) if rules else tuple(sorted(PASS_REGISTRY))
    unknown = set(selected) - set(PASS_REGISTRY)
    if unknown:
        raise ValueError(f"unknown rules: {sorted(unknown)}")

    by_path = {f.path: f for f in files}
    findings: list[Finding] = []
    for rule in selected:
        for raw in PASS_REGISTRY[rule]().run(project):
            src = by_path.get(raw.path)
            w = src.waiver_for(raw.rule, raw.line) if src else None
            if w is not None:
                raw = dataclasses.replace(
                    raw, waived=True,
                    waive_reason=w.reason or "(no reason given)")
            findings.append(raw)

    reasonless = [
        (f.path, w.line, w.rules)
        for f in files for w in f.waivers if not w.reason]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(findings=findings, reasonless_waivers=reasonless,
                  rules_run=selected, files_scanned=len(files))
