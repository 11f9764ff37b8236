"""The port's sanitizer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the same inputs.

* every framework-free fixture (mirror invalidation, the hot path,
  telemetry, the chaos harness, the waiver cases, the CLI's exit codes,
  the report's JSON) gives identical findings — rule, line, waived and
  reason — from both analyzers;
* every kernel-keyed fixture (dtype discipline, shape bucketing, the
  inline mesh, oracle parity) and its torch twin give the same (rule,
  line) set; the two checks the port drops (``static_argnames`` hygiene,
  trace-time capture) are stated as a divergence of their own;
* the port's own tree is clean under ``--strict``, and removing the
  port's parity tests of the fleet planner turns ``oracle-parity`` red;
* ``assert_no_rebuild`` passes a steady gateway loop on a CPU pool and
  raises on a planted whole-mirror upload and a planted kernel build.

Fixture sources live in ``tests/torch_analysis_fixtures.py``."""
import json
import shutil
import textwrap
from pathlib import Path

import pytest

import repro.analysis as RA
import repro.analysis.__main__ as RA_main
import repro_torch.analysis as TA
import repro_torch.analysis.__main__ as TA_main
import torch_analysis_fixtures as FX

REPO = Path(__file__).resolve().parent.parent
PORT_SRC = REPO / "src" / "repro_torch"

PORT_KERNELS = {
    "repro_torch.core.control_plane.control_tick":
        "repro.core.control_plane.control_tick",
    "repro_torch.core.control_plane.control_tick_pools":
        "repro.core.control_plane.control_tick_pools",
    "repro_torch.core.vectorized.tick_batch":
        "repro.core.vectorized.tick_batch",
    "repro_torch.core.vectorized.admit_quantum":
        "repro.core.vectorized.admit_quantum",
    "repro_torch.core.fleet.plan_fleet": "repro.core.fleet.plan_fleet",
    "repro_torch.core.shard_plane.shard_tick":
        "repro.core.control_plane.control_tick",
    "repro_torch.core.shard_plane.shard_admit_quantum":
        "repro.core.vectorized.admit_quantum",
    "repro_torch.core.shard_plane.shard_plan_fleet":
        "repro.core.fleet.plan_fleet",
}
ALL_RULES = {"mirror-invalidation", "dtype-discipline", "retrace-hazard",
             "hot-path-scalar-loop", "oracle-parity", "telemetry-hot-path",
             "chaos-public-api"}


def findings(report) -> list[tuple]:
    return [(f.rule, f.line, f.waived, f.waive_reason)
            for f in report.findings]


def rule_lines(report) -> set[tuple]:
    return {(f.rule, f.line) for f in report.unwaived}


def run_both(tmp_path, src, rules, paths=None, **kw):
    """The fixture through both analyzers; ``paths`` = (reference's
    path, port's path) when they differ."""
    ref_name, port_name = paths or ("repro/core/mod.py",) * 2
    ref = FX.write(tmp_path / "ref", ref_name, src)
    port = FX.write(tmp_path / "port", port_name, src)
    r = RA.analyze([str(ref)], rules=rules, tests_dir=None,
                   manifest=RA.Manifest.from_exports(FX.SYNTH), **kw)
    t = TA.analyze([str(port)], rules=rules, tests_dir=None,
                   manifest=TA.Manifest.from_exports(FX.SYNTH), **kw)
    return r, t


# -- framework-free rules: identical findings ---------------------------------

@pytest.mark.parametrize("case", FX.FRAMEWORK_FREE, ids=lambda c: c[0])
def test_framework_free_fixture_parity(tmp_path, case):
    name, src, rules, paths = case
    r, t = run_both(tmp_path, src, rules, paths)
    assert findings(t) == findings(r)
    assert [(ln, rs) for _, ln, rs in t.reasonless_waivers] == \
        [(ln, rs) for _, ln, rs in r.reasonless_waivers]
    assert (t.ok(), t.ok(strict=True)) == (r.ok(), r.ok(strict=True))
    assert t.rules_run == r.rules_run
    if "violating" in name:
        assert t.unwaived, "a violating fixture must be flagged"
    if name == "waiver-same-line":
        assert [f.waive_reason for f in t.waived] == \
            ["adopted wholesale below"]


def test_multi_rule_waiver_parsing():
    src = textwrap.dedent(FX.MULTI_RULE_WAIVER)
    [w] = TA.SourceFile("x.py", src).waivers
    [rw] = RA.SourceFile("x.py", src).waivers
    assert (w.rules, w.reason, w.file_scoped, w.line) == \
        (rw.rules, rw.reason, rw.file_scoped, rw.line) == \
        (("rule-a", "rule-b"), "both", False, 2)


def test_report_json_shape_parity(tmp_path):
    src = FX.MIRROR_VIOLATING + FX.WAIVER_REASONLESS
    r, t = run_both(tmp_path, src, None)
    rj, tj = r.to_json(), t.to_json()
    for blob in (rj, tj):
        for f in blob["findings"]:
            f.pop("path")
        for w in blob["reasonless_waivers"]:
            w.pop("path")
    assert tj == rj
    assert set(tj["rules"]) == ALL_RULES


@pytest.mark.parametrize("case", [
    ("violation", FX.HOT_VIOLATING, ["--rules", "hot-path-scalar-loop"], 1),
    ("clean-strict", FX.HOT_CLEAN, ["--strict"], 0),
    ("reasonless", FX.WAIVER_REASONLESS, [], 0),
    ("reasonless-strict", FX.WAIVER_REASONLESS, ["--strict"], 1),
    ("unknown-rule", FX.HOT_CLEAN, ["--rules", "no-such-rule"], 2),
], ids=lambda c: c[0])
def test_cli_exit_codes_match(tmp_path, capsys, case):
    _, src, args, code = case
    bad = FX.write(tmp_path, "mod.py", src)
    argv = [*args, "--tests-dir", str(tmp_path), str(bad)]
    assert RA_main.main(argv) == code
    ref_out = capsys.readouterr().out
    assert TA_main.main(argv) == code
    out = capsys.readouterr().out
    assert out == ref_out
    if code == 1:
        assert "error" in out or "hot-path-scalar-loop" in out


def test_cli_list_rules(capsys):
    assert RA_main.main(["--list-rules"]) == 0
    ref_ids = [ln.split(":")[0] for ln in capsys.readouterr().out.split("\n")
               if ln]
    assert TA_main.main(["--list-rules"]) == 0
    ids = [ln.split(":")[0] for ln in capsys.readouterr().out.split("\n")
           if ln]
    assert ids == ref_ids == sorted(ALL_RULES)


def test_manifest_round_trip_and_contract():
    m = TA.default_manifest()
    for back in (TA.Manifest.from_json(m.to_json()),
                 RA.Manifest.from_json(m.to_json())):
        assert back.mirrored == m.mirrored
        assert back.kernel_f32 == m.kernel_f32
        assert back.f64_columns == m.f64_columns
        assert back.sanctioned_mutators == m.sanctioned_mutators
    # the port's stores carry the reference's column contract
    ref = RA.default_manifest()
    assert (m.mirrored, m.kernel_f32, m.f64_columns,
            m.sanctioned_mutators) == (ref.mirrored, ref.kernel_f32,
                                       ref.f64_columns,
                                       ref.sanctioned_mutators)
    assert [s["module"] for s in m.stores] == [
        "repro_torch.core.resident", "repro_torch.core.request_table",
        "repro_torch.telemetry.flight"]


# -- kernel-keyed rules: the same (rule, line) set on the twins ---------------

def run_twins(tmp_path, case):
    name, rule, ref_src, twin_src, ref_path, port_path, with_tests = case
    ref = FX.write(tmp_path / "ref", ref_path, ref_src)
    port = FX.write(tmp_path / "port" / "src", port_path, twin_src)
    ref_tests = port_tests = None
    if with_tests:
        ref_tests = str(tmp_path / "ref_tests")
        FX.write(Path(ref_tests), "test_parity.py", FX.PARITY_TEST_REF)
        port_tests = str(tmp_path / "port_tests")
        module = port_path[:-3].replace("/", ".")
        FX.write(Path(port_tests), "test_parity.py",
                 FX.PARITY_TEST_TWIN.format(module=module))
    r = RA.analyze([str(ref)], rules=[rule], tests_dir=ref_tests,
                   manifest=RA.Manifest.from_exports(FX.SYNTH))
    t = TA.analyze([str(port)], rules=[rule], tests_dir=port_tests,
                   manifest=TA.Manifest.from_exports(FX.SYNTH))
    return r, t


@pytest.mark.parametrize("case", FX.KERNEL_KEYED, ids=lambda c: c[0])
def test_kernel_keyed_twin_parity(tmp_path, case):
    r, t = run_twins(tmp_path, case)
    assert rule_lines(t) == rule_lines(r)
    if "violating" in case[0] or "deleted" in case[0]:
        assert t.unwaived


def test_retrace_dropped_checks_diverge(tmp_path):
    """The port's pass keeps the unbucketed-call check and makes neither
    of the two jit-only checks: a non-literal ``static_argnames`` with
    an unhashable static argument, and a kernel body mutating a
    module-level dict (trace-time capture) are flagged by the reference
    only."""
    src = FX.RETRACE_VIOLATING
    ref = FX.write(tmp_path / "ref", "repro/core/mod.py", src)
    port = FX.write(tmp_path / "port" / "src", "repro_torch/core/mod.py",
                    FX.RETRACE_VIOLATING_TWIN)
    r = RA.analyze([str(ref)], rules=["retrace-hazard"], tests_dir=None,
                   manifest=RA.Manifest.from_exports(FX.SYNTH))
    t = TA.analyze([str(port)], rules=["retrace-hazard"], tests_dir=None,
                   manifest=TA.Manifest.from_exports(FX.SYNTH))
    kept = {("retrace-hazard", FX.line_of(src, "return k(arr)"))}
    dropped = {("retrace-hazard", FX.line_of(src, needle)) for needle in (
        "static_argnames=NAMES", 'COUNTS["k"] += 1', "coeff=[1, 2]")}
    assert rule_lines(r) == kept | dropped
    assert rule_lines(t) == kept
    [f] = t.unwaived
    assert "without bucket_width/quantum_width padding" in f.message


def test_inline_row_mesh_message(tmp_path):
    case = next(c for c in FX.KERNEL_KEYED if c[0] == "shard-violating")
    _, t = run_twins(tmp_path, case)
    [f] = t.unwaived
    assert f.line == FX.line_of(FX.SHARD_VIOLATING_TWIN, "mesh=RowMesh(")
    assert "inline RowMesh" in f.message and "row_mesh" in f.message


def test_dtype_torch_idioms(tmp_path):
    src = FX.DTYPE_TORCH_IDIOMS
    p = FX.write(tmp_path / "src", "repro_torch/core/mod.py", src)
    t = TA.analyze([str(p)], rules=["dtype-discipline"], tests_dir=None,
                   manifest=TA.Manifest.from_exports(FX.SYNTH))
    lines = textwrap.dedent(src).splitlines()
    expected = {i for i, ln in enumerate(lines, 1)
                if ln.endswith(("# f64", "# truncates"))}
    assert {f.line for f in t.unwaived} == expected
    assert len(t.unwaived) == len(expected)


def test_kernels_keyed_on_qualified_names(tmp_path):
    """A function that only shares a registered kernel's bare name is
    not a kernel, and its unbucketed caller is not a finding; callers
    of the registered one are, through the module, an alias or a local
    rebinding."""
    root = tmp_path / "src" / "repro_torch" / "core"
    FX.write(root, "kern.py", FX.QUALIFIED_KERNEL)
    FX.write(root, "callers.py", FX.QUALIFIED_CALLERS)
    t = TA.analyze([str(tmp_path / "src")], rules=["retrace-hazard"],
                   tests_dir=None,
                   manifest=TA.Manifest.from_exports(FX.SYNTH))
    src = FX.QUALIFIED_CALLERS
    assert {(Path(f.path).name, f.line) for f in t.unwaived} == {
        ("callers.py", FX.line_of(src, "return kern.step(arr)")),
        ("callers.py", FX.line_of(src, "return fn(arr)"))}


def test_parity_needs_qualified_test_references(tmp_path):
    """A test module that names the kernel and the oracle only by their
    bare names (the reference's fixture) does not cover a port kernel."""
    p = FX.write(tmp_path / "src", "repro_torch/core/mod.py",
                 FX.PARITY_SRC_TWIN)
    tests = tmp_path / "tests"
    FX.write(tests, "test_parity.py", FX.PARITY_TEST_REF)
    t = TA.analyze([str(p)], rules=["oracle-parity"], tests_dir=str(tests),
                   manifest=TA.Manifest.from_exports(FX.SYNTH))
    assert any("parity coverage missing" in f.message and
               "'fused_step'" in f.message for f in t.unwaived)


def test_collective_layer_is_not_a_sharded_kernel(tmp_path):
    root = tmp_path / "src" / "repro_torch"
    FX.write(root, "distributed/collectives.py", FX.COLLECTIVE_LAYER)
    FX.write(root, "models/layer.py", FX.COLLECTIVE_USERS)
    t = TA.analyze([str(tmp_path / "src")], rules=["oracle-parity"],
                   tests_dir=None,
                   manifest=TA.Manifest.from_exports(FX.SYNTH))
    [f] = t.unwaived
    assert Path(f.path).name == "layer.py"
    assert f.line == FX.line_of(FX.COLLECTIVE_USERS, "def tp_sum")
    assert "sharded kernel 'tp_sum'" in f.message


# -- the port's own tree ----------------------------------------------------

@pytest.fixture(scope="module")
def port_report():
    return TA.analyze([str(PORT_SRC)], tests_dir=str(REPO / "tests"))


def test_port_clean_under_strict(port_report):
    assert [f.format() for f in port_report.unwaived] == []
    assert port_report.reasonless_waivers == []
    assert port_report.ok(strict=True)
    assert set(port_report.rules_run) == ALL_RULES
    assert all(f.waive_reason for f in port_report.waived)


def test_port_registers_its_eight_kernels():
    from repro_torch.analysis.core import Project, collect_sources
    project = Project(collect_sources([str(PORT_SRC)]), TA.default_manifest())
    assert {k: d.oracle for k, d in project.kernels.items()} == PORT_KERNELS


def test_cli_report_over_the_port(tmp_path, capsys):
    out = tmp_path / "ANALYSIS_report.json"
    rc = TA_main.main(["--strict", "--report", str(out), "--tests-dir",
                       str(REPO / "tests"), str(PORT_SRC)])
    assert rc == 0
    blob = json.loads(out.read_text())
    assert blob["unwaived_total"] == 0
    assert set(blob["rules"]) == ALL_RULES
    assert blob["files_scanned"] == len(list(PORT_SRC.rglob("*.py")))
    assert "0 unwaived finding(s)" in capsys.readouterr().out


def test_deleting_the_port_fleet_parity_tests_breaks_the_build(tmp_path):
    """The port's counterpart of the reference's deletion test: the
    modules that hold the port's planner kernel against the JAX one
    (the fleet test and the sharded plane's) are removed from the
    cross-referenced tree, and oracle-parity names it."""
    pruned = tmp_path / "tests"
    shutil.copytree(REPO / "tests", pruned, ignore=shutil.ignore_patterns(
        "test_torch_fleet.py", "test_torch_shard_plane.py", "__pycache__"))
    report = TA.analyze([str(PORT_SRC)], tests_dir=str(pruned),
                        rules=["oracle-parity"])
    named = [f.message for f in report.unwaived
             if "'plan_fleet'" in f.message]
    assert named and "repro.core.fleet.plan_fleet" in named[0]


def test_no_new_module_covers_a_reference_kernel_by_bare_name():
    """These files name no reference kernel together with its reference
    oracle, so the reference's parity pass (bare names, C8) still sees
    exactly the reference's own tests."""
    from repro.analysis.core import Project, collect_sources, parse_tests
    project = Project(collect_sources([str(REPO / "src" / "repro")]),
                      RA.default_manifest())
    refs = {Path(p).name: ids for p, ids in parse_tests(
        str(REPO / "tests")).items()}
    for mod in ("test_torch_analysis.py", "torch_analysis_fixtures.py"):
        for decl in project.kernels.values():
            parts = decl.oracle.split(".")
            symbols = {parts[-1]} | ({parts[-2]} if parts[-2][:1].isupper()
                                     else set())
            assert not (decl.name in refs[mod] and symbols & refs[mod]), \
                (mod, decl.name)


def test_markers_are_zero_overhead():
    from repro_torch.core.markers import DEVICE_KERNELS, device_kernel

    def f():
        return 7

    assert device_kernel(oracle="a.b")(f) is f
    assert f() == 7
    assert DEVICE_KERNELS[f"{__name__}.{f.__qualname__}"].oracle == "a.b"
    del DEVICE_KERNELS[f"{__name__}.{f.__qualname__}"]
    import repro_torch.core.shard_plane  # noqa: F401  (registers)
    assert {k: s.oracle for k, s in DEVICE_KERNELS.items()} == PORT_KERNELS


# -- the runtime cross-check on the CPU ---------------------------------------

def cpu_gateway(n_ents: int):
    import repro_torch.core as T
    from repro_torch.gateway import Gateway
    pool = T.TokenPool(T.PoolSpec(
        name="p", model="m", scaling=T.ScalingBounds(1, 1),
        per_replica=T.Resources(1e9, 1e15, 1e6), shards=4), device="cpu")
    gw = Gateway(pool)
    for i in range(n_ents):
        add_ent(gw, i)
    return gw


def add_ent(gw, i: int) -> None:
    import repro_torch.core as T
    gw.pool.add_entitlement(T.EntitlementSpec(
        name=f"e{i}", tenant_id=f"t{i}", pool="p",
        qos=T.QoS(T.ServiceClass.ELASTIC, 1000.0),
        baseline=T.Resources(400.0 if i % 8 == 0 else 1e6, 0.0,
                             3.0 if i % 8 == 0 else 1e3)))
    gw.register_key(f"k{i}", f"e{i}", pool="p")


def quantum(gw, m: int, tag: str) -> list:
    """``m`` requests, every other one on an entitlement with a small
    bucket (so a long quantum denies)."""
    from repro_torch.gateway import QuantumRequest
    keys = sorted(f"k{n[1:]}" for n in gw.pool.entitlements)
    tight = [k for k in keys if int(k[1:]) % 8 == 0]
    return [QuantumRequest(tight[i // 2 % len(tight)] if i % 2 == 0
                           else keys[i % len(keys)], f"{tag}{i}", 64, 64)
            for i in range(m)]


def test_no_rebuild_across_a_steady_churned_loop():
    from repro_torch.analysis.runtime import assert_no_rebuild
    gw = cpu_gateway(40)
    store = gw.pool.store
    gw.handle_quantum(quantum(gw, 8, "warm"), 0.0)
    nxt, denied = 40, 0
    with assert_no_rebuild(store) as start:
        for j, m in enumerate((2, 7, 31, 300)):
            for name in sorted(gw.pool.entitlements)[:2]:
                gw.pool.remove_entitlement(name, float(j))
            for _ in range(2):
                add_ent(gw, nxt)
                nxt += 1
            out = gw.handle_quantum(quantum(gw, m, f"q{j}-"), 0.5 * j)
            denied += sum(r.status != 200 for r in out)
    assert store.capacity == 64 and store.block_uploads > 0
    assert denied > 0
    assert start.full_uploads == (store.full_uploads,)
    # plain versions on the CPU: no kernel launched
    assert all(n == 0 for routes in start.launched().values()
               for n in routes.values())


def test_planted_growth_raises():
    from repro_torch.analysis.runtime import assert_no_rebuild
    gw = cpu_gateway(40)
    store = gw.pool.store
    gw.handle_quantum(quantum(gw, 8, "warm"), 0.0)
    with pytest.raises(AssertionError, match="whole-mirror uploads"):
        with assert_no_rebuild(store):
            for i in range(store.capacity - len(gw.pool.entitlements) + 1):
                add_ent(gw, 100 + i)
            gw.handle_quantum(quantum(gw, 8, "grown"), 1.0)
    assert store.capacity == 128


def test_planted_build_raises():
    from repro_torch.analysis.runtime import assert_no_rebuild
    from repro_torch.kernels import build
    before = dict(build.BUILD_LOG)
    try:
        with pytest.raises(AssertionError, match="kernels built"):
            with assert_no_rebuild():
                build.BUILD_LOG["admit_quantum"] = (1.0, "planted")
        with assert_no_rebuild():          # nothing built: fine
            pass
    finally:
        build.BUILD_LOG.clear()
        build.BUILD_LOG.update(before)
