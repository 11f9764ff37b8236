"""BENCHMARK.json against the benchmark's contract: names, units and
lines in their allowed characters, every file it names present, every
per-layer metric's cells reporting the end-to-end metric it moves, and
a reader for every metric."""
import json
import re

import pytest

import bench_tiny_cells as tiny

with open(tiny.ROOT / "BENCHMARK.json") as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(line(w) for w in
                                              BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("per_layer", "end_to_end") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra
        assert NAME.match(e["name"])
        for k in ("why", "layer", "source"):
            if k in e:
                assert line(e[k])
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")


def test_cells_and_configs():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (tiny.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (tiny.BENCH / "limits" / f"{w['name']}.json").is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/") and \
            (tiny.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        with open(tiny.ROOT / c["file"]) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"] and conf["source"] == \
            c["source"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank", "_size")) and \
                "intermediate" not in key


def test_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(section):
    from harness.cell import reader
    for m in BENCH[section]:
        assert callable(reader(m["name"]))


def test_files_are_named_from_name_characters():
    for path in tiny.BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(tiny.ROOT).as_posix()
        assert PATH.match(rel), rel
