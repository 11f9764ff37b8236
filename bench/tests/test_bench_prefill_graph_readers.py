"""The readers of the prefill graphs' span args, ``prefill_graphed_share``
and ``prefill_pad_share`` and their ``.steady`` twins, on synthetic
program records."""
import pytest

import bench_tiny_cells  # noqa: F401  (puts bench/ on sys.path)
from harness.cell import reader


def prefills(*spans):
    """A program record of ``engine.prefill`` spans, each (prompt tokens,
    its end args or None: a program that records none)."""
    out = []
    for i, (tokens, end) in enumerate(spans):
        args = {"lane": 0, "prompt_tokens": tokens, **(end or {})}
        out.append([i, "engine.prefill", "engine", float(i), i + 0.5, None,
                    f"r{i}", None, None, args])
    return {"trace": None,
            "program": {"spans": out, "counters": [], "dropped": 0}}


def graphed(tokens, bucket):
    return (tokens, {"graphed": True, "bucket": bucket,
                     "padded_tokens": bucket - tokens})


def eager(tokens):
    return (tokens, {"graphed": False, "bucket": tokens,
                     "padded_tokens": 0})


@pytest.mark.parametrize("twin", ["", ".steady"])
def test_prefill_graph_readers(twin):
    rec = prefills(graphed(300, 320), graphed(2100, 2560), eager(600),
                   graphed(1000, 1024))
    assert reader(f"prefill_graphed_share{twin}")(rec) == \
        pytest.approx(75.0)
    assert reader(f"prefill_pad_share{twin}")(rec) == \
        pytest.approx(100.0 * (20 + 460 + 24) / (300 + 2100 + 600 + 1000))
    rec = prefills(eager(600), eager(256))
    assert reader(f"prefill_graphed_share{twin}")(rec) == 0.0
    assert reader(f"prefill_pad_share{twin}")(rec) == 0.0


@pytest.mark.parametrize("name", [
    "prefill_graphed_share", "prefill_pad_share",
    "prefill_graphed_share.steady", "prefill_pad_share.steady"])
def test_prefill_graph_readers_need_the_programs_args(name):
    """No program record, one that dropped events, no prefill, or
    prefill spans without the args (a program without the graphs):
    no number."""
    assert reader(name)({"trace": None}) is None
    assert reader(name)({"trace": None, "program": None}) is None
    rec = prefills(graphed(300, 320))
    rec["program"]["dropped"] = 1
    assert reader(name)(rec) is None
    assert reader(name)(prefills()) is None
    assert reader(name)(prefills((300, None), (700, None))) is None
