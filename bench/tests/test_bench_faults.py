"""A whole run on the CPU at a tiny size, with the search for a chip
skipped and the timed path broken underneath: against each cell's
committed limits, ``correct`` comes out false for each fault a served
cell can have, and true without one.  (The cells run on one chip, so
there is no exchange between chips to leave out.)"""
import pytest
import torch

import bench_tiny_cells as tiny
from bench_tiny_cells import one_thread  # noqa: F401 (an autouse fixture)
from harness import spec
from harness.cell import run_cell
from repro_torch.models import transformer

REAL = transformer.decode_step


def frozen_state(params, tokens, cache, tables, positions, lanes=None,
                 **kw):
    """A decode step that leaves the KV pages as it found them."""
    saved = [t.clone() for t in cache.k + cache.v]
    out = REAL(params, tokens, cache, tables, positions, lanes=lanes, **kw)
    for t, s in zip(cache.k + cache.v, saved):
        t.copy_(s)
    return out


def half_batch(params, tokens, cache, tables, positions, lanes=None, **kw):
    """A decode step over the first half of its rows, the rest given
    the mean of their logits."""
    B = tokens.shape[0]
    if B < 2:
        return REAL(params, tokens, cache, tables, positions, lanes=lanes,
                    **kw)
    h = B // 2
    out = REAL(params, tokens[:h], cache, tables[:h], positions[:h],
               lanes=None if lanes is None else lanes[:h], **kw)
    return torch.cat([out, out.mean(0, keepdim=True).expand(
        B - h, *out.shape[1:])])


def altered_token(params, tokens, cache, tables, positions, lanes=None,
                  **kw):
    """A decode step whose first row's best token moves to its
    neighbour."""
    out = REAL(params, tokens, cache, tables, positions, lanes=lanes, **kw)
    out[0, 0] = out[0, 0].roll(1)
    return out


def run(cell, monkeypatch, fault=None, bench=None):
    if fault is not None:
        monkeypatch.setattr(transformer, "decode_step", fault)
    return run_cell(bench or tiny.benchmark(), cell, tiny.resolved(cell),
                    2**31 + 101, 2.0, False, "cpu", log=lambda s: None)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(cell, monkeypatch):
    """Correct, judged by the cell's limits, and reporting the
    end-to-end metrics that ``BENCHMARK.json`` gives the cell (those of
    cells added later are theirs)."""
    bench = spec.load_benchmark()
    out = run(cell, monkeypatch, bench=bench)
    assert out["correct"], out["compare"]
    assert list(out["compare"]) == list(tiny.limits(cell)) + [
        "guarantee_breaches"]
    assert set(out["metrics"]) == {
        m["name"] for m in bench["end_to_end"]
        if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("fault", [frozen_state, half_batch, altered_token],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    out = run(cell, monkeypatch, fault)
    assert not out["correct"], out["compare"]
