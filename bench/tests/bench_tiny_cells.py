"""Tiny cells for the harness's CPU tests: the cells' shapes of
configuration and traffic at a size a test run holds.  Importing this
module puts ``bench/`` and ``src/`` on ``sys.path``."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DENSE = {
    "name": "tiny-dense", "source": "test", "model_type": "llama",
    "hidden_size": 64,
    "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 500, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": True, "torch_dtype": "bfloat16",
    "program_layout": {"rms_norm_eps": 1e-6},
    "serve": {"lanes": 4, "page_tokens": 16, "max_seq": 160},
}
#: the same, with the program's epsilon (no residual scale) and full heads
MHA = dict(DENSE, name="tiny-mha", num_key_value_heads=4, rms_norm_eps=1e-6,
           program_layout={"rms_norm_eps": 1e-6})

#: the shapes the FLOP and metric tests count by hand, as a configuration
HAND = {"name": "hand", "model_type": "llama", "num_hidden_layers": 2,
        "hidden_size": 8, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 2, "intermediate_size": 16, "vocab_size": 10,
        "rope_theta": 1e4, "rms_norm_eps": 1e-6, "torch_dtype": "bfloat16"}

LENGTHS = {"prompt": {"law": "lognormal", "median": 48, "sigma": 0.6,
                      "min": 16, "max": 128},
           "output": {"law": "lognormal", "median": 8, "sigma": 0.5,
                      "min": 4, "max": 24}}

OVERLOAD = {
    "name": "tiny-overload", "lengths": LENGTHS, "knee_rps": 10.0,
    "pool": {"tokens_per_s": 20000.0, "bucket_window_s": 60.0},
    "tenants": [
        {"name": "guaranteed-a", "class": "guaranteed", "arrivals": "poisson",
         "rate_rps": 4.0, "reserve_lanes": 2, "slo_ms": 200.0},
        {"name": "spot-b", "class": "spot", "arrivals": "closed",
         "workers": 3, "stagger_s": 0.2, "slo_ms": 30000.0}]}

STEADY = {
    "name": "tiny-steady", "lengths": LENGTHS, "knee_rps": 10.0,
    "pool": {"tokens_per_s": 20000.0, "bucket_window_s": 60.0},
    "tenants": [
        {"name": "assist", "class": "guaranteed", "arrivals": "poisson",
         "rate_rps": 3.0, "reserve_lanes": 2, "slo_ms": 500.0},
        {"name": "analytics", "class": "elastic", "arrivals": "poisson",
         "rate_rps": 3.0, "reserve_lanes": 2, "slo_ms": 5000.0}]}


#: the benchmark's cells and the tiny mix of the same shape
CELLS = {"smollm2-1.7b.tiered-overload": OVERLOAD,
         "smollm2-1.7b.steady": STEADY}


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench = copy.deepcopy(bench)
    for m in bench["per_layer"] + bench["end_to_end"]:
        m.pop("workloads", None)
    return bench


def limits(cell: str) -> dict:
    """The committed limits of a cell of ``BENCHMARK.json``."""
    with open(BENCH / "limits" / f"{cell}.json") as f:
        return json.load(f)


def resolved(cell: str = "smollm2-1.7b.tiered-overload",
             limit: float | None = None, conf: dict = DENSE) -> dict:
    """A tiny stand-in for ``cell``: the tiny configuration under the
    tiny mix of the cell's shape, with the cell's committed limits or a
    ``logit_gap`` limit of its own."""
    return {"cell": {"name": cell, "chips": 1},
            "config": copy.deepcopy(conf),
            "traffic": copy.deepcopy(CELLS[cell]),
            "limits": limits(cell) if limit is None
            else {"logit_gap": limit}}
@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one intra-op thread while a module runs: the suite's
    xdist workers share the cores, and a worker's spinning threads make
    these small ops many times slower (and the tiny windows serve
    nothing).  A test module imports it to have it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
