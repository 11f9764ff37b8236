"""Resolve a cell of ``BENCHMARK.json`` by name: its entry, its model
configuration file, its traffic file and its limits file.  Everything
that belongs to one configuration, one traffic mix or one cell is a
file of its own; this module only finds them."""
from __future__ import annotations

import json
import math
import os
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def process_env(root: Path = ROOT) -> None:
    """Point the program's build and kernel caches at fixed directories
    inside the checkout, keep libraries from loading JAX, and put the
    program's sources on the path.  Call before importing torch."""
    import sys
    build = root / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    if str(root / "src") not in sys.path:
        sys.path.insert(0, str(root / "src"))


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration, traffic and limits
    files read: ``{"cell", "config", "traffic", "limits"}``."""
    w = cell(bench, workload)
    conf = read_json(root / config_entry(bench, w["config"])["file"])
    traffic = read_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = read_json(BENCH / "limits" / f"{w['name']}.json")
    return {"cell": w, "config": conf, "traffic": traffic,
            "limits": limits}


def model_dims(conf: dict) -> dict:
    """The sizes the harness, the reference and the FLOP counts use,
    from a configuration file's Hugging Face keys (a Llama decoder with
    a tied output table).  ``eps`` is the source's RMSNorm epsilon and
    ``program_eps`` the one the program applies; ``residual_scale`` is
    the factor c = sqrt(program_eps / eps) by which the program's
    residual stream is scaled so that its epsilon acts as the source's
    (``weights.py``)."""
    heads = int(conf["num_attention_heads"])
    eps = float(conf["rms_norm_eps"])
    program_eps = float(conf.get("program_layout", {}).get(
        "rms_norm_eps", eps))
    return {
        "name": conf["name"],
        "layers": int(conf["num_hidden_layers"]),
        "d_model": int(conf["hidden_size"]),
        "heads": heads,
        "kv_heads": int(conf["num_key_value_heads"]),
        "head_dim": int(conf.get("head_dim")
                        or int(conf["hidden_size"]) // heads),
        "d_ff": int(conf["intermediate_size"]),
        "vocab": int(conf["vocab_size"]),
        "padded_vocab": (int(conf["vocab_size"]) + 255) // 256 * 256,
        "rope_theta": float(conf["rope_theta"]),
        "eps": eps,
        "program_eps": program_eps,
        "residual_scale": math.sqrt(program_eps / eps),
        "dtype": conf["torch_dtype"],
    }


def arch_config(conf: dict):
    """The program's ``ArchConfig`` for a configuration file."""
    from repro_torch.models.config import ArchConfig
    if not conf["tie_word_embeddings"] or conf.get("rope_scaling") \
            or conf.get("attention_bias") or conf.get("mlp_bias"):
        raise ValueError(f"{conf['name']}: the program computes Llama "
                         "layers with a tied table, no biases and plain "
                         "RoPE only")
    m = model_dims(conf)
    serve = conf["serve"]
    return ArchConfig(
        name=m["name"], family="dense",
        num_layers=m["layers"], d_model=m["d_model"],
        num_heads=m["heads"], num_kv_heads=m["kv_heads"],
        head_dim=m["head_dim"], d_ff=m["d_ff"], vocab_size=m["vocab"],
        max_seq_len=int(serve["max_seq"]), pattern=("global",),
        mlp_kind="swiglu", rope_theta=m["rope_theta"],
        tie_embeddings=True, dtype=conf["torch_dtype"],
        source=conf["source"])
