"""Roofline analysis from dry-run artifacts, under the peaks of the
device the caller names.

Counterpart of ``repro/launch/roofline.py``, which hard-codes TPU v5e
peaks; here the peaks are inputs (``analyze(artifact, peak_flops=,
hbm_bw=, link_bw=)``, the CLI's ``--peak-flops`` / ``--hbm-bw`` /
``--link-bw``), and no default names a device.

Per (arch × shape × mesh) cell:
  compute term    = flops a device / peak FLOP/s
  memory term     = argument bytes a device / HBM bytes/s
  collective term = collective bytes a device / link bytes/s

The dry-run (``launch/dryrun.py``) measures one rank's step on the
``meta`` device: flops from ``torch.utils.flop_counter`` (every layer
counted, so no scan correction), argument bytes from the specs (params,
optimizer state, the paged cache, the batch: each read once, a lower
bound on what the step moves, where the reference reads XLA's
``bytes accessed``), and collective bytes from the collectives' tally,
the all-reduce bytes doubled for a ring's algorithm bandwidth
2(n−1)/n ≈ 2, the others taken once.

MODEL_FLOPS: 6·N·D for train (N = non-embedding params; N_active for
MoE), 2·N·D + attention for prefill, 2·N·B (+ KV reads) per decode
step — the reference's formulas.  The ratio MODEL_FLOPS / counted flops
flags recompute (remat) and dispatch waste.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, param_tree
from repro_torch.models.config import SHAPES
from repro_torch.tree import leaves_with_paths, tensors

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    bytes_per_device: float

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},{self.chips},"
                f"{self.compute_s:.3e},{self.memory_s:.3e},"
                f"{self.collective_s:.3e},{self.dominant},"
                f"{self.model_flops:.3e},{self.hlo_flops_global:.3e},"
                f"{self.useful_ratio:.3f},{self.bytes_per_device:.3e}")


def _param_counts(cfg) -> tuple[float, float]:
    """(total non-embedding params, active non-embedding params)."""
    model = build_model(cfg).init(torch.Generator().manual_seed(0), "meta")
    total = moe = emb = 0
    for path, leaf in leaves_with_paths(param_tree(model)):
        key = "/".join(path)
        n = sum(t.numel() for t in tensors(leaf))
        total += n
        if "moe/w_" in key:
            moe += n
        if key.endswith("embed/table"):
            emb += n
    non_emb = total - emb
    if cfg.is_moe and cfg.num_experts:
        frac = cfg.experts_per_token / cfg.num_experts
        active = non_emb - moe + moe * frac
    else:
        active = non_emb
    return float(non_emb), float(active)


def _attn_layers(cfg) -> int:
    return sum(1 for k in (list(cfg.pattern) * cfg.n_periods
                           + list(cfg.tail_kinds))
               if k in ("global", "local"))


def model_flops(cfg, shape) -> float:
    n_total, n_active = _param_counts(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * B * S
    if shape.kind == "prefill":
        attn = (2.0 * 2.0 * B * S * S / 2.0 * cfg.num_heads
                * cfg.head_dim * _attn_layers(cfg) / max(cfg.num_layers, 1))
        return 2.0 * n_active * B * S + attn
    # decode: one token per sequence + attention over the KV history
    kv_read = (2.0 * 2.0 * B * S * cfg.num_heads * cfg.head_dim
               * _attn_layers(cfg) / max(cfg.num_layers, 1))
    return 2.0 * n_active * B + kv_read


def analyze(artifact: dict, *, peak_flops: float, hbm_bw: float,
            link_bw: float) -> Roofline | None:
    """The cell's roofline under the given peaks (FLOP/s, bytes/s of
    device memory, bytes/s of one device's link); None unless the
    artifact's status is ``ok``."""
    if artifact.get("status") != "ok":
        return None
    cfg = get_config(artifact["arch"])
    shape = SHAPES[artifact["shape"]]
    chips = artifact["chips"]
    flops_dev = artifact["flops"]
    bytes_dev = artifact["argument_size_in_bytes"]
    by_kind = artifact["collectives"]["bytes_by_kind"]
    coll_dev = sum(v * (2.0 if k == "all-reduce" else 1.0)
                   for k, v in by_kind.items())
    compute_s = flops_dev / peak_flops
    memory_s = bytes_dev / hbm_bw
    collective_s = coll_dev / link_bw
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    counted = flops_dev * chips
    return Roofline(
        arch=artifact["arch"], shape=artifact["shape"],
        mesh=artifact["mesh"], chips=chips, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, dominant=dominant,
        model_flops=mf, hlo_flops_global=counted,
        useful_ratio=mf / counted if counted > 0 else 0.0,
        bytes_per_device=float(bytes_dev))


def load_artifacts(directory: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default=os.path.normpath(ARTIFACT_DIR))
    ap.add_argument("--peak-flops", type=float, required=True,
                    help="the device's peak FLOP/s for the model's dtype")
    ap.add_argument("--hbm-bw", type=float, required=True,
                    help="the device's memory bytes/s")
    ap.add_argument("--link-bw", type=float, required=True,
                    help="one device's interconnect bytes/s")
    args = ap.parse_args(argv)
    print("arch,shape,mesh,chips,compute_s,memory_s,collective_s,"
          "dominant,model_flops,hlo_flops_global,useful_ratio,"
          "bytes_per_device")
    for art in load_artifacts(args.artifacts):
        r = analyze(art, peak_flops=args.peak_flops, hbm_bw=args.hbm_bw,
                    link_bw=args.link_bw)
        if r is not None:
            print(r.row())
        else:
            print(f"{art['arch']},{art['shape']},{art['mesh']},,,,,"
                  f"SKIP,,,,")


if __name__ == "__main__":
    main()
