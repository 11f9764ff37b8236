"""Training launcher.

Single-device example (the end-to-end example trains a ~100M model):
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduce 100m --steps 300

Counterpart of ``repro/launch/train.py``: the same options and the same
printed lines, plus ``--device`` (default ``cuda``) and ``--seed`` (the
generator of the random init; the reference starts from its fixed
``PRNGKey(0)``).  Multi-device training belongs with model sharding,
which the port does not have yet.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models import build_model, param_count
from repro_torch.training.grad_compress import CompressorConfig
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import TrainConfig, TrainLoop


def reduce_to_100m(cfg):
    """A ~100M-param member of the same family."""
    return dataclasses.replace(
        cfg,
        num_layers=max(len(cfg.pattern) * 2, 8 // max(len(cfg.pattern), 1)
                       * len(cfg.pattern)),
        d_model=768, num_heads=12,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 4)),
        head_dim=64, d_ff=0 if cfg.d_ff == 0 else 2048,
        vocab_size=32000, max_seq_len=2048,
        num_experts=min(cfg.num_experts, 8) if cfg.is_moe else 0,
        experts_per_token=min(cfg.experts_per_token, 2)
        if cfg.is_moe else 0,
        rnn_width=0 if cfg.rnn_width == 0 else 768,
        name=cfg.name + "-100m")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduce", choices=["none", "100m", "smoke"],
                    default="100m")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--compress", choices=["none", "topk", "int8"],
                    default="none")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce == "100m":
        cfg = reduce_to_100m(cfg)
    elif args.reduce == "smoke":
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(
        torch.Generator(device=args.device).manual_seed(args.seed),
        args.device)
    n = param_count(params)
    print(f"arch={cfg.name} params={n/1e6:.1f}M devices=1")

    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch))
    tcfg = TrainConfig(
        steps=args.steps, checkpoint_every=100,
        checkpoint_dir=args.checkpoint_dir,
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=20,
                                  total_steps=args.steps),
        compressor=CompressorConfig(kind=args.compress),
        log_every=10)
    loop = TrainLoop(model, data, tcfg, params=params)
    logs = loop.run()
    print("step,loss,accuracy,grad_norm,lr")
    for e in logs:
        print(f"{e['step']},{e['loss']:.4f},{e['accuracy']:.4f},"
              f"{e['grad_norm']:.3f},{e['lr']:.2e}")
    return logs


if __name__ == "__main__":
    main()
