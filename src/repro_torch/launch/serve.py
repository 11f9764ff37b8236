"""Serving launcher: a token-pool-governed engine on a small model.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24

Brings up: TokenPool (+virtual node) → Gateway (key auth, admission) →
InferenceEngine (continuous batching over a PyTorch model on a paged
KV cache), and drives a two-tenant workload (guaranteed + spot) through
it.  Counterpart of ``repro/launch/serve.py``: the same options and the
same printed lines, plus ``--device`` (default ``cuda``; the flash and
paged attention kernels run there).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    EntitlementSpec,
    PoolSpec,
    QoS,
    Resources,
    ScalingBounds,
    ServiceClass,
    TokenPool,
)
from repro_torch.gateway import Gateway
from repro_torch.models import build_model
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.request import latency_summary


def build_gateway(cfg, slots: int, max_tokens: int, device="cuda",
                  kv_bytes: float = float(1 << 30)
                  ) -> tuple[TokenPool, Gateway]:
    """The two-tenant pool behind a gateway: ``prod`` (GUARANTEED) and
    ``batch`` (SPOT, with a pre-funded budget), keys ``k-prod`` and
    ``k-batch``.  The replica holds ``kv_bytes`` of KV (1 GiB unless
    the caller gives the engine's page pool).  The pool's control tick
    runs on ``device``."""
    spec = PoolSpec(name=cfg.name, model=cfg.name,
                    scaling=ScalingBounds(1, 1),
                    per_replica=Resources(2e4, float(kv_bytes),
                                          float(slots)),
                    default_max_tokens=max_tokens)
    pool = TokenPool(spec, device=device)
    pool.add_entitlement(EntitlementSpec(
        name="prod", tenant_id="prod", pool=cfg.name,
        qos=QoS(ServiceClass.GUARANTEED, 200.0),
        baseline=Resources(1e4, 0.0, float(slots))))
    pool.add_entitlement(EntitlementSpec(
        name="batch", tenant_id="batch", pool=cfg.name,
        qos=QoS(ServiceClass.SPOT, 30000.0),
        baseline=Resources(0.0, 0.0, 0.0)))
    pool.ledger.set_rate("batch", 2e4, 0.0)
    pool.ledger.bucket("batch").level = 2e4
    gw = Gateway(pool)
    gw.register_key("k-prod", "prod")
    gw.register_key("k-batch", "batch")
    return pool, gw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(vocab_size=1024, num_layers=4)
    model = build_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model.init(gen, args.device)
    pool, gw = build_gateway(cfg, args.slots, args.max_tokens, args.device)

    eng = InferenceEngine(model, params, slots=args.slots,
                          max_seq=cfg.max_seq_len, gateway=gw)
    reqs = []
    for i in range(args.requests):
        tenant = "prod" if i % 2 == 0 else "batch"
        r = Request(request_id=f"r{i}", entitlement=tenant,
                    prompt_tokens=[2 + i % 7, 3, 5],
                    max_tokens=args.max_tokens, arrival_s=float(i) * 0.01,
                    api_key=f"k-{tenant}")
        reqs.append(r)
        eng.submit(r, now=r.arrival_s)
    eng.run_until_drained()

    for tenant in ("prod", "batch"):
        sel = [r for r in reqs if r.entitlement == tenant]
        print(tenant, latency_summary(sel))
    print("pool tokens served:", {
        n: pool.status[n].tokens_total for n in pool.status})


if __name__ == "__main__":
    main()
