"""Find a cell's knee: the highest rate of its guaranteed-class length
mix, with no spot traffic, at which the backlog does not grow.

    python3 bench/sweep.py --workload <name> --seed <n> --seconds <s> --rates 2,3,4

One process sets the cell up once (weights from the seed, engine, warm
shapes), then for each rate drives a window of ``--seconds`` with one
guaranteed open-loop tenant at that rate (prompt and output lengths from
the cell's mix, the whole engine as its reservation, a token rate that
never binds), drains the engine, and prints one JSON line: requests
due, finished, the backlog (admitted and not finished) at the window's
middle and end, and first-token and ITL percentiles.  The benchmark's
runs do not run this.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def backlog(recs, t: float) -> int:
    return sum(1 for r in recs if r.admitted and r.sent <= t
               and (r.finished is None or r.finished > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    from harness import spec
    spec.process_env(ROOT)
    import numpy as np
    from harness import arch, driver, traffic
    bench = spec.load_benchmark(ROOT)
    res = spec.resolve(bench, args.workload, ROOT)
    conf, mix = res["config"], res["traffic"]
    serve = conf["serve"]
    side = arch.load(conf).harness
    m = side.dims(conf)
    cfg = side.arch_config(conf)
    from repro_torch.kernels import build
    build.build_all()
    engine, _, _ = driver.build(cfg, side.draw_model(m, args.seed, "cuda"),
                                mix, serve, "cuda")
    driver.warm(engine, cfg, mix, serve, "cuda")
    for rate in (float(r) for r in args.rates.split(",")):
        sweep = copy.deepcopy(mix)
        sweep["pool"]["tokens_per_s"] = 1e9
        sweep["tenants"] = [{"name": "sweep", "class": "guaranteed",
                             "arrivals": "poisson", "rate_rps": rate,
                             "reserve_lanes": int(serve["lanes"]),
                             "slo_ms": 1000.0}]
        _, gw, keys = driver.build_pool(cfg, sweep, serve, "cuda")
        engine.gateway = gw
        engine.finished.clear()
        sched = traffic.schedule(sweep, args.seed, args.seconds)
        run = driver.Run(engine, gw.pool, sweep, keys, args.seconds)
        opened = driver.requests(sweep, sched, args.seed, cfg.vocab_size)
        run.drive(opened, [], {}, driver.clock())
        engine.run_until_drained(now=run.now())
        W = args.seconds
        ttft = [r.token_times[0] - r.due for r in run.recs if r.token_times]
        gaps = [b - a for r in run.recs
                for a, b in zip(r.token_times, r.token_times[1:]) if b <= W]
        done = [r for r in run.recs if r.finished is not None
                and r.finished <= W]
        print(json.dumps({
            "rate_rps": rate, "due": len(run.recs),
            "finished_in_window": len(done),
            "backlog_mid": backlog(run.recs, W / 2),
            "backlog_end": backlog(run.recs, W),
            "queue_end": len([r for r in run.recs if r.admitted
                              and r.sent <= W and (not r.token_times
                                                   or r.token_times[0] > W)]),
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_p90_s": float(np.percentile(ttft, 90)) if ttft else None,
            "itl_p95_s": float(np.percentile(gaps, 95)) if gaps else None,
            "served_tok_s": (sum(r.prompt_len for r in run.recs
                                 if r.token_times and r.token_times[0] <= W)
                             + sum(1 for r in run.recs for x in r.token_times
                                   if x <= W)) / W,
            "decode_steps": len(run.decodes),
            "lanes_mean": float(np.mean([len(x[2]) for x in run.decodes]))
            if run.decodes else 0.0}), flush=True)
        engine.finished.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
