"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic and
limits are files under ``bench/``, found by the names in
``BENCHMARK.json``.  The last line of standard output is the result as
one JSON object; the numbers compared for ``correct`` are also the last
lines of standard error.  Exits non-zero, and prints no result, where
the card or the cards the cell asks for are missing, or where the
process holds JAX or the JAX package once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules the run may not hold (whole names: the port's
#: package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec
    spec.process_env(ROOT)
    bench = spec.load_benchmark(ROOT)
    resolved = spec.resolve(bench, args.workload, ROOT)
    chips = int(resolved["cell"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from harness.cell import run_cell
    result = run_cell(bench, args.workload, resolved, args.seed,
                      args.seconds, bool(args.trace), "cuda",
                      log=lambda s: print(s, flush=True))
    leaked = forbidden_modules()
    if leaked:
        print(f"the run holds forbidden modules: {leaked}", file=sys.stderr)
        return 3
    for name, c in result["compare"].items():
        print(f"compare {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
