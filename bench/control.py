"""The readings a cell's limits are set from: the program's numbers and
the control's, on the chip at the cell's own size and load.

    python3 bench/control.py --workload <name> --seconds <s> --seeds 11,12,13 [--control 3]

For each seed, in one process: ``harness.cell.serve`` sets the cell up
from the seed and drives one window at its own load, exactly as a run of
``run.py`` does, and frees the program's state; then the float32
reference reads the served tokens.  For the first ``--control`` seeds
the control is read as well: the reference computed in fp8 (float8
e4m3 inputs to every matrix product, float32 accumulation), one
precision below the configuration's bfloat16, in the program's place:
at each judged position the token it puts first is judged as a served
token would be, and ``check.verdict`` gives its ``correct`` beside the
program's.  One JSON line per seed.  The benchmark's runs do not run
this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    from harness import spec
    spec.process_env(ROOT)
    import torch
    from harness import arch, cell, check, driver
    bench = spec.load_benchmark(ROOT)
    res = spec.resolve(bench, args.workload, ROOT)
    m = arch.load(res["config"]).harness.dims(res["config"])
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        served = cell.serve(bench, args.workload, res, seed, args.seconds,
                            False, "cuda", log=lambda s: None)
        inputs = served["inputs"]
        t = driver.clock()
        precisions = ("fp8", "fp8-tensor") if j < args.control else ()
        out = check.control_readings(inputs, m, seed, "cuda", precisions)
        for side, nums in out.items():
            nums["correct"] = check.verdict(nums, res["limits"],
                                            served["breaches"])[1]
        out.update(seed=seed, requests=len(inputs["seqs"]),
                   reference_s=driver.clock() - t,
                   setup_s=served["metrics"].get("setup_s", {}).get("value"))
        print(json.dumps(out), flush=True)
        del served, inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
