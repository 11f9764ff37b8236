"""The control at a size a test run holds: the reference computed in
fp8, one precision below the configuration's bfloat16, put in the
program's place, puts tokens first that the float32 reference ranks far
lower than the program's served tokens, and ``check.verdict`` finds it
not correct where it finds the program correct."""
import pytest
import torch

import bench_tiny_cells as tiny
from bench_tiny_cells import one_thread  # noqa: F401 (an autouse fixture)
from harness import arch, cell, check

#: the tiny cells' ``logit_gap`` limit, between the readings below
LIMIT = 0.1


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_control_fails_the_limit(name, seed):
    res = tiny.resolved(name, LIMIT)
    served = cell.serve(tiny.benchmark(), name, res, seed, 2.0, False, "cpu",
                        log=lambda s: None)
    m = arch.load(res["config"]).harness.dims(res["config"])
    got = check.control_readings(served["inputs"], m, seed, "cpu", ("fp8",))
    program, control = got["program"], got["fp8"]
    assert program["logit_gap"] <= LIMIT < control["logit_gap"]
    assert control["logit_gap"] >= 3 * program["logit_gap"]
    assert check.verdict(program, res["limits"], served["breaches"])[1]
    assert not check.verdict(control, res["limits"], served["breaches"])[1]
    assert torch.isfinite(torch.tensor(control["mean"]))
