"""The port's ``plan_fleet`` against the reference's, on the CPU.

The reference is a jitted ``vmap``; the port is a dozen torch ops over
[P] tensors.  All five outputs (desired, reason, demand EWMA, low
ticks, need) must carry the same bits for P from 1 to 4,096, at
``demand_ewma`` 0.5 and 0.7, with unseeded rows, infinite needs (a
dimension the replica lacks) and padding rows.  0.7 is the case that
catches a missing fused multiply-add in the EWMA (fault C1): an unfused
transcription differs on hundreds of rows there.

The planner around it, entitlement migration and the closed loop are
held against the reference in ``tests/test_torch_fleet_planner.py``.
(That module, not this one, holds the planner against the scalar
autoscaler: the reference's parity pass keys the reference kernel's
oracle coverage to ``tests/test_fleet.py`` alone.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.fleet import plan_fleet as j_plan_fleet
from repro_torch.core import control_plane as TC
from repro_torch.core.fleet import plan_fleet as t_plan_fleet

OUTPUTS = ("desired", "reason", "ewma", "low_ticks", "need")


def seeded_inputs(P: int, seed: int) -> dict:
    """[P] plan inputs: mixed bounds, replica shapes with missing
    dimensions (infinite need), reserves, demands, 20 % unseeded rows,
    and the last eighth of the rows set up as ``FleetPlanner._arrays``
    pads (per-replica 1, bounds [1, 1], nothing reserved)."""
    r = np.random.RandomState(seed)
    a = dict(
        current=r.randint(1, 9, P).astype(np.int32),
        lo=r.randint(1, 3, P).astype(np.int32),
        hi=r.randint(3, 9, P).astype(np.int32),
        per_tps=r.choice([0.0, 120.0, 240.0, 250.0], P).astype(np.float32),
        per_kv=r.choice([0.0, 1e9], P).astype(np.float32),
        per_conc=r.choice([0.0, 4.0, 16.0], P).astype(np.float32),
        res_tps=(r.uniform(0, 960, P) * (r.rand(P) < 0.7)).astype(
            np.float32),
        res_kv=r.choice([0.0, 5e8, 3e9], P).astype(np.float32),
        res_conc=(r.uniform(0, 32, P) * (r.rand(P) < 0.5)).astype(
            np.float32),
        demand_tps=r.uniform(0, 2500, P).astype(np.float32),
        ewma_prev=r.uniform(0, 2500, P).astype(np.float32),
        seeded=r.rand(P) < 0.8,
        low_ticks=r.randint(0, 6, P).astype(np.int32))
    pad = P - P // 8
    for k, v in (("current", 1), ("lo", 1), ("hi", 1), ("per_tps", 1.0),
                 ("per_kv", 1.0), ("per_conc", 1.0), ("res_tps", 0.0),
                 ("res_kv", 0.0), ("res_conc", 0.0), ("demand_tps", 0.0),
                 ("ewma_prev", 0.0), ("seeded", False), ("low_ticks", 0)):
        if P > 1:
            a[k][pad:] = v
    return a


def bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("ewma", [0.5, 0.7])
@pytest.mark.parametrize("P", [1, 3, 8, 64, 512, 4096])
def test_plan_fleet_bit_for_bit(P, ewma):
    a = seeded_inputs(P, seed=P)
    cfg = dict(demand_ewma=ewma, cooldown_ticks=3, headroom=1.2)
    ref = j_plan_fleet(**{k: jnp.asarray(v) for k, v in a.items()},
                       config=J.FleetPlannerConfig(**cfg))
    port = t_plan_fleet(**{k: torch.from_numpy(v) for k, v in a.items()},
                        config=T.FleetPlannerConfig(**cfg))
    for name, x, y in zip(OUTPUTS, ref, port):
        x, y = np.asarray(x), y.numpy()
        assert x.dtype == y.dtype, name
        bad = int((bits(x) != bits(y)).sum())
        assert bad == 0, f"{name}: {bad} of {P} differ"
    need = port[4].numpy()
    if P >= 64:
        inf = np.isinf(need) & (a["current"] <= a["hi"])
        assert inf.any()                            # unsatisfiable rows
        assert (port[0].numpy()[inf] == a["hi"][inf]).all()  # up to hi
        assert set(port[1].numpy()) == set(range(5))


def test_unfused_ewma_would_differ():
    """The inputs at 4,096 pools and ``demand_ewma`` 0.7 do tell a fused
    EWMA from an unfused one, so the test above would catch a port that
    dropped the FMA."""
    a = seeded_inputs(4096, seed=4096)
    prev, d = torch.from_numpy(a["ewma_prev"]), torch.from_numpy(
        a["demand_tps"])
    fused = TC.ewma(prev, d, 0.7).numpy()
    unfused = (torch.tensor(0.7, dtype=torch.float32) * prev
               + torch.tensor(1.0 - 0.7, dtype=torch.float32) * d).numpy()
    assert (bits(fused) != bits(unfused)).sum() > 100
