"""Each metric reader on synthetic records, including a stall in the
window that moves the tails and leaves the medians."""
import pytest

from bench_tiny_cells import HAND
from harness import arch
from harness.cell import reader

DIMS = arch.load(HAND).harness.dims(HAND)


def request(tenant, klass, due, tokens, admitted=True, prompt=100,
            start=None):
    return {"tenant": tenant, "klass": klass, "due": due, "sent": due,
            "admitted": admitted, "prompt_len": prompt,
            "prefill_start": start, "token_times": tokens,
            "finished": tokens[-1] if tokens else None}


def steady(stall=0.0):
    """Twenty guaranteed requests one a second, each with a first token
    0.2 s after its due time and nine more 0.05 s apart.  A stall of
    ``stall`` seconds (a long prefill ahead of them) delays the first
    token of each request due from t = 10 on, and every request's
    tokens after its fifth."""
    reqs = []
    for i in range(20):
        t = [i + 0.2 + 0.05 * j + (stall if j >= 5 else 0.0)
             for j in range(10)]
        t = [x + (stall if i >= 10 else 0.0) for x in t]
        reqs.append(request("g", "guaranteed", float(i), t,
                            start=i + 0.1))
    return {"seconds": 30.0, "end": 31.0, "setup_s": 12.5, "lanes": 4,
            "page_tokens": 16, "dims": DIMS, "requests": reqs,
            "decode_steps": [(0.0, 0.1, 2), (0.1, 0.2, 4), (40.0, 41.0, 4)],
            "spans": {"gateway.handle": [0.001, 0.003],
                      "pool.tick": [0.002],
                      "model.prefill": [(0.2, 1000), (0.1, 1000)],
                      "model.decode_step": [(0.08, 4), (0.12, 4)]},
            "trace": None}


def test_end_to_end():
    rec = steady()
    assert reader("guaranteed_ttft_p90_ms")(rec) == pytest.approx(200.0)
    assert reader("guaranteed_ttft_p75_ms.steady")(rec) == \
        pytest.approx(200.0)
    assert reader("itl_p95_ms")(rec) == pytest.approx(50.0)
    assert reader("served_tok_s")(rec) == pytest.approx(
        (20 * 100 + 200) / 30.0)
    assert reader("setup_s")(rec) == 12.5


@pytest.mark.parametrize("name,base", [
    ("served_tok_s.below_knee", "served_tok_s"),
    ("guaranteed_ttft_p90_ms.overload", "guaranteed_ttft_p90_ms")] + [
    (f"{base}.steady", base) for base in (
        "itl_p95_ms", "admit_ms", "tick_ms", "prefill_ms_per_ktok",
        "decode_step_ms", "mfu", "flash_roofline", "paged_roofline",
        "idle_share")])
def test_a_metric_read_in_another_regime_is_the_same_reading(name, base):
    for rec in (steady(), steady(stall=2.0), traced()):
        assert reader(name)(rec) == reader(base)(rec)


def test_a_stall_moves_the_tails():
    calm, stalled = steady(), steady(stall=2.0)
    for name in ("guaranteed_ttft_p75_ms.steady", "guaranteed_ttft_p90_ms"):
        assert reader(name)(stalled) > reader(name)(calm) + 1000.0
    assert reader("itl_p95_ms")(stalled) > 1000.0
    assert reader("itl_p95_ms")(calm) == pytest.approx(50.0)


def test_refused_and_unserved_guaranteed_count_to_the_end():
    rec = steady()
    rec["requests"] += [request("g", "guaranteed", 29.0, [],
                                admitted=False)] * 5
    # five of 25 wait until the run ended, at 31 s: 2 s each
    assert reader("guaranteed_ttft_p90_ms")(rec) == pytest.approx(2000.0)
    rec["requests"].append(request("g", "guaranteed", 30.5, []))
    assert reader("guaranteed_ttft_p90_ms")(rec) == pytest.approx(2000.0)


def test_host_span_readers():
    rec = steady()
    assert reader("admit_ms")(rec) == pytest.approx(2.0)
    assert reader("tick_ms")(rec) == pytest.approx(2.0)
    assert reader("prefill_ms_per_ktok")(rec) == pytest.approx(150.0)
    assert reader("decode_step_ms")(rec) == pytest.approx(100.0)
    assert reader("queue_wait_ms")(rec) == pytest.approx(100.0)
    assert reader("lane_occupancy")(rec) == pytest.approx(75.0)


def test_spot_share():
    rec = steady()
    assert reader("spot_admit_share")(rec) is None
    rec["requests"] += [request("s", "spot", 1.0, [2.0]),
                        request("s", "spot", 2.0, [], admitted=False),
                        request("s", "spot", 3.0, [], admitted=False),
                        request("s", "spot", 40.0, [], admitted=False)]
    assert reader("spot_admit_share")(rec) == pytest.approx(100.0 / 3)


def traced():
    """``steady()`` with a traced window: two seconds, 1.5 busy."""
    rec = steady()
    rec["trace"] = {"window_s": 2.0, "busy_s": 1.5,
                    "kernel_s": {"flash_prefill_wgmma_kernel": 1e-3,
                                 "paged_group_kernel": 2e-4,
                                 "paged_merge_kernel": 1e-4,
                                 "ampere_gemm": 1.0},
                    "kernel_n": {}, "idle_by_phase": {},
                    "prefill_tokens": [3], "decode_contexts": [[5, 1]]}
    return rec


def test_trace_readers():
    for name in ("mfu", "flash_roofline", "paged_roofline", "idle_share"):
        assert reader(name)(steady()) is None  # nothing traced: no number
    rec = traced()
    from reference import flops
    assert reader("idle_share")(rec) == pytest.approx(25.0)
    work = flops.prefill_flops(DIMS, 3) + flops.decode_flops(DIMS, [5, 1])
    assert reader("mfu")(rec) == pytest.approx(100 * work / (2.0 * 989e12))
    assert reader("flash_roofline")(rec) == pytest.approx(
        100 * 2 * flops.flash_bound_s(DIMS, 3) / 1e-3)
    assert reader("paged_roofline")(rec) == pytest.approx(
        100 * 2 * flops.paged_bound_s(DIMS, [5, 1]) / 3e-4)
    rec["trace"]["prefill_tokens"] = []
    assert reader("flash_roofline")(rec) is None
