"""What decides ``correct``.

Served tokens.  Once the window has closed and the program's state is
freed, a sample of the finished requests, drawn from the seed and
holding the longest, is judged: the plain float32 reference
(``reference.model`` with the architecture's layer) runs once over each
prompt followed by its served tokens, and at each served position it
reads the gap by which the served token's reference logit lies below
the reference's best (all decoding is greedy).  ``logit_gap`` is the
widest such gap (``OUTSIDE`` where a served id is no token of the
vocabulary); a cell's limits file names the numbers it compares.  The reference draws the
published model's weights again from the seed, layer by layer, as the
benchmark drew them for the program.

Admission.  A guaranteed request refused for a reason other than its
own token budget while fewer than its tenant's reserved lanes were in
flight breaks the guarantee the traffic file declares; the count of
such refusals is compared with the limit 0.

``verdict`` turns the numbers into ``correct``; the control
(``control.py``) goes through the same function with the control's
tokens in the program's place.
"""
from __future__ import annotations

import torch

from harness import arch
from harness import traffic as traffic_lib
from harness.driver import GUARANTEE_BREACHES, GUARANTEED
from reference import model as ref_model

#: served tokens a sample holds at least, where the window finished them
SAMPLE_SERVED = 300
#: fed tokens (prompts and served tokens) a sample holds at most
SAMPLE_FED = 49_152
#: the gap read where a served id lies outside the vocabulary
OUTSIDE = 1e9


def sample(run, seed: int) -> list[str]:
    """Finished requests to judge: the longest, then others in an order
    drawn from the seed, until ``SAMPLE_SERVED`` served tokens."""
    done = sorted((r for r in run.recs if r.finished is not None),
                  key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + r.output_len, r.rid))
    rest = [r for r in done if r is not longest]
    order = traffic_lib.rng(seed, 99).permutation(len(rest))
    picked, served = [longest], longest.output_len
    fed = longest.prompt_len + longest.output_len
    for i in order:
        r = rest[int(i)]
        if served >= SAMPLE_SERVED or fed + r.prompt_len + r.output_len \
                > SAMPLE_FED:
            break
        picked.append(r)
        served += r.output_len
        fed += r.prompt_len + r.output_len
    return [r.rid for r in picked]


def replay_inputs(run, picked: list[str]) -> dict:
    """What the reference is given: the fed tokens of every judged
    sequence, its judged positions and its served tokens.  Taken from
    the run before its state is freed."""
    seqs, judged, served = {}, {}, {}
    for rid in picked:
        rec = run.by_rid[rid]
        out = list(rec.req.output_tokens)
        seqs[rid] = torch.tensor(run.fed_tokens(rid), dtype=torch.long)
        judged[rid] = list(range(rec.prompt_len - 1,
                                 rec.prompt_len - 1 + len(out)))
        served[rid] = out
    return {"seqs": seqs, "judged": judged, "served": served}


def reference_logits(inputs: dict, m: dict, seed: int, device,
                     precision: str = "fp32") -> dict:
    """The float32 reference's logits (or, with ``precision``, the
    control's) at the judged positions, from the published weights of
    ``m``'s architecture drawn again from the seed."""
    a = arch.load(m)
    seqs = {r: t.to(device) for r, t in inputs["seqs"].items()}
    return ref_model.replay(
        a.reference, m, seqs, inputs["judged"],
        lambda i: a.harness.published_layer(m, seed, i, device),
        lambda: a.harness.published_head(m, seed, device),
        precision=precision)


def numbers(per: dict) -> dict:
    """The compared numbers of per-position gaps, and the tokens
    ``judged``."""
    allg = torch.cat(list(per.values()))
    return {"logit_gap": float(allg.max()), "judged": allg.numel()}


def logit_gaps(inputs: dict, m: dict, seed: int, device) -> dict:
    """``logit_gap`` of the served tokens, and the tokens ``judged``."""
    if not inputs["judged"]:
        return {"judged": 0}
    n = sum(len(v) for v in inputs["served"].values())
    if any(not 0 <= t < m["vocab"] for v in inputs["served"].values()
           for t in v):
        return {"logit_gap": OUTSIDE, "judged": n}
    ref = reference_logits(inputs, m, seed, device)
    return numbers(ref_model.gaps(ref, inputs["served"]))


def verdict(gaps: dict, limits: dict, breaches: int) -> tuple[dict, bool]:
    """(each compared number beside its limit, ``correct``)."""
    compare = {name: {"value": gaps.get(name), "limit": float(limit)}
               for name, limit in limits.items()}
    compare["guarantee_breaches"] = {"value": breaches, "limit": 0}
    correct = gaps.get("judged", 0) > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compare.values())
    return compare, correct


def gap_summary(per: dict) -> dict:
    """The compared numbers of per-position gaps, with their quantiles
    and the first tokens' widest gap beside them."""
    allg = torch.cat(list(per.values()))
    first = torch.stack([g[0] for g in per.values()])
    q = torch.tensor([0.5, 0.9, 0.95, 0.99])
    return dict(numbers(per), mean=float(allg.mean()),
                quantiles=torch.quantile(allg, q).tolist(),
                mismatch=float((allg > 0).float().mean()),
                first_max=float(first.max()))


def control_readings(inputs: dict, m: dict, seed: int, device,
                     precisions=("fp8", "fp8-tensor")) -> dict:
    """The program's and each control's gap statistics at the judged
    positions, against the float32 reference: each control puts first
    the token its lower precision ranks first."""
    if not inputs["judged"]:
        return {}
    ref = reference_logits(inputs, m, seed, device)
    out = {"program": gap_summary(ref_model.gaps(ref, inputs["served"]))}
    for p in precisions:
        low = reference_logits(inputs, m, seed, device, p)
        picked = {r: low[r].argmax(dim=-1).tolist() for r in low}
        del low
        out[p] = gap_summary(ref_model.gaps(ref, picked))
    return out


def guarantee_breaches(run) -> int:
    """Guaranteed requests refused within their tenant's reservation
    for a reason the guarantee excludes."""
    n = 0
    for r in run.recs:
        reserve = int(run.mix["tenants"][r.tenant].get("reserve_lanes", 0))
        if r.klass in GUARANTEED and not r.admitted \
                and r.reason in GUARANTEE_BREACHES \
                and r.tenant_in_flight < reserve:
            n += 1
    return n
