"""The engine against the reference's, and fault C9, for every family
of ``tests/test_torch_families.py`` (which describes both):
TokenPool → Gateway → InferenceEngine in both packages, float32,
identical greedy tokens, states and timestamps; the C9 idle lane."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.serving as JS
import repro_torch.serving as TS
from torch_families_support import ARCHS, MOE, engine, models, \
    no_launches, serve  # noqa: F401 (an autouse fixture)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    waves = arch in MOE
    ref = serve("jax", arch, 3, waves)
    port = serve("torch", arch, 3, waves)
    for a, b in zip(ref["requests"], port["requests"]):
        assert a == b, (arch, a[0])
    assert ref == port
    assert all(q[1] == "finished" for q in ref["requests"])


def test_c9_idle_lane_takes_expert_capacity_in_the_reference():
    """Two lanes: r0 (lane 0, 3 tokens) and r1 (lane 1, 14 tokens).
    While both are live the engines agree token for token.  After r0
    finishes, r1 alone continued from its lane's KV (the JAX model at
    B=1) is what the port's engine gives; the JAX engine, which still
    decodes r0's stale lane ahead of r1 (C = 1 slot per expert at
    T = 2), gives other tokens."""
    arch = "qwen3-moe-30b-a3b"
    cfg, jmodel, jparams, _, _ = models(arch)
    prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 9))
    out = {}
    for side in ("jax", "torch"):
        serving = JS if side == "jax" else TS
        pool, eng = engine(side, arch, 2)
        reqs = [serving.Request(request_id=f"r{i}", entitlement="prod",
                                prompt_tokens=prompts[i].tolist(),
                                max_tokens=(3, 14)[i], arrival_s=0.0,
                                api_key="k-prod") for i in range(2)]
        for q in reqs:
            eng.submit(q, now=0.0)
        now = 0.0
        while reqs[0].state.value != "finished":
            eng.step(now)
            now += 0.05
        if side == "jax":       # r1's lane, continued alone
            lane = eng.lanes[1]
            one = {"periods": jax.tree.map(lambda x: x[:, 1:2],
                                           eng.cache["periods"])}
            tok, pos, alone = reqs[1].output_tokens[-1], lane.position, []
            dec = jax.jit(lambda p, t, c, i: jmodel.decode_step(p, t, c, i))
            for _ in range(lane.remaining):
                logits, one = dec(jparams, jnp.asarray([[tok]], jnp.int32),
                                  one, jnp.asarray([pos], jnp.int32))
                tok = int(jnp.argmax(logits[0, 0]))
                alone.append(tok)
                pos += 1
            n_shared = len(reqs[1].output_tokens)
        eng.run_until_drained(now)
        out[side] = [list(q.output_tokens) for q in reqs]
    assert out["jax"][0] == out["torch"][0]
    assert out["jax"][1][:n_shared] == out["torch"][1][:n_shared]
    assert out["torch"][1][n_shared:] == alone
    assert out["jax"][1][n_shared:] != alone
