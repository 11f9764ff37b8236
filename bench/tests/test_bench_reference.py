"""The plain reference against the published models as Hugging Face's
``LlamaForCausalLM`` and ``Qwen3ForCausalLM`` compute them, against the
program's own float32 forward on the weights the harness hands it, and
over a served window, on the CPU at a tiny size."""
import os
import types

import pytest
import torch

import bench_tiny_cells as tiny
from bench_tiny_cells import one_thread  # noqa: F401 (an autouse fixture)
from harness import arch, check, driver, traffic
from reference import llama as llama_ref
from reference import model as ref_model
from reference import qwen3 as qwen3_ref

CONFIGS = {"gqa-scaled": tiny.DENSE, "mha": tiny.MHA}
LLAMA = arch.load(tiny.DENSE)
#: a 2-layer Qwen3 at G 2 with an untied head, as ``dims`` would give it
QWEN3 = {"layers": 2, "d_model": 64, "heads": 4, "kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab": 500, "rope_theta": 1e6,
         "eps": 1e-6}


def float32(conf):
    return dict(conf, torch_dtype="float32")


def reference(m, seed, tokens):
    n = tokens.numel()
    return ref_model.replay(
        LLAMA.reference, m, {"r": tokens}, {"r": list(range(n))},
        lambda i: LLAMA.harness.published_layer(m, seed, i, "cpu"),
        lambda: LLAMA.harness.published_head(m, seed, "cpu"))["r"]


def transformers_or_skip():
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    return pytest.importorskip("transformers")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_matches_transformers(name):
    """The reference is the published Llama decoder: Hugging Face's
    implementation, given the published weights, gives its logits."""
    transformers = transformers_or_skip()
    conf = float32(CONFIGS[name])
    m = LLAMA.harness.dims(conf)
    seed = 2**33 + 9
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=m["vocab"], hidden_size=m["d_model"],
        intermediate_size=m["d_ff"], num_hidden_layers=m["layers"],
        num_attention_heads=m["heads"], num_key_value_heads=m["kv_heads"],
        head_dim=m["head_dim"], rms_norm_eps=m["eps"],
        rope_theta=m["rope_theta"], max_position_embeddings=256,
        tie_word_embeddings=True, attention_bias=False, mlp_bias=False,
        hidden_act="silu")).eval()
    head = LLAMA.harness.published_head(m, seed, "cpu")
    hf.model.embed_tokens.weight.data.copy_(head["embed"])
    hf.model.norm.weight.data.copy_(head["final_norm"])
    d = m["d_model"]
    for i, layer in enumerate(hf.model.layers):
        w = LLAMA.harness.published_layer(m, seed, i, "cpu")
        a, f = w["attn"], w["mlp"]
        layer.input_layernorm.weight.data.copy_(w["ln1"])
        layer.post_attention_layernorm.weight.data.copy_(w["ln2"])
        layer.self_attn.q_proj.weight.data.copy_(a["wq"].reshape(d, -1).t())
        layer.self_attn.k_proj.weight.data.copy_(a["wk"].reshape(d, -1).t())
        layer.self_attn.v_proj.weight.data.copy_(a["wv"].reshape(d, -1).t())
        layer.self_attn.o_proj.weight.data.copy_(a["wo"].reshape(-1, d).t())
        layer.mlp.gate_proj.weight.data.copy_(f["w_gate"].t())
        layer.mlp.up_proj.weight.data.copy_(f["w_up"].t())
        layer.mlp.down_proj.weight.data.copy_(f["w_down"].t())
    assert hf.lm_head.weight.data_ptr() == hf.model.embed_tokens.weight.data_ptr()
    tokens = torch.randint(0, m["vocab"], (41,),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = hf(tokens[None]).logits[0]
    got = reference(m, seed, tokens)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_equals_forward(name):
    """The program, given the harness's layout of the same draw (its
    (1 + s) norms and its epsilon, with the residual stream scaled to
    match), computes the published model."""
    from repro_torch.models.transformer import Transformer, forward_train
    conf = float32(CONFIGS[name])
    m, cfg = LLAMA.harness.dims(conf), LLAMA.harness.arch_config(conf)
    seed = 2**33 + 5
    params = Transformer(cfg, LLAMA.harness.draw_model(m, seed, "cpu"))
    tokens = torch.randint(0, m["vocab"], (1, 37),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = forward_train(params, tokens)[0, :, :m["vocab"]]
    got = reference(m, seed, tokens[0])
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_epsilon_is_the_sources():
    """Without the residual scale the program's epsilon would differ
    from the source's, and the logits with it: the scale is not idle."""
    conf = float32(tiny.DENSE)
    m = LLAMA.harness.dims(conf)
    assert m["residual_scale"] == pytest.approx((1e-6 / 1e-5) ** 0.5)
    seed, tokens = 21, torch.arange(30) * 7 % m["vocab"]
    base = reference(m, seed, tokens)
    off = reference(dict(m, eps=1e2), seed, tokens)
    assert (base - off).abs().max() > 1e-3


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_replay_of_a_served_window(cell):
    """The engine in float32 through gateway and lanes: the reference
    over the sampled requests puts every served token first."""
    res = tiny.resolved(cell)
    conf, mix = float32(res["config"]), res["traffic"]
    m, cfg = LLAMA.harness.dims(conf), LLAMA.harness.arch_config(conf)
    seed = 77
    eng, pool, keys = driver.build(cfg, LLAMA.harness.draw_model(m, seed, "cpu"),
                                   mix, conf["serve"], "cpu")
    from repro_torch.models import Runtime
    eng.cache = eng.model.init_cache(           # a float32 cache, as the
        eng.kv_pages.total_pages,               # weights: nothing rounds
        eng.kv_pages.page_tokens, Runtime(kv_cache_dtype="float32"), "cpu",
        lanes=eng.slots)
    sched = traffic.schedule(mix, seed, 2.0)
    run = driver.Run(eng, pool, mix, keys, 2.0)
    run.drive(driver.requests(mix, sched, seed, cfg.vocab_size),
              sched.workers, driver.worker_prompts(sched, seed,
                                                   cfg.vocab_size),
              driver.clock())
    assert max(len(rows) for _, _, rows in run.decodes) > 1
    inputs = check.replay_inputs(run, check.sample(run, seed))
    gaps = check.logit_gaps(inputs, m, seed, "cpu")
    assert gaps["judged"] >= 50
    assert gaps["logit_gap"] <= 1e-4


def qwen3_weights(m, seed):
    """Published Qwen3 weights in the reference's layout, float32:
    matrices of standard deviation 1/sqrt(fan-in), norm weights
    1 + 0.1 times a standard normal."""
    gen = torch.Generator().manual_seed(seed)
    d, H, G, dh, f, V = (m["d_model"], m["heads"], m["kv_heads"],
                         m["head_dim"], m["d_ff"], m["vocab"])

    def mat(*shape, fan_in):
        return torch.randn(*shape, generator=gen) / fan_in ** 0.5

    def norm(n):
        return 1.0 + 0.1 * torch.randn(n, generator=gen)

    layers = [{"ln1": norm(d), "ln2": norm(d),
               "attn": {"wq": mat(d, H, dh, fan_in=d),
                        "wk": mat(d, G, dh, fan_in=d),
                        "wv": mat(d, G, dh, fan_in=d),
                        "wo": mat(H, dh, d, fan_in=H * dh),
                        "q_norm": norm(dh), "k_norm": norm(dh)},
               "mlp": {"w_gate": mat(d, f, fan_in=d),
                       "w_up": mat(d, f, fan_in=d),
                       "w_down": mat(f, d, fan_in=f)}}
              for _ in range(m["layers"])]
    head = {"embed": mat(V, d, fan_in=d / 1.28 ** 2),
            "final_norm": norm(d), "lm_head": mat(V, d, fan_in=d)}
    return layers, head


def test_qwen3_reference_matches_transformers():
    """The Qwen3 reference is Hugging Face's ``Qwen3ForCausalLM`` given
    the same weights; the same weights through the layer without the
    per-head q/k norms miss by more than the tolerance, so the
    comparison would catch their omission."""
    transformers = transformers_or_skip()
    m = QWEN3
    layers, head = qwen3_weights(m, 2**33 + 13)
    hf = transformers.Qwen3ForCausalLM(transformers.Qwen3Config(
        vocab_size=m["vocab"], hidden_size=m["d_model"],
        intermediate_size=m["d_ff"], num_hidden_layers=m["layers"],
        num_attention_heads=m["heads"], num_key_value_heads=m["kv_heads"],
        head_dim=m["head_dim"], rms_norm_eps=m["eps"],
        rope_theta=m["rope_theta"], max_position_embeddings=256,
        tie_word_embeddings=False, attention_bias=False,
        use_sliding_window=False, hidden_act="silu",
        attn_implementation="eager")).eval()
    d = m["d_model"]
    hf.model.embed_tokens.weight.data.copy_(head["embed"])
    hf.model.norm.weight.data.copy_(head["final_norm"])
    hf.lm_head.weight.data.copy_(head["lm_head"])
    for layer, w in zip(hf.model.layers, layers):
        a, f = w["attn"], w["mlp"]
        layer.input_layernorm.weight.data.copy_(w["ln1"])
        layer.post_attention_layernorm.weight.data.copy_(w["ln2"])
        layer.self_attn.q_proj.weight.data.copy_(a["wq"].reshape(d, -1).t())
        layer.self_attn.k_proj.weight.data.copy_(a["wk"].reshape(d, -1).t())
        layer.self_attn.v_proj.weight.data.copy_(a["wv"].reshape(d, -1).t())
        layer.self_attn.o_proj.weight.data.copy_(a["wo"].reshape(-1, d).t())
        layer.self_attn.q_norm.weight.data.copy_(a["q_norm"])
        layer.self_attn.k_norm.weight.data.copy_(a["k_norm"])
        layer.mlp.gate_proj.weight.data.copy_(f["w_gate"].t())
        layer.mlp.up_proj.weight.data.copy_(f["w_up"].t())
        layer.mlp.down_proj.weight.data.copy_(f["w_down"].t())
    assert hf.lm_head.weight.data_ptr() != \
        hf.model.embed_tokens.weight.data_ptr()
    tokens = torch.randint(0, m["vocab"], (41,),
                           generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = hf(tokens[None]).logits[0]

    def replay(ref):
        return ref_model.replay(ref, m, {"r": tokens}, {"r": list(range(41))},
                                lambda i: layers[i], lambda: head)["r"]

    tol = 1e-4 * want.abs().max()
    assert (replay(qwen3_ref) - want).abs().max() <= tol
    no_qk_norm = types.SimpleNamespace(layer=llama_ref.layer,
                                       logits=qwen3_ref.logits)
    assert (replay(no_qk_norm) - want).abs().max() > tol
