"""The plain reference against the published model as Hugging Face's
``LlamaForCausalLM`` computes it, against the program's own float32
forward on the weights the harness hands it, and over a served window,
on the CPU at a tiny size."""
import os

import pytest
import torch

import bench_tiny_cells as tiny
from bench_tiny_cells import one_thread  # noqa: F401 (an autouse fixture)
from harness import check, driver, spec, traffic
from harness import weights as weights_lib
from reference import model as ref_model

CONFIGS = {"gqa-scaled": tiny.DENSE, "mha": tiny.MHA}


def float32(conf):
    return dict(conf, torch_dtype="float32")


def reference(m, seed, tokens):
    n = tokens.numel()
    return ref_model.replay(
        m, {"r": tokens}, {"r": list(range(n))},
        lambda i: weights_lib.published_layer(m, seed, i, "cpu"),
        lambda: weights_lib.published_embed(m, seed, "cpu"))["r"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_matches_transformers(name):
    """The reference is the published Llama decoder: Hugging Face's
    implementation, given the published weights, gives its logits."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    conf = float32(CONFIGS[name])
    m = spec.model_dims(conf)
    seed = 2**33 + 9
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=m["vocab"], hidden_size=m["d_model"],
        intermediate_size=m["d_ff"], num_hidden_layers=m["layers"],
        num_attention_heads=m["heads"], num_key_value_heads=m["kv_heads"],
        head_dim=m["head_dim"], rms_norm_eps=m["eps"],
        rope_theta=m["rope_theta"], max_position_embeddings=256,
        tie_word_embeddings=True, attention_bias=False, mlp_bias=False,
        hidden_act="silu")).eval()
    table, final = weights_lib.published_embed(m, seed, "cpu")
    hf.model.embed_tokens.weight.data.copy_(table)
    hf.model.norm.weight.data.copy_(final)
    d = m["d_model"]
    for i, layer in enumerate(hf.model.layers):
        w = weights_lib.published_layer(m, seed, i, "cpu")
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
    m, cfg = spec.model_dims(conf), spec.arch_config(conf)
    seed = 2**33 + 5
    params = Transformer(cfg, weights_lib.draw_model(m, seed, "cpu"))
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
    m = spec.model_dims(conf)
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
    m, cfg = spec.model_dims(conf), spec.arch_config(conf)
    seed = 77
    eng, pool, keys = driver.build(cfg, weights_lib.draw_model(m, seed, "cpu"),
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
