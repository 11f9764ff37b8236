"""The harness side of ``model_type`` ``llama``: the Llama decoder with a
tied output table (``LlamaForCausalLM``), as SmolLM2 publishes it.

Two views of one draw.  ``draw_model`` gives the program's layout:
``ln1``, ``attn`` (wq (d, H, dh), wk/wv (d, H_kv, dh), wo (H, dh, d)),
``ln2``, ``mlp`` (w_gate/w_up (d, f), w_down (f, d)), the table and the
final norm, its norm scales ``s`` applied as (1 + s) with the program's
epsilon.  ``published_layer`` and ``published_head`` give the weights
of the source's model that the program then computes, in float32: each
norm weight g = 1 + s, and, where the program's epsilon differs from
the source's, the residual stream is c = ``residual_scale`` times the
source's in the program (table, wo and w_down drawn c times larger,
the final norm's g divided by c), since RMSNorm(c·x) with epsilon
c²·eps is RMSNorm(x) with eps; so the published view divides them by
c again.  The tied table meets the final norm's 1/c, so the logits
are the source's.
"""
from __future__ import annotations

import math

from harness import weights

#: leaves that write into the residual stream, drawn c times larger
RESIDUAL_OUT = (("attn", "wo"), ("mlp", "w_down"))


def dims(conf: dict) -> dict:
    """The sizes the harness, the reference and the FLOP counts use,
    from a configuration file's Hugging Face keys.  ``eps`` is the
    source's RMSNorm epsilon and ``program_eps`` the one the program
    applies; ``residual_scale`` is the factor c = sqrt(program_eps /
    eps) by which the program's residual stream is scaled so that its
    epsilon acts as the source's.  ``layer_params``: the weights of one
    layer that every token meets, the four attention projections and
    the three matrices of the SwiGLU MLP."""
    heads = int(conf["num_attention_heads"])
    eps = float(conf["rms_norm_eps"])
    program_eps = float(conf.get("program_layout", {}).get(
        "rms_norm_eps", eps))
    m = {
        "name": conf["name"],
        "model_type": conf["model_type"],
        "layers": int(conf["num_hidden_layers"]),
        "d_model": int(conf["hidden_size"]),
        "heads": heads,
        "kv_heads": int(conf["num_key_value_heads"]),
        "head_dim": int(conf.get("head_dim")
                        or int(conf["hidden_size"]) // heads),
        "d_ff": int(conf["intermediate_size"]),
        "vocab": int(conf["vocab_size"]),
        "padded_vocab": (int(conf["vocab_size"]) + 255) // 256 * 256,
        "rope_theta": float(conf["rope_theta"]),
        "eps": eps,
        "program_eps": program_eps,
        "residual_scale": math.sqrt(program_eps / eps),
        "dtype": conf["torch_dtype"],
    }
    d, H, G, dh, f = (m["d_model"], m["heads"], m["kv_heads"],
                      m["head_dim"], m["d_ff"])
    m["layer_params"] = d * (H + 2 * G) * dh + H * dh * d + 3.0 * d * f
    return m


def arch_config(conf: dict):
    """The program's ``ArchConfig`` for a configuration file."""
    from repro_torch.models.config import ArchConfig
    if not conf["tie_word_embeddings"] or conf.get("rope_scaling") \
            or conf.get("attention_bias") or conf.get("mlp_bias"):
        raise ValueError(f"{conf['name']}: the program computes Llama "
                         "layers with a tied table, no biases and plain "
                         "RoPE only")
    m = dims(conf)
    serve = conf["serve"]
    return ArchConfig(
        name=m["name"], family="dense",
        num_layers=m["layers"], d_model=m["d_model"],
        num_heads=m["heads"], num_kv_heads=m["kv_heads"],
        head_dim=m["head_dim"], d_ff=m["d_ff"], vocab_size=m["vocab"],
        max_seq_len=int(serve["max_seq"]), pattern=("global",),
        mlp_kind="swiglu", rope_theta=m["rope_theta"],
        tie_embeddings=True, dtype=conf["torch_dtype"],
        source=conf["source"])


def _shapes(m: dict) -> tuple[list, list]:
    """(served-dtype leaves, float32 leaves) of one layer: (path, shape,
    fan-in) in drawing order."""
    d, H, G, dh, f = (m["d_model"], m["heads"], m["kv_heads"],
                      m["head_dim"], m["d_ff"])
    low = [(("attn", "wq"), (d, H, dh), d), (("attn", "wk"), (d, G, dh), d),
           (("attn", "wv"), (d, G, dh), d), (("attn", "wo"), (H, dh, d), H * dh),
           (("mlp", "w_gate"), (d, f), d), (("mlp", "w_up"), (d, f), d),
           (("mlp", "w_down"), (f, d), f)]
    high = [(("ln1",), (d,), None), (("ln2",), (d,), None)]
    return low, high


def draw_layer(m: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s weights as the program's layer dict, the
    matrices in the served dtype."""
    return weights.draw_layer(m, seed, layer, _shapes(m), device,
                              RESIDUAL_OUT)


def draw_model(m: dict, seed: int, device) -> dict:
    """Every weight, as the program's ``Transformer`` takes them."""
    table, dev = weights.draw_table(m, seed, device)
    return {"embed": table,
            "final_norm": (1.0 + dev) / m["residual_scale"] - 1.0,
            "layers": [draw_layer(m, seed, i, device)
                       for i in range(m["layers"])]}


def published_layer(m: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer`` of the source's model, float32: ``ln1``/``ln2``
    the RMSNorm weights, ``attn`` and ``mlp`` as in the program's
    layout."""
    w = draw_layer(m, seed, layer, device)
    c = m["residual_scale"]
    out = {"ln1": 1.0 + w["ln1"], "ln2": 1.0 + w["ln2"],
           "attn": {k: v.float() for k, v in w["attn"].items()},
           "mlp": {k: v.float() for k, v in w["mlp"].items()}}
    for group, key in RESIDUAL_OUT:
        out[group][key] = out[group][key] / c
    return out


def published_head(m: dict, seed: int, device) -> dict:
    """The source's tied table over the true vocabulary (``embed``) and
    final RMSNorm weight (``final_norm``), float32."""
    table, dev = weights.draw_table(m, seed, device)
    return {"embed": table[:m["vocab"]].float() / m["residual_scale"],
            "final_norm": 1.0 + dev}
