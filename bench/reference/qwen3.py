"""The plain float32 Qwen3 decoder layer and its logits, as Hugging
Face's ``Qwen3ForCausalLM`` computes them (Qwen3-8B's architecture):
the Llama layer (``reference/llama.py``) with an RMSNorm over each head
of q and of k, over dh with weights ``q_norm`` and ``k_norm`` and the
source's eps, after the projections and before RoPE; and the logits
against an output matrix of their own (``lm_head``, untied from the
table), over the true vocabulary.  No biases (``attention_bias`` false),
no embedding scale, no soft-capping.

Departures from Hugging Face's model, none of which changes the
function it computes: float32 throughout, where the published model
runs in bfloat16; no sliding window, which Qwen3-8B's configuration
leaves off (``use_sliding_window`` false), and no RoPE scaling, which it
leaves null; every sequence at once by teacher forcing, with no KV
cache (``reference.model.replay``); logits only at the judged rows;
and, for the control, a lower precision of every matrix product.

Weights (the published view an ``archs/qwen3.py`` hands over):
``ln1``, ``ln2`` (d,); ``attn``: wq (d, H, dh), wk/wv (d, G, dh),
wo (H, dh, d), q_norm/k_norm (dh,); ``mlp``: w_gate/w_up (d, f),
w_down (f, d); the head's ``embed`` (vocab, d), ``final_norm`` (d,)
and ``lm_head`` (vocab, d).
"""
from __future__ import annotations

import torch

from reference.model import attend, mlp, rmsnorm


def layer(x: torch.Tensor, w: dict, m: dict, mm, segments: list
          ) -> torch.Tensor:
    a = w["attn"]
    H, G, dh, d = m["heads"], m["kv_heads"], m["head_dim"], m["d_model"]
    eps = m["eps"]
    h = rmsnorm(x, w["ln1"], eps)
    q = rmsnorm(mm(h, a["wq"].reshape(d, -1)).view(-1, H, dh),
                a["q_norm"], eps)
    k = rmsnorm(mm(h, a["wk"].reshape(d, -1)).view(-1, G, dh),
                a["k_norm"], eps)
    v = mm(h, a["wv"].reshape(d, -1)).view(-1, G, dh)
    del h
    o = attend(q, k, v, m["rope_theta"], mm, segments)
    del q, k, v
    x = x + mm(o, a["wo"].reshape(H * dh, -1))
    del o
    return x + mlp(rmsnorm(x, w["ln2"], eps), w["mlp"], mm)


def logits(rows: torch.Tensor, head: dict, m: dict, mm) -> torch.Tensor:
    return mm(rmsnorm(rows, head["final_norm"], m["eps"]),
              head["lm_head"].t())
