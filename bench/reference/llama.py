"""The plain float32 Llama decoder layer and its tied logits, as Hugging
Face's ``LlamaForCausalLM`` computes them (SmolLM2-1.7B's
architecture): per layer x += attn(rmsnorm(x)) and x += mlp(rmsnorm(x)),
RMSNorm as x / sqrt(mean(x^2) + eps) * g with the source's eps;
attention with RoPE (rotate-half, theta from the configuration), grouped
or full key/value heads, a 1/sqrt(dh) scale and a causal mask; a SwiGLU
MLP (down(silu(gate(x)) * up(x))); the final RMSNorm and the logits
against the tied embedding table, over the true vocabulary.  No biases,
no embedding scale, no soft-capping.

Weights (``archs/llama.py``'s published view): ``ln1``, ``ln2`` (d,);
``attn``: wq (d, H, dh), wk/wv (d, G, dh), wo (H, dh, d); ``mlp``:
w_gate/w_up (d, f), w_down (f, d); the head's ``embed`` (vocab, d) and
``final_norm`` (d,).
"""
from __future__ import annotations

import torch

from reference.model import attend, mlp, rmsnorm


def layer(x: torch.Tensor, w: dict, m: dict, mm, segments: list
          ) -> torch.Tensor:
    a = w["attn"]
    H, G, dh, d = m["heads"], m["kv_heads"], m["head_dim"], m["d_model"]
    h = rmsnorm(x, w["ln1"], m["eps"])
    q = mm(h, a["wq"].reshape(d, -1))
    kv = mm(h, torch.cat([a["wk"].reshape(d, -1),
                          a["wv"].reshape(d, -1)], 1))
    del h
    o = attend(q.view(-1, H, dh), kv[:, :G * dh].view(-1, G, dh),
               kv[:, G * dh:].view(-1, G, dh), m["rope_theta"], mm, segments)
    del q, kv
    x = x + mm(o, a["wo"].reshape(H * dh, -1))
    del o
    return x + mlp(rmsnorm(x, w["ln2"], m["eps"]), w["mlp"], mm)


def logits(rows: torch.Tensor, head: dict, m: dict, mm) -> torch.Tensor:
    return mm(rmsnorm(rows, head["final_norm"], m["eps"]), head["embed"].t())
