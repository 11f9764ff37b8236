"""Unified architecture config covering all assigned families (a copy
of ``repro/models/config.py``, so both packages describe a model with
the same fields; the port's model stack runs every family it
describes).

One ``ArchConfig`` describes any of: dense GQA transformers (incl.
gemma2's alternating local/global attention with logit soft-capping),
MoE transformers (qwen3), xLSTM stacks (mLSTM/sLSTM), RG-LRU hybrids
(recurrentgemma), encoder-decoder (whisper) and VLM backbones
(internvl2, stub vision frontend).

The decoder stack is described by ``pattern``: a repeating tuple of
layer *kinds*, repeated over ``n_periods``; a non-divisible tail
(e.g. recurrentgemma's 26 = 8×3 + 2) follows as explicit layers.

Layer kinds:
  "global"  — full causal self-attention
  "local"   — sliding-window causal self-attention (window_size)
  "mlstm"   — xLSTM matrix-memory cell (chunked parallel / recurrent)
  "slstm"   — xLSTM scalar-memory cell (sequential scan)
  "rglru"   — Griffin RG-LRU recurrent block (associative scan)
Any kind can carry an MoE MLP (``num_experts > 0``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    max_seq_len: int = 32768

    # decoder layer pattern (repeats to cover num_layers)
    pattern: tuple[str, ...] = ("global",)
    window_size: int = 4096

    # gemma2-style soft-capping
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None

    mlp_kind: str = "swiglu"          # swiglu|geglu|gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    use_post_norm: bool = False       # gemma2 sandwich norms
    embed_scale: bool = False         # gemma-style √d embedding scale

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    norm_topk_prob: bool = True

    # xLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    mlstm_chunk: int = 256

    # RG-LRU (Griffin)
    rnn_width: int = 0                # 0 → d_model
    conv_width: int = 4

    # encoder-decoder (whisper): encoder is full-attention bidirectional
    encoder_layers: int = 0
    is_encoder_decoder: bool = False

    # VLM stub frontend: number of patch-embedding tokens prepended
    num_vision_tokens: int = 0

    dtype: str = "bfloat16"

    # citation / provenance tag from the assignment table
    source: str = ""

    # ---- derived ------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def n_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> tuple[str, ...]:
        tail = self.num_layers % len(self.pattern)
        return self.pattern[:tail]

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the TP axis divides the
        embedding table (internvl2's 92553, whisper's 51865)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def kv_bytes_per_token(self) -> float:
        """c = 2·L·H_kv·d_h·b over *attention* layers only (paper §3.1);
        recurrent layers contribute O(1) state, not per-token KV."""
        bytes_per = 2 if self.dtype == "bfloat16" else 4
        attn_layers = sum(
            1 for k in self._all_kinds() if k in ("global", "local"))
        return 2.0 * attn_layers * self.num_kv_heads * self.head_dim * bytes_per

    def _all_kinds(self) -> list[str]:
        kinds = list(self.pattern) * self.n_periods + list(self.tail_kinds)
        return kinds

    @property
    def supports_long_context(self) -> bool:
        """True iff per-token KV state is bounded (windowed/recurrent
        layers only) or half-bounded (gemma2: global layers sequence-
        shardable).  Pure full-attention stacks are excluded."""
        kinds = set(self._all_kinds())
        if kinds <= {"local", "mlstm", "slstm", "rglru"}:
            return True
        # gemma2: alternating local/global — global KV sequence-sharded
        return "local" in kinds and "global" in kinds

    def validate(self) -> None:
        assert self.num_layers >= 1
        assert self.d_model % 2 == 0
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, \
            "GQA requires H % H_kv == 0"
        if self.is_moe:
            assert self.experts_per_token <= self.num_experts
        if self.is_encoder_decoder:
            assert self.encoder_layers > 0

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=max(2, 2 * len(self.pattern) if len(self.pattern) > 1
                           else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=512,
            max_seq_len=128,
            window_size=min(self.window_size, 32),
            num_experts=min(self.num_experts, 8) if self.is_moe else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.is_moe else 0),
            rnn_width=0 if self.rnn_width == 0 else 64,
            encoder_layers=2 if self.is_encoder_decoder else 0,
            num_vision_tokens=(8 if self.num_vision_tokens else 0),
            mlstm_chunk=16,
            name=self.name + "-smoke",
        )
        # keep the layer pattern's *structure* (tail included) by
        # matching num_layers to pattern period + tail shape
        period = len(self.pattern)
        tail = self.num_layers % period
        small["num_layers"] = period * 2 + tail
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input shape sets (assigned): every LM arch × these four cells.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
