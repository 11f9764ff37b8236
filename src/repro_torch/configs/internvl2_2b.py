"""internvl2-2b [vlm] — InternViT + InternLM2 backbone
[arXiv:2404.16821; hf].  The vision frontend is a STUB per the
assignment: ``input_specs()`` supplies precomputed patch embeddings
(256 tokens for one 448² tile), projected into the LM width."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,             # padded to 92672 for the TP axis
    max_seq_len=32768,
    pattern=("global",),
    mlp_kind="swiglu",
    num_vision_tokens=256,
    source="arXiv:2404.16821; hf",
)
