"""qwen3-8b [dense] — the PAPER'S OWN serving model
(nvidia/Qwen3-8B-NVFP4 in §5.1; bf16 here, as in the JAX package).
The serve path's default architecture."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    max_seq_len=32768,
    pattern=("global",),
    mlp_kind="swiglu",
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B (paper §5.1)",
)
