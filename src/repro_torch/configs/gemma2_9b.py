"""gemma2-9b [dense] — local+global alternating attention, logit
softcaps [arXiv:2408.00118; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    max_seq_len=524288,          # long_500k cell (global KV seq-sharded)
    pattern=("local", "global"),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_kind="geglu",
    use_post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
)
