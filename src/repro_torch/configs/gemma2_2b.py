"""gemma2-2b [dense] — local+global alternating, logit softcaps
[arXiv:2408.00118; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    max_seq_len=524288,
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
