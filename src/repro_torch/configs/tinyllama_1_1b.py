"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    max_seq_len=32768,
    pattern=("global",),
    mlp_kind="swiglu",
    source="arXiv:2401.02385; hf",
)
