"""whisper-small [audio] — enc-dec, conv frontend STUB
[arXiv:2212.04356; unverified].  12 encoder + 12 decoder layers;
``input_specs()`` supplies precomputed frame embeddings."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,                # decoder layers
    encoder_layers=12,
    is_encoder_decoder=True,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,             # padded to 52224 for the TP axis
    max_seq_len=32768,
    pattern=("global",),
    mlp_kind="gelu",
    source="arXiv:2212.04356; unverified",
)
