"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attention
per 2 recurrent blocks [arXiv:2402.19427; hf].  26 layers = 8 full
(rec, rec, attn) periods + a (rec, rec) tail."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,               # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    max_seq_len=524288,           # O(1)/windowed state → long_500k runs
    pattern=("rglru", "rglru", "local"),
    window_size=2048,
    rnn_width=2560,
    conv_width=4,
    mlp_kind="geglu",
    embed_scale=True,
    source="arXiv:2402.19427; hf",
)
