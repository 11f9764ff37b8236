"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517;
unverified].  We alternate mLSTM/sLSTM 1:1 (the 350M point in the
paper's family; block ratio is a free parameter there — recorded in
DESIGN.md as an assumption for this unverified-tier config)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,                       # cells carry their own projections
    vocab_size=50304,
    max_seq_len=524288,           # O(1) state → long_500k runs
    pattern=("mlstm", "slstm"),
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    source="arXiv:2405.04517; unverified",
)
