"""xlstm-1.3b — recurrent LM of alternating sLSTM + mLSTM blocks (copy of
``repro.configs.xlstm_1_3b``).

[arXiv:2405.04517] 48L d_model=2048 4H d_ff=0 vocab=50304 (blocks integrate
their own projections; no separate MLP).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    mlstm_proj_factor=2.0,
    notes="Recurrent state is O(1) per token — runs the long_500k cell.",
)

SMOKE_CONFIG = ArchConfig(
    name="xlstm-1.3b-smoke",
    family="ssm",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    block_pattern=("mlstm", "slstm"),
    mlstm_proj_factor=2.0,
)
