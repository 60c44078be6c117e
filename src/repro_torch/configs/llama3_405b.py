"""llama3-405b — dense frontier LM, GQA kv=8, 128k vocab (copy of
``repro.configs.llama3_405b``).

[arXiv:2407.21783] 126L d_model=16384 128H (kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    block_pattern=("attn",),
)

SMOKE_CONFIG = ArchConfig(
    name="llama3-405b-smoke",
    family="dense",
    num_layers=6,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=768,
    vocab_size=512,
    head_dim=32,
    rope_theta=500_000.0,
    block_pattern=("attn",),
)
