"""qwen3-14b — dense LM with qk_norm, GQA kv=8 (copy of ``repro.configs.qwen3_14b``).

[hf:Qwen/Qwen3-8B family; hf] 40L d_model=5120 40H (kv=8) d_ff=17408 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=("attn",),
)

SMOKE_CONFIG = ArchConfig(
    name="qwen3-14b-smoke",
    family="dense",
    num_layers=4,
    d_model=160,
    num_heads=10,
    num_kv_heads=2,
    d_ff=320,
    vocab_size=512,
    head_dim=16,
    qk_norm=True,
    block_pattern=("attn",),
)
