"""qwen3-4b — dense LM with qk_norm and GQA kv=8 (copy of ``repro.configs.qwen3_4b``).

[hf:Qwen/Qwen3-8B family; hf] 36L d_model=2560 32H (kv=8) d_ff=9728 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,  # decoupled from d_model (HF config)
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=("attn",),
    tie_embeddings=True,
)

SMOKE_CONFIG = ArchConfig(
    name="qwen3-4b-smoke",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    qk_norm=True,
    tie_embeddings=True,
    block_pattern=("attn",),
)
