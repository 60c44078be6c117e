"""grok-1-314b — MoE LM, 8 experts top-2, GQA kv=8 (copy of ``repro.configs.grok_1_314b``).

[hf:xai-org/grok-1] 64L d_model=6144 48H (kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    block_pattern=("attn",),
    num_experts=8,
    experts_per_token=2,
    moe_capacity_factor=1.25,
    notes="MoE dispatch reuses the paper's binned capacity all-to-all "
    "(repro.core.exchange) for expert parallelism.",
)

SMOKE_CONFIG = ArchConfig(
    name="grok-1-314b-smoke",
    family="moe",
    num_layers=4,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    block_pattern=("attn",),
    num_experts=4,
    experts_per_token=2,
    moe_capacity_factor=2.0,
)
