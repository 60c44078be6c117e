"""mixtral-8x22b — MoE LM, 8 experts top-2, sliding-window attention (copy of ``repro.configs.mixtral_8x22b``).

[arXiv:2401.04088; hf] 56L d_model=6144 48H (kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    block_pattern=("swa",),
    sliding_window=4096,
    num_experts=8,
    experts_per_token=2,
    moe_capacity_factor=1.25,
)

SMOKE_CONFIG = ArchConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    num_layers=4,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    block_pattern=("swa",),
    sliding_window=32,
    num_experts=4,
    experts_per_token=2,
    moe_capacity_factor=2.0,
)
