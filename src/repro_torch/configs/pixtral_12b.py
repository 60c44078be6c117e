"""pixtral-12b — VLM: pixtral-ViT frontend (STUB) + mistral-nemo backbone (copy of
``repro.configs.pixtral_12b``).

[hf:mistralai/Pixtral-12B-2409] 40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072.
The vision frontend is a stub: the model takes
precomputed patch embeddings that are prepended to the token sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1_000_000.0,
    block_pattern=("attn",),
    frontend="patch_stub",
    frontend_len=256,  # precomputed patch embeddings per sample
)

SMOKE_CONFIG = ArchConfig(
    name="pixtral-12b-smoke",
    family="vlm",
    num_layers=4,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    block_pattern=("attn",),
    frontend="patch_stub",
    frontend_len=16,
)
