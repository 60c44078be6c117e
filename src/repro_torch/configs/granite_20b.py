"""granite-20b — dense code LM, llama-arch, MQA (GQA kv=1) (copy of
``repro.configs.granite_20b``).

[arXiv:2405.04324; hf] 52L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=10_000.0,
    block_pattern=("attn",),
    notes="MQA (single kv head) — decode KV cache cannot head-shard; "
    "uses the sequence-sharded distributed-decode path.",
)

SMOKE_CONFIG = ArchConfig(
    name="granite-20b-smoke",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=8,
    num_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    head_dim=16,
    block_pattern=("attn",),
)
