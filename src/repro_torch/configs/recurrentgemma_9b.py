"""recurrentgemma-9b — Griffin hybrid: RG-LRU blocks + local attention, 2:1 (copy of
``repro.configs.recurrentgemma_9b``).

[arXiv:2402.19427] 38L d_model=4096 16H (kv=1) d_ff=12288, local window 2048.
The 38 layers are a period of 19 blocks applied twice: six (rglru, rglru,
local) triples and a trailing rglru, 13 recurrent and 6 local-attention
blocks a period (26 + 12 in all), the published 2:1 ratio at the exact layer
count.
"""
from repro_torch.configs.base import ArchConfig

_PERIOD = (
    "rglru", "rglru", "local",
    "rglru", "rglru", "local",
    "rglru", "rglru", "local",
    "rglru", "rglru", "local",
    "rglru", "rglru", "local",
    "rglru", "rglru", "local",
    "rglru",
)

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=_PERIOD,
    local_window=2048,
    rnn_width=4096,
    conv_width=4,
    notes="Local attention window 2048 + RG-LRU ⇒ O(window) decode state; "
    "runs long_500k. kv=1 local attention uses the seq-sharded decode path.",
)

SMOKE_CONFIG = ArchConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    block_pattern=("rglru", "rglru", "local"),
    local_window=32,
    rnn_width=128,
    conv_width=4,
)
