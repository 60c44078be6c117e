"""whisper-base — encoder-decoder audio model, conv frontend STUBBED (copy of
``repro.configs.whisper_base``).

[arXiv:2212.04356] 6L (enc) + 6L (dec) d_model=512 8H d_ff=2048 vocab=51865.
The conv frontend is a stub: the model takes
precomputed mel-frame embeddings (1500 frames after the conv stride).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    block_pattern=("attn",),
    is_encoder_decoder=True,
    encoder_layers=6,
    frontend="audio_stub",
    frontend_len=1500,
    notes="Encoder-decoder: decode shapes run (self-attn cache + cross-attn); "
    "long_500k skipped (full attention).",
)

SMOKE_CONFIG = ArchConfig(
    name="whisper-base-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    block_pattern=("attn",),
    is_encoder_decoder=True,
    encoder_layers=2,
    frontend="audio_stub",
    frontend_len=64,
)
