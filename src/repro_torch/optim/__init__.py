"""Optimizer substrate (port of ``repro.optim``): AdamW, LR schedules,
global-norm clipping and int8 gradient compression with error feedback."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.compress import (
    compressed_psum_int8,
    dequantize_int8,
    error_feedback_compress,
    quantize_int8,
)
from repro_torch.optim.schedule import warmup_cosine, warmup_linear

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "warmup_cosine",
    "warmup_linear",
    "clip_by_global_norm",
    "quantize_int8",
    "dequantize_int8",
    "error_feedback_compress",
    "compressed_psum_int8",
]
