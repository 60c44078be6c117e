"""Serving layer of the port: prefill/decode steps and a continuous batcher."""
from repro_torch.serve.batcher import ContinuousBatcher, Request
from repro_torch.serve.engine import (
    ServeMesh,
    make_prefill_step,
    make_serve_step,
    make_sharded_serve_step,
    serving_compute_copy,
)

__all__ = [
    "ContinuousBatcher",
    "Request",
    "ServeMesh",
    "make_prefill_step",
    "make_serve_step",
    "make_sharded_serve_step",
    "serving_compute_copy",
]
