"""Prefill and decode steps for serving (port of ``repro.serve.engine``).

Plain functions: PyTorch runs eagerly, so there is no ``jit``.  The decode
step updates the caches it is given in place, as the reference's donated
buffers let XLA do.  ``ServeMesh`` and ``make_sharded_serve_step`` belong to
the multi-card slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.api import ModelBundle


def serving_compute_copy(params):
    """The parameters with every f32 matrix (ndim >= 2, the sLSTM's 4-D
    ``r`` included) as bf16, vectors (norms, the sLSTM bias) as they are.  Parameters already in bf16 are shared, not copied,
    so at full width (weights stored in bf16) this costs nothing."""
    state = params.state_dict()
    if not any(t.dtype == torch.float32 and t.ndim >= 2 for t in state.values()):
        return params
    copy = type(params)(params.cfg, dtype=torch.bfloat16, device="meta")
    copy.load_state_dict(
        {name: t.to(torch.bfloat16) if t.dtype == torch.float32 and t.ndim >= 2 else t
         for name, t in state.items()},
        assign=True,
    )
    return copy


def make_prefill_step(bundle: ModelBundle, cache_len: Optional[int] = None):
    """prefill: (params, batch dict) → (last-token logits, caches), run on
    the serving copy of the parameters."""

    def prefill(params, batch):
        return bundle.prefill(serving_compute_copy(params), batch, cache_len=cache_len)

    return prefill


def make_serve_step(bundle: ModelBundle):
    """Single-token decode: (params, caches, token, pos) → (logits, caches);
    the caches are updated in place."""

    def serve_step(params, caches, token, pos):
        return bundle.decode_step(params, caches, token, pos)

    return serve_step
