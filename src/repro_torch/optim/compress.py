"""Int8 gradient compression with error feedback (port of
``repro.optim.compress``, its single-device part).

``error_feedback_compress`` quantizes ``grad + error`` per leaf to int8 with
one f32 scale and carries the residual into the next step, which keeps
Adam's gradient stream unbiased in expectation; the state rides in the
optimizer state (``opt_state["ef_error"]``).  The int8 all-reduce over a
data-parallel group (``compressed_psum_int8``) belongs to the slice that
trains over a mesh.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.parallel import TRAIN_MESH_SLICE
from repro_torch.utils import named_leaves


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns ``(q, scale)``."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def error_feedback_compress(grads: dict, error: dict) -> tuple[dict, dict]:
    """Quantize ``grads + error`` per leaf.  Returns ``(dequantized in the
    gradients' types, new error in the error's types)``, dicts by name."""
    deq, err = {}, {}
    for name, g in named_leaves(grads).items():
        e = error[name]
        gf = g.float() + e.float()
        d = dequantize_int8(*quantize_int8(gf))
        deq[name] = d.to(g.dtype)
        err[name] = (gf - d).to(e.dtype)
    return deq, err


def compressed_psum_int8(x: torch.Tensor, axis_names) -> torch.Tensor:
    """The int8 two-hop mean all-reduce over data-parallel ranks: not ported
    yet."""
    raise NotImplementedError(
        f"compressed_psum_int8 (the int8 all-reduce over dp) belongs to {TRAIN_MESH_SLICE}"
    )
