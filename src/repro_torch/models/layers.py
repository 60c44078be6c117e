"""Shared neural-net building blocks (port of ``repro.models.layers``).

Every function rounds to its input's type where the reference does: rmsnorm
and rope compute in f32 and cast back, each matrix product rounds to the
activation type.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def truncated_normal_(t: torch.Tensor, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with the reference's init rule
    (``layers.truncated_normal_init``): a standard normal truncated to
    [-2, 2] times ``scale / sqrt(fan_in)``, ``fan_in = shape[0]`` for a
    matrix and 1 for a vector.  The draw is in f32 on ``t``'s device and is
    then rounded to ``t``'s type."""
    stddev = scale / math.sqrt(t.shape[0] if t.ndim > 1 else 1.0)
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        t.copy_(draw.mul_(stddev))
    return t


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with cast back to the input type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x·Wg) * (x·Wu) · Wd."""
    dtype = x.dtype
    g = x @ w_gate.to(dtype)
    u = x @ w_up.to(dtype)
    return (F.silu(g) * u) @ w_down.to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate the two halves of the channels. ``x``: (..., S, head_dim);
    positions broadcast against (..., S).  Computed in f32, cast back."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
