"""Plain oracles for the port's float kernels (port of ``repro.kernels.ref``).

Written as the reference writes them, apart from the twins they check: kv is
repeated per query head, and the mask is built inline.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_heads_per_kv: int = 1,
) -> torch.Tensor:
    """Oracle attention over (Hq, Sq, D) / (Hkv, Skv, D), f32 internals."""
    hq, sq, d = q.shape
    hkv, skv, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q_heads_per_kv > 1:
        k = torch.repeat_interleave(k, q_heads_per_kv, dim=0)
        v = torch.repeat_interleave(v, q_heads_per_kv, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float() * scale, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        offset = skv - sq
        mask &= k_pos <= q_pos + offset
        if window is not None:
            mask &= k_pos > q_pos + offset - window
    elif window is not None:
        mask &= torch.abs(k_pos - q_pos) < window
    s = torch.where(mask[None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows produce uniform garbage; zero them like the kernel.
    any_valid = mask.any(dim=1)[None, :, None]
    out = torch.einsum("hqk,hkd->hqd", p, v.float())
    return torch.where(any_valid, out, 0.0).to(q.dtype)
