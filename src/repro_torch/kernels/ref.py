"""Plain oracles for the port's float kernels (port of ``repro.kernels.ref``).

Written as the reference writes them, apart from the twins they check: kv is
repeated per query head, and the mask is built inline; the sLSTM scan is a
loop over time.
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


def slstm_sequence_ref(pre, r, c0, n0, h0, m0):
    """Oracle for the sLSTM recurrence kernel (the reference's ``lax.scan``
    over time, as a loop).

    pre (B,H,S,4,hd) f32; r (H,4,hd,hd); state (B,H,hd) each.
    Returns (hs (B,H,S,hd), (c,n,h,m) finals).
    """
    carry = (c0, n0, h0, m0)
    hs = []
    for xt in pre.permute(2, 0, 1, 3, 4):  # xt: (B,H,4,hd)
        c, n, h, m = carry
        rec = torch.einsum("bhd,hgde->bhge", h, r.float())
        pre_t = xt + rec
        itil, ftil, ztil, otil = (pre_t[:, :, g] for g in range(4))
        m_new = torch.maximum(ftil + m, itil)
        i = torch.exp(itil - m_new)
        f = torch.exp(ftil + m - m_new)
        z = torch.tanh(ztil)
        o = torch.sigmoid(otil)
        c2 = f * c + i * z
        n2 = f * n + i
        h2 = o * c2 / torch.clamp(n2, min=1.0)
        carry = (c2, n2, h2, m_new)
        hs.append(h2)
    b, h, s, _, hd = pre.shape
    out = torch.stack(hs, 2) if hs else pre.new_empty((b, h, 0, hd))
    return out, carry
