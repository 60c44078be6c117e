"""Grouped-query attention with a KV cache and qk_norm (port of
``repro.models.attention``).

Two implementations behind ``cfg.attention_impl`` for prefill and training
passes (``S > 1``):

* ``flash`` — kernel 6 (``kernels/flash_attention.py``) over the flattened
  heads: the CUDA kernel on the card, its plain twin on the CPU.  The port's
  default (the reference's ``flash_pallas``).
* ``plain`` — the grouped masked einsum in f32 (the reference's ``xla``).

Decode (one token against the cache) is plain tensor code in both, as in
the reference.  The cache layout is ``(B, KV_heads, S_max, head_dim)``.
Unlike the reference, which returns a new cache, decode writes the new
token into the cache it is given, in place (the reference donates that
buffer), and returns the same tensors.

Ring caches (``swa``/``local``), cross-attention and ``encoder_kv`` belong
to later slices.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers

_NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, KV, S_max, hd)
    v: torch.Tensor  # (B, KV, S_max, hd)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Attention(nn.Module):
    """Projections of one attention block, in the reference's layout:
    ``wq`` (d, H·hd), ``wk``/``wv`` (d, KV·hd), ``wo`` (H·hd, d), so a
    projection is ``x @ w``; ``q_norm``/``k_norm`` (hd,) f32 with qk_norm."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim_
        self.wq = _param((d, cfg.num_heads * hd), dtype, device)
        self.wk = _param((d, cfg.num_kv_heads * hd), dtype, device)
        self.wv = _param((d, cfg.num_kv_heads * hd), dtype, device)
        self.wo = _param((cfg.num_heads * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), torch.float32, device)
            self.k_norm = _param((hd,), torch.float32, device)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig, positions):
    """x (B,S,d) → q (B,KV,G,S,hd), k/v (B,KV,S,hd) with qk_norm, then rope."""
    b, s, _ = x.shape
    hd, kv, g = cfg.head_dim_, cfg.num_kv_heads, cfg.q_per_kv
    dtype = x.dtype
    q = (x @ p.wq.to(dtype)).reshape(b, s, kv, g, hd)
    k = (x @ p.wk.to(dtype)).reshape(b, s, kv, hd)
    v = (x @ p.wv.to(dtype)).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p.q_norm)
        k = layers.rmsnorm(k, p.k_norm)
    if positions is not None:
        q = layers.apply_rope(q, positions[:, :, None, None], cfg.rope_theta)
        k = layers.apply_rope(k, positions[:, :, None], cfg.rope_theta)
    q = q.permute(0, 2, 3, 1, 4)  # (B, KV, G, S, hd)
    k = k.permute(0, 2, 1, 3)  # (B, KV, S, hd)
    v = v.permute(0, 2, 1, 3)
    return q, k, v


def _masked_attention(q, k, v, *, causal, window, q_offset, kv_len_mask=None):
    """Grouped einsum attention.  q (B,KV,G,Sq,hd), k/v (B,KV,Skv,hd).

    ``q_offset``: absolute position of q row 0 minus kv row 0.
    ``kv_len_mask``: optional (B, Skv) bool — live cache entries.
    """
    *_, sq, hd = q.shape
    skv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgsd,bktd->bkgst", q.float() * scale, k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
    elif window is not None:
        mask &= (k_pos - q_pos).abs() < window
    m = mask[None, None, None]
    if kv_len_mask is not None:
        m = m & kv_len_mask[:, None, None, None, :]
    s = torch.where(m, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.to(q.dtype)


def _flash_attention(q, k, v, *, causal, window):
    """Kernel 6 path. q (B,KV,G,S,hd), k/v (B,KV,S,hd), the views
    ``_project_qkv`` returns, go to the kernel as they are; it writes o into
    a (B, S, H, hd) buffer, returned as the merged (B, S, H·hd) view."""
    b, kvh, g, s, hd = q.shape
    o = torch.empty((b, s, kvh * g, hd), dtype=q.dtype, device=q.device)
    kops.flash_attention(q.reshape(b, kvh * g, s, hd), k, v, causal=causal, window=window,
                         out=o.permute(0, 2, 1, 3))
    return o.reshape(b, s, kvh * g * hd)


def _merge_heads(out):
    """(B, KV, G, S, hd) → (B, S, H·hd)."""
    b, kv, g, s, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, kv * g * hd)


def attention(
    p: Attention,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: Optional[torch.Tensor],
    *,
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[KVCache] = None,
    cache_pos: Optional[torch.Tensor] = None,
    return_cache: bool = False,
    cache_len: Optional[int] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention over ``x`` (B, S, d).

    Modes:
      * train:            cache=None, return_cache=False
      * prefill:          cache=None, return_cache=True (cache_len sizes it)
      * decode (S == 1):  cache=KVCache, cache_pos = absolute position (B,);
                          the new token is written into ``cache`` in place
    """
    b, s, _ = x.shape
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)

    if cache is not None:
        k_all, v_all = cache
        pos = cache_pos.reshape(b).to(torch.long)
        rows = torch.arange(b, device=x.device)
        k_all[rows, :, pos] = k_new[:, :, 0]
        v_all[rows, :, pos] = v_new[:, :, 0]
        kv_len_mask = torch.arange(k_all.shape[2], device=x.device)[None, :] <= pos[:, None]
        merged = _merge_heads(_masked_attention_decode(
            q, k_all, v_all, pos, window=window, kv_len_mask=kv_len_mask))
        new_cache = cache
    else:
        if cfg.attention_impl == "flash" and s > 1:
            merged = _flash_attention(q, k_new, v_new, causal=causal, window=window)
        else:
            merged = _merge_heads(_masked_attention(
                q, k_new, v_new, causal=causal, window=window, q_offset=0))
        new_cache = None
        if return_cache:
            smax = cache_len or s
            shape = (b, k_new.shape[1], smax, k_new.shape[3])
            k_c = torch.zeros(shape, dtype=k_new.dtype, device=x.device)
            v_c = torch.zeros(shape, dtype=v_new.dtype, device=x.device)
            k_c[:, :, :s] = k_new
            v_c[:, :, :s] = v_new
            new_cache = KVCache(k_c, v_c)

    return merged @ p.wo.to(x.dtype), new_cache


def _masked_attention_decode(q, k, v, pos, *, window, kv_len_mask):
    """Decode attention: q (B,KV,G,1,hd) vs the full cache (B,KV,Smax,hd)."""
    hd = q.shape[-1]
    skv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgsd,bktd->bkgst", q.float() * scale, k.float())
    k_pos = torch.arange(skv, device=q.device)[None, :]
    m = kv_len_mask  # (B, Smax): k_pos <= pos
    if window is not None:
        m = m & (k_pos > pos[:, None] - window)
    s = torch.where(m[:, None, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.to(q.dtype)
