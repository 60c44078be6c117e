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

Over a mesh (:class:`~repro_torch.models.layers.Layout`) the projections
are tensor-parallel: a rank computes its own query heads with their kv
heads (kernel 6 runs on them in prefill) and holds its kv heads of the
cache, or, where the kv heads do not divide over tp, ``cache_len / tp``
positions of every kv head; decode then combines each rank's partial
softmax by log-sum-exp (``_partial_attention_decode``,
``_combine_partials``), the combine GSPMD makes in the reference.

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


def _compute_heads(lay: layers.Layout, p: Attention, cfg: ArchConfig) -> tuple[int, int]:
    """The query heads ``[h0, h1)`` a rank computes: those of its tp block of
    ``wq`` when the block holds whole heads over whole kv groups, or part of
    one group; else every head."""
    hd, h, g = cfg.head_dim_, cfg.num_heads, cfg.q_per_kv
    lo, hi, n = lay.cols(p.wq)
    if (lo, hi) == (0, n) or lo % hd or hi % hd:
        return 0, h
    h0, h1 = lo // hd, hi // hd
    whole_groups = h0 % g == 0 and (h1 - h0) % g == 0
    in_one_group = g % (h1 - h0) == 0 and h0 // g == (h1 - 1) // g
    return (h0, h1) if whole_groups or in_one_group else (0, h)


def _kv_of(h0: int, h1: int, g: int) -> tuple[int, int, int]:
    """``(kv0, kv1, group)``: the kv heads of query heads [h0, h1) and the
    query heads a kv head serves among them."""
    if h0 % g == 0 and (h1 - h0) % g == 0:
        return h0 // g, h1 // g, g
    return h0 // g, h0 // g + 1, h1 - h0


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig, positions,
                 lay: layers.Layout = layers.SINGLE, heads=None, kv=None):
    """x (B,S,d) → q (B,KV',G',S,hd), k/v (B,KV'',S,hd) with qk_norm, then rope.

    ``heads`` = (h0, h1) are the query heads kept (grouped over their kv
    heads, ``_kv_of``) and ``kv`` = (kv0, kv1) the kv heads kept; default
    all.  A rank's column blocks of the products that do not hold them are
    gathered over tp in one call."""
    b, s, _ = x.shape
    hd, g = cfg.head_dim_, cfg.q_per_kv
    h0, h1 = heads or (0, cfg.num_heads)
    kv0, kv1 = kv or (0, cfg.num_kv_heads)
    dtype = x.dtype
    q, k, v = layers.take_cols(lay, [
        (x @ lay.w(p.wq).to(dtype), lay.cols(p.wq), (h0 * hd, h1 * hd)),
        (x @ lay.w(p.wk).to(dtype), lay.cols(p.wk), (kv0 * hd, kv1 * hd)),
        (x @ lay.w(p.wv).to(dtype), lay.cols(p.wv), (kv0 * hd, kv1 * hd)),
    ])
    qkv0, qkv1, qg = _kv_of(h0, h1, g)
    q = q.reshape(b, s, qkv1 - qkv0, qg, hd)
    k = k.reshape(b, s, kv1 - kv0, hd)
    v = v.reshape(b, s, kv1 - kv0, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p.q_norm)
        k = layers.rmsnorm(k, p.k_norm)
    if positions is not None:
        q = layers.apply_rope(q, positions[:, :, None, None], cfg.rope_theta)
        k = layers.apply_rope(k, positions[:, :, None], cfg.rope_theta)
    q = q.permute(0, 2, 3, 1, 4)  # (B, KV', G', S, hd)
    k = k.permute(0, 2, 1, 3)  # (B, KV'', S, hd)
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


def _cache_heads(lay: layers.Layout, cfg: ArchConfig, kv_layout: Optional[str]):
    """The kv heads ``[c0, c1)`` a rank's cache block holds."""
    kv = cfg.num_kv_heads
    if kv_layout != "heads":
        return 0, kv
    n = kv // lay.tp.size
    return lay.tp.index * n, (lay.tp.index + 1) * n


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
    lay: layers.Layout = layers.SINGLE,
    sp: bool = False,
    kv_layout: Optional[str] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention over ``x`` (B, S, d).

    Modes:
      * train:            cache=None, return_cache=False
      * prefill:          cache=None, return_cache=True (cache_len sizes it)
      * decode (S == 1):  cache=KVCache, cache_pos = absolute position (B,);
                          the new token is written into ``cache`` in place

    Over a mesh (``lay``): ``wq``/``wk``/``wv`` are column-parallel over
    heads and ``wo`` row-parallel; ``x`` arrives sequence-sharded under
    ``sp`` and is gathered first, and the output leaves as the rank's
    sequence block.  ``kv_layout`` is the cache's tp layout: ``"heads"``
    (a rank holds its kv heads), ``"seq"`` (a rank holds ``cache_len / tp``
    positions of every kv head; decode combines partial softmaxes across tp)
    or None (whole).
    """
    if sp:
        x = lay.tp.all_gather(x, 1)
    b, s, _ = x.shape
    hd, g = cfg.head_dim_, cfg.q_per_kv
    seq_cache = kv_layout == "seq"
    decode = cache is not None
    h0, h1 = (0, cfg.num_heads) if decode and seq_cache else _compute_heads(lay, p, cfg)
    kv0, kv1, _ = _kv_of(h0, h1, g)
    c0, c1 = _cache_heads(lay, cfg, kv_layout)
    n0, n1 = (min(kv0, c0), max(kv1, c1)) if decode or return_cache else (kv0, kv1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, lay, (h0, h1), (n0, n1))
    k_att, v_att = k_new[:, kv0 - n0:kv1 - n0], v_new[:, kv0 - n0:kv1 - n0]

    if decode:
        k_all, v_all = cache
        pos = cache_pos.reshape(b).to(torch.long)
        rows = torch.arange(b, device=x.device)
        k_put, v_put = k_new[:, c0 - n0:c1 - n0, 0], v_new[:, c0 - n0:c1 - n0, 0]
        if seq_cache:
            span = k_all.shape[2]
            offset = lay.tp.index * span
            local = pos - offset
            mine = (local >= 0) & (local < span)
            k_all[rows[mine], :, local[mine]] = k_put[mine]
            v_all[rows[mine], :, local[mine]] = v_put[mine]
            merged = _merge_heads(_combine_partials(lay, *_partial_attention_decode(
                q, k_all, v_all, pos, window=window, offset=offset)).to(q.dtype))
        else:
            k_all[rows, :, pos] = k_put
            v_all[rows, :, pos] = v_put
            kv_len_mask = torch.arange(k_all.shape[2], device=x.device)[None, :] <= pos[:, None]
            merged = _merge_heads(_masked_attention_decode(
                q, k_all[:, kv0 - c0:kv1 - c0], v_all[:, kv0 - c0:kv1 - c0], pos,
                window=window, kv_len_mask=kv_len_mask))
        new_cache = cache
    else:
        if cfg.attention_impl == "flash" and s > 1:
            merged = _flash_attention(q, k_att, v_att, causal=causal, window=window)
        else:
            merged = _merge_heads(_masked_attention(
                q, k_att, v_att, causal=causal, window=window, q_offset=0))
        new_cache = None
        if return_cache:
            smax = cache_len or s
            k_c, v_c = k_new[:, c0 - n0:c1 - n0], v_new[:, c0 - n0:c1 - n0]
            span, offset = smax, 0
            if seq_cache:
                span = smax // lay.tp.size
                offset = lay.tp.index * span
            shape = (b, c1 - c0, span, hd)
            k_cache = torch.zeros(shape, dtype=k_new.dtype, device=x.device)
            v_cache = torch.zeros(shape, dtype=v_new.dtype, device=x.device)
            n = max(0, min(s - offset, span))
            k_cache[:, :, :n] = k_c[:, :, offset:offset + n]
            v_cache[:, :, :n] = v_c[:, :, offset:offset + n]
            new_cache = KVCache(k_cache, v_cache)

    r0, r1, _ = lay.rows(p.wo)
    partial = (r0, r1) != (0, cfg.num_heads * hd)
    (merged,) = layers.take_cols(lay, [(merged, (h0 * hd, h1 * hd, cfg.num_heads * hd), (r0, r1))])
    out = merged @ lay.w(p.wo).to(x.dtype)
    return layers.reduce_rows(lay, out, partial, sp), new_cache


def _partial_attention_decode(q, k, v, pos, *, window, offset: int):
    """One rank's part of decode attention over a sequence-sharded cache:
    q (B,KV,G,1,hd) against its positions [offset, offset + S) of k/v
    (B,KV,S,hd).  Returns f32 (m, l, o): each query row's max over its live
    scores, the sum of exp(score - m) and the unnormalised output (a rank
    with no live position gives m = -1e30, l = 0, o = 0)."""
    hd = q.shape[-1]
    skv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgsd,bktd->bkgst", q.float() * scale, k.float())
    k_pos = offset + torch.arange(skv, device=q.device)[None, :]
    live = k_pos <= pos[:, None]
    if window is not None:
        live = live & (k_pos > pos[:, None] - window)
    live = live[:, None, None, None, :]
    s = torch.where(live, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    return m, p.sum(dim=-1, keepdim=True), torch.einsum("bkgst,bktd->bkgsd", p, v.float())


def _combine_partials(lay: layers.Layout, m, l, o) -> torch.Tensor:
    """The flash-decode combine: every rank's (m, l, o) in one all-gather
    over tp, then log-sum-exp weights summed in rank order (the same bits on
    every rank); f32."""
    packed = torch.cat([m, l, o], dim=-1)
    every = lay.tp.all_gather(packed[None], 0)
    ms, ls, os_ = every[..., :1], every[..., 1:2], every[..., 2:]
    top = ms.amax(dim=0)
    w = torch.exp(ms - top)
    num = (w * os_).sum(dim=0)
    den = (w * ls).sum(dim=0)
    return num / den


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
