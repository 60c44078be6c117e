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

Windowed blocks (``swa``, ``local``) keep a :class:`RingKVCache` of ``W = min(window,
cache_len)`` positions: prefill runs kernel 6 with the window and cuts the
last ``W`` positions into the ring (:func:`ring_prefill_cache`), decode
writes the new token at ``pos % window`` and attends over the positions its
``kpos`` marks live (:func:`ring_decode_attention`), in place.  Where the
reference's ``dynamic_update_slice`` clamps a slot past the ring's end (a
ring shorter than the window, only past ``cache_len``), the port clamps
too.  ``local`` blocks (recurrentgemma) take the same ring with their
window.  :func:`cross_attention` (whisper's decoder over :func:`encoder_kv`)
is the plain einsum, as the reference's (it never runs its Pallas kernel
there).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as kflash
from repro_torch.models import layers

_NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, KV, S_max, hd)
    v: torch.Tensor  # (B, KV, S_max, hd)


class RingKVCache(NamedTuple):
    """Fixed-window ring buffer for windowed decode: O(window) instead of
    O(seq_len)."""

    k: torch.Tensor  # (B, KV, W, hd)
    v: torch.Tensor  # (B, KV, W, hd)
    kpos: torch.Tensor  # (B, W) int32 absolute positions, -1 = empty


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
                 lay: layers.Layout = layers.SINGLE, heads=None, kv=None, partial: bool = False):
    """x (B,S,d) → q (B,KV',G',S,hd), k/v (B,KV'',S,hd) with qk_norm, then rope.

    ``heads`` = (h0, h1) are the query heads kept (grouped over their kv
    heads, ``_kv_of``) and ``kv`` = (kv0, kv1) the kv heads kept; default
    all.  A rank's column blocks of the products that do not hold them are
    gathered over tp in one call.  ``partial``: the attention's output is a
    partial sum over tp, so the qk norms act on each rank's own part (their
    gradients are summed over tp)."""
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
        q = layers.rmsnorm(q, lay.tp_shared(p.q_norm, partial))
        k = layers.rmsnorm(k, lay.tp_shared(p.k_norm, partial))
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
    a (B, S, H, hd) buffer, returned as the merged (B, S, H·hd) view.  Under
    autograd the backward is the plain twin's (``kflash.FlashAttention``)."""
    b, kvh, g, s, hd = q.shape
    o = kflash.FlashAttention.apply(q.reshape(b, kvh * g, s, hd), k, v, causal, window, None, g)
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
    ring: Optional[int] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention over ``x`` (B, S, d).

    Modes:
      * train:            cache=None, return_cache=False
      * prefill:          cache=None, return_cache=True (cache_len sizes it)
      * decode (S == 1):  cache=KVCache, cache_pos = absolute position (B,);
                          the new token is written into ``cache`` in place

    Windowed blocks: ``ring`` (prefill) returns a :class:`RingKVCache` of
    that width instead of a KVCache; decode against a RingKVCache writes at
    ``pos % window`` and masks by its ``kpos``.

    Over a mesh (``lay``): ``wq``/``wk``/``wv`` are column-parallel over
    heads and ``wo`` row-parallel; ``x`` arrives sequence-sharded under
    ``sp`` and is gathered first, and the output leaves as the rank's
    sequence block.  ``kv_layout`` is the cache's tp layout: ``"heads"``
    (a rank holds its kv heads), ``"seq"`` (a rank holds ``cache_len / tp``
    positions of every kv head; decode combines partial softmaxes across tp)
    or None (whole).
    """
    r0, r1, _ = lay.rows(p.wo)
    partial = (r0, r1) != (0, cfg.num_heads * cfg.head_dim_)
    x = lay.tp_input(x, sp, partial)
    b, s, _ = x.shape
    hd, g = cfg.head_dim_, cfg.q_per_kv
    seq_cache = kv_layout == "seq"
    decode = cache is not None
    h0, h1 = (0, cfg.num_heads) if decode and seq_cache else _compute_heads(lay, p, cfg)
    kv0, kv1, _ = _kv_of(h0, h1, g)
    c0, c1 = _cache_heads(lay, cfg, kv_layout)
    n0, n1 = (min(kv0, c0), max(kv1, c1)) if decode or return_cache else (kv0, kv1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, lay, (h0, h1), (n0, n1), partial)
    k_att, v_att = k_new[:, kv0 - n0:kv1 - n0], v_new[:, kv0 - n0:kv1 - n0]

    if decode:
        k_all, v_all = cache.k, cache.v
        kpos = cache.kpos if isinstance(cache, RingKVCache) else None
        pos = cache_pos.reshape(b).to(torch.long)
        rows = torch.arange(b, device=x.device)
        k_put, v_put = k_new[:, c0 - n0:c1 - n0, 0], v_new[:, c0 - n0:c1 - n0, 0]
        span = k_all.shape[2]
        at = pos
        if kpos is not None:  # the ring's slot, clamped to its end as the reference's update
            at = (pos % window).clamp(max=span * (lay.tp.size if seq_cache else 1) - 1)
        if seq_cache:
            offset = lay.tp.index * span
            local = at - offset
            if k_all.is_meta:  # traced (the dry run): every row's write, an upper bound
                mine = slice(None)
                local = local.clamp(0, span - 1)
            else:
                mine = (local >= 0) & (local < span)
            k_all[rows[mine], :, local[mine]] = k_put[mine]
            v_all[rows[mine], :, local[mine]] = v_put[mine]
            if kpos is not None:
                kpos[rows[mine], local[mine]] = pos[mine].to(kpos.dtype)
            merged = _merge_heads(_combine_partials(lay, *_partial_attention_decode(
                q, k_all, v_all, pos, window=window, offset=offset, kpos=kpos)).to(q.dtype))
        else:
            k_all[rows, :, at] = k_put
            v_all[rows, :, at] = v_put
            if kpos is not None:
                kpos[rows, at] = pos.to(kpos.dtype)
                live, win = ring_live(kpos, pos, window), None
            else:
                live, win = torch.arange(span, device=x.device)[None, :] <= pos[:, None], window
            merged = _merge_heads(_masked_attention_decode(
                q, k_all[:, kv0 - c0:kv1 - c0], v_all[:, kv0 - c0:kv1 - c0], pos,
                window=win, kv_len_mask=live))
        new_cache = cache
    else:
        if cfg.attention_impl == "flash" and s > 1:
            merged = _flash_attention(q, k_att, v_att, causal=causal, window=window)
        else:
            merged = _merge_heads(_masked_attention(
                q, k_att, v_att, causal=causal, window=window, q_offset=0))
        new_cache = None
        if return_cache and ring is not None:
            whole = ring_prefill_cache(k_new[:, c0 - n0:c1 - n0], v_new[:, c0 - n0:c1 - n0],
                                       s, ring)
            new_cache = whole
            if seq_cache:  # the rank's span of the ring's slots
                span = ring // lay.tp.size
                cut = slice(lay.tp.index * span, (lay.tp.index + 1) * span)
                new_cache = RingKVCache(whole.k[:, :, cut].contiguous(),
                                        whole.v[:, :, cut].contiguous(),
                                        whole.kpos[:, cut].contiguous())
        elif return_cache:
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

    (merged,) = layers.take_cols(lay, [(merged, (h0 * hd, h1 * hd, cfg.num_heads * hd), (r0, r1))])
    out = merged @ lay.w(p.wo).to(x.dtype)
    return layers.reduce_rows(lay, out, partial, sp), new_cache


def _partial_attention_decode(q, k, v, pos, *, window, offset: int, kpos=None):
    """One rank's part of decode attention over a sequence-sharded cache:
    q (B,KV,G,1,hd) against its positions [offset, offset + S) of k/v
    (B,KV,S,hd), or, for a ring, the positions its slots' ``kpos`` (B, S)
    hold.  Returns f32 (m, l, o): each query row's max over its live
    scores, the sum of exp(score - m) and the unnormalised output (a rank
    with no live position gives m = -1e30, l = 0, o = 0)."""
    hd = q.shape[-1]
    skv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgsd,bktd->bkgst", q.float() * scale, k.float())
    if kpos is not None:
        live = ring_live(kpos, pos, window)
    else:
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


def ring_live(kpos: torch.Tensor, pos: torch.Tensor, window: int) -> torch.Tensor:
    """(B, W) bool: the ring slots a query at ``pos`` (B,) attends to —
    filled, not after it and inside its window."""
    p = pos[:, None]
    return (kpos >= 0) & (kpos <= p) & (kpos > p - window)


def ring_prefill_cache(k: torch.Tensor, v: torch.Tensor, seq_len: int, window: int) -> RingKVCache:
    """A ring of ``window`` slots from a prefill's k/v (B, KV, S, hd): the
    last ``window`` positions at ``pos % window`` (all of them, from slot
    0, when the prompt is shorter), the other slots zero with ``kpos`` -1."""
    b, kvh, _, hd = k.shape
    w = window
    rk = torch.zeros((b, kvh, w, hd), dtype=k.dtype, device=k.device)
    rv = torch.zeros_like(rk)
    kpos = torch.full((b, w), -1, dtype=torch.int32, device=k.device)
    if seq_len >= w:
        pos = torch.arange(seq_len - w, seq_len, device=k.device)
        slots = pos % w
        rk[:, :, slots] = k[:, :, seq_len - w:seq_len]
        rv[:, :, slots] = v[:, :, seq_len - w:seq_len]
        kpos[:, slots] = pos.to(torch.int32)
    else:
        rk[:, :, :seq_len] = k[:, :, :seq_len]
        rv[:, :, :seq_len] = v[:, :, :seq_len]
        kpos[:, :seq_len] = torch.arange(seq_len, dtype=torch.int32, device=k.device)
    return RingKVCache(rk, rv, kpos)


def _partial_softmax(q, k, v):
    """One rank's unmasked part of attention over its block of keys: q
    (B,KV,G,S,hd) against k/v (B,KV,T',hd).  Returns f32 (m, l, o) as
    :func:`_partial_attention_decode` does, for :func:`_combine_partials`."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bkgsd,bktd->bkgst", q.float() * scale, k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return m, p.sum(dim=-1, keepdim=True), torch.einsum("bkgst,bktd->bkgsd", p, v.float())


def cross_attention(p: Attention, x: torch.Tensor, cfg: ArchConfig, enc_k: torch.Tensor,
                    enc_v: torch.Tensor, lay: layers.Layout = layers.SINGLE,
                    kv_heads: Optional[tuple] = None, frames_split: bool = False) -> torch.Tensor:
    """Cross-attention (whisper's decoder) of x (B, S, d) over the encoder's
    precomputed k/v (B, KV', T_enc, hd) of kv heads ``kv_heads = (c0, c1)``
    (default all): no rope, no mask, the grouped masked einsum in f32 as
    the reference computes it (never its Pallas kernel).  Over a mesh
    ``wq`` is column- and ``wo`` row-parallel, a rank on its own heads, as
    in :func:`attention`.

    ``frames_split``: ``enc_k``/``enc_v`` hold every kv head but only the
    rank's tp block of the frames (a cross cache split by frames, where the
    kv heads do not divide over tp): every rank takes every query head (its
    column block of ``wq`` gathered over tp), attends over its frames, and
    the partial softmaxes are combined over tp by log-sum-exp in rank order
    (:func:`_combine_partials`, as a decode step over a sequence-split self
    cache), the same bits on every rank."""
    r0, r1, _ = lay.rows(p.wo)
    partial = (r0, r1) != (0, cfg.num_heads * cfg.head_dim_)
    x = lay.tp_input(x, False, partial)
    b, s, _ = x.shape
    hd, g = cfg.head_dim_, cfg.q_per_kv
    dtype = x.dtype
    h0, h1 = (0, cfg.num_heads) if frames_split else _compute_heads(lay, p, cfg)
    kv0, kv1, qg = _kv_of(h0, h1, g)
    c0 = kv_heads[0] if kv_heads is not None else 0
    (q,) = layers.take_cols(lay, [(x @ lay.w(p.wq).to(dtype), lay.cols(p.wq),
                                   (h0 * hd, h1 * hd))])
    q = q.reshape(b, s, kv1 - kv0, qg, hd).permute(0, 2, 3, 1, 4)
    ek, ev = enc_k[:, kv0 - c0:kv1 - c0], enc_v[:, kv0 - c0:kv1 - c0]
    if frames_split:
        out = _combine_partials(lay, *_partial_softmax(q, ek, ev)).to(dtype)
    else:
        out = _masked_attention(q, ek, ev, causal=False, window=None, q_offset=0)
    (merged,) = layers.take_cols(lay, [(_merge_heads(out), (h0 * hd, h1 * hd, cfg.num_heads * hd),
                                        (r0, r1))])
    return layers.reduce_rows(lay, merged @ lay.w(p.wo).to(dtype), partial, False)


def encoder_kv(p: Attention, enc_out: torch.Tensor, cfg: ArchConfig,
               lay: layers.Layout = layers.SINGLE, heads: Optional[tuple] = None):
    """Cross-attention k/v (B, KV', T, hd) of the encoder's output (B, T, d),
    for kv heads ``heads = (c0, c1)`` (default all); over a mesh from the
    rank's column blocks of ``wk`` / ``wv``, gathered over tp where they do
    not hold those heads."""
    b, t, _ = enc_out.shape
    hd = cfg.head_dim_
    c0, c1 = heads if heads is not None else (0, cfg.num_kv_heads)
    partial = lay.rows(p.wo)[:2] != (0, cfg.num_heads * hd)
    enc_out = lay.tp_input(enc_out, False, partial)
    dtype = enc_out.dtype
    k, v = layers.take_cols(lay, [
        (enc_out @ lay.w(p.wk).to(dtype), lay.cols(p.wk), (c0 * hd, c1 * hd)),
        (enc_out @ lay.w(p.wv).to(dtype), lay.cols(p.wv), (c0 * hd, c1 * hd)),
    ])
    k = k.reshape(b, t, c1 - c0, hd).permute(0, 2, 1, 3)
    v = v.reshape(b, t, c1 - c0, hd).permute(0, 2, 1, 3)
    return k, v


def ring_decode_attention(p: Attention, x: torch.Tensor, cfg: ArchConfig, cache: RingKVCache,
                          pos: torch.Tensor, window: int):
    """One-token decode against a ring cache (x (B, 1, d), pos (B,)), the
    reference's function: :func:`attention` with the ring, written in place."""
    return attention(p, x, cfg, pos.reshape(-1, 1), causal=True, window=window, cache=cache,
                     cache_pos=pos)
