"""Encoder-decoder model, whisper-base's backbone (port of ``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the model takes
precomputed frame embeddings ``frames`` (B, T_frames, d_model).  Encoder:
non-causal self-attention (kernel 6 with ``causal=False`` on the card, its
twin on the CPU) and the GELU MLP with biases, sinusoidal positions.
Decoder: causal self-attention with a KV cache (kernel 6 in prefill, the
plain decode attention after it), cross-attention over the encoder's output
(the plain einsum, as the reference's: it never runs its Pallas kernel
there) and the GELU MLP.  The embedding is tied to the head (``embed.T``).
RMSNorm stands where whisper has LayerNorm: the reference's stated
deviation, kept.  The frames are cast to the compute type and the positions
added in it.

Parameters (:class:`EncoderDecoder`) carry the reference's names:
``embed`` (V, d), ``enc_layers.<i>`` and ``dec_layers.<i>`` (the
reference's leaves stacked over layers, unstacked), ``enc_norm``,
``dec_norm``; matrices in the compute type, norms and biases f32 (the
reference's serving copy).  Caches are the reference's: ``{"self":
KVCache (L, B, KV, S_max, hd), "cross_k", "cross_v": (L, B, KV, T, hd)}``
stacked over decoder layers; decode writes the self cache in place.

Over a mesh (a :class:`~repro_torch.models.layers.Layout`, as
``models/transformer.py`` takes one) the blocks follow the reference's
rules: the encoder's and the decoder's attention ``wq``/``wk``/``wv``
column-parallel over tp and ``wo`` row-parallel, a rank on its own heads
(kernel 6 runs on them); cross-attention alike, its k/v computed on the
rank's heads of the encoder's output; the MLP's ``w_in`` column- and
``w_out`` row-parallel (``b_out`` added once, after the sum over tp).  A
layer's FSDP blocks are gathered before it.  The embedding is
vocab-parallel where the vocab divides over tp (whisper-base's 51,865 does
not: it stays whole, the reference's fallback); the positions are whole on
every rank.  The batch is split over dp where it divides.  The caches are
the rank's blocks (:func:`cache_specs`: batch over dp, heads over tp) as
a ``transformer.Caches``; the logits come back whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer
from repro_torch.models.transformer import compute_dtype


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class GeluMLP(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.w_in = _param((cfg.d_model, cfg.d_ff), dtype, device)
        self.b_in = _param((cfg.d_ff,), torch.float32, device)
        self.w_out = _param((cfg.d_ff, cfg.d_model), dtype, device)
        self.b_out = _param((cfg.d_model,), torch.float32, device)


class EncLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.norm1 = _param((cfg.d_model,), torch.float32, device)
        self.attn = attn.Attention(cfg, dtype=dtype, device=device)
        self.norm2 = _param((cfg.d_model,), torch.float32, device)
        self.mlp = GeluMLP(cfg, dtype=dtype, device=device)


class DecLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.norm1 = _param((cfg.d_model,), torch.float32, device)
        self.self_attn = attn.Attention(cfg, dtype=dtype, device=device)
        self.norm_x = _param((cfg.d_model,), torch.float32, device)
        self.cross_attn = attn.Attention(cfg, dtype=dtype, device=device)
        self.norm2 = _param((cfg.d_model,), torch.float32, device)
        self.mlp = GeluMLP(cfg, dtype=dtype, device=device)


def check_supported(cfg: ArchConfig) -> None:
    cfg.validate()
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: not an encoder-decoder config")


class EncoderDecoder(nn.Module):
    """All parameters of an encoder-decoder model (allocated uninitialised;
    ``device="meta"`` allocates nothing)."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), dtype, device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, dtype=dtype, device=device)
                                        for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dtype=dtype, device=device)
                                        for _ in range(cfg.num_layers))
        self.enc_norm = _param((cfg.d_model,), torch.float32, device)
        self.dec_norm = _param((cfg.d_model,), torch.float32, device)


def init_params(cfg: ArchConfig, generator: torch.Generator, *, device,
                dtype: Optional[torch.dtype] = None,
                layout: Optional[layers.Layout] = None) -> EncoderDecoder:
    """Random parameters by the reference's rule on ``device`` from
    ``generator``: every matrix truncated-normal with std ``1 / sqrt(fan_in)``
    (the embedding's fan-in its vocab axis), norms ones, the MLPs' biases
    zeros; matrices in ``dtype`` (default: the compute type).  The draws
    differ from ``jax.random``'s for the same seed.  With a sharded
    ``layout`` every parameter is drawn whole, in the same order, and the
    rank keeps its block (``transformer.init_params``'s rule)."""
    sharded = layout is not None and layout.sharded
    model = EncoderDecoder(cfg, dtype=dtype or compute_dtype(cfg),
                           device="meta" if sharded else device)
    blocks = {}
    for name, t in model.named_parameters():
        full = torch.empty(t.shape, dtype=t.dtype, device=device) if sharded else t
        with torch.no_grad():
            if full.ndim >= 2:
                layers.truncated_normal_(full, 1.0, generator)
            elif name.rpartition(".")[2] in ("b_in", "b_out"):
                full.zero_()
            else:
                full.fill_(1.0)
        if sharded:
            blocks[name] = layout.block_of(name, full).clone()
            del full
    return transformer.set_params(model, blocks) if sharded else model


def _mlp(m: GeluMLP, x: torch.Tensor, lay: layers.Layout = layers.SINGLE) -> torch.Tensor:
    """The GELU MLP of ``x``: ``w_in`` column-, ``w_out`` row-parallel over a
    mesh, ``b_out`` added after the sum over tp."""
    r0, r1, n = lay.rows(m.w_out)
    if (r0, r1) == (0, n):
        return layers.gelu_mlp(x, lay.w(m.w_in), m.b_in, lay.w(m.w_out), m.b_out)
    dtype = x.dtype
    c0, c1, _ = lay.cols(m.w_in)
    xin = lay.tp_input(x, False)
    h = F.gelu(xin @ lay.w(m.w_in).to(dtype) + lay.tp_shared(m.b_in)[c0:c1].to(dtype),
               approximate="tanh")
    out = layers.reduce_rows(lay, h @ lay.w(m.w_out).to(dtype), True, False)
    return out + m.b_out.to(dtype)


def _embed(params: EncoderDecoder, tokens: torch.Tensor, cfg: ArchConfig,
           pos: Optional[torch.Tensor] = None, lay: layers.Layout = layers.SINGLE) -> torch.Tensor:
    """Token embeddings plus sinusoidal positions (0..S-1, or ``pos`` (B,)
    for one decode token), added in the compute type."""
    x = layers.embed_tokens(lay, params.embed, tokens, compute_dtype(cfg), False)
    if pos is None:
        pe = layers.sinusoidal_positions(x.shape[1], cfg.d_model, device=x.device)
    else:
        pe = layers.sinusoidal_at(pos, cfg.d_model)[:, None, :]
    return x + pe.to(x.dtype)


def _logits(params: EncoderDecoder, x: torch.Tensor,
            lay: layers.Layout = layers.SINGLE) -> torch.Tensor:
    """The tied head (``embed.T``): whole on every rank, the vocab blocks
    all-gathered over tp where the embedding is vocab-parallel."""
    from repro_torch.distributed import collectives

    x = layers.rmsnorm(x, params.dec_norm)
    lo, hi, v = lay.rows(params.embed)
    if (lo, hi) == (0, v):
        return x @ params.embed.T.to(x.dtype)
    logits = collectives.enter_sharded(lay.tp, x) @ params.embed.T.to(x.dtype)
    return collectives.gather_whole(lay.tp, logits, -1)


def _layout(params: EncoderDecoder, layout: Optional[layers.Layout]) -> layers.Layout:
    return (layout or layers.SINGLE).view(params)


def _rows(lay: layers.Layout, cfg: ArchConfig, b: int) -> bool:
    """Whether a batch of ``b`` rows is split over dp (where it divides)."""
    return lay.act(cfg, (b, 1), seq=False)[0]


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def encode(params: EncoderDecoder, frames: torch.Tensor, cfg: ArchConfig,
           layout: Optional[layers.Layout] = None) -> torch.Tensor:
    """frames (B, T, d), the stub frontend's embeddings → (B, T, d) (over a
    mesh: the rank's rows, whole on every tp rank)."""
    lay = _layout(params, layout)
    _, t, d = frames.shape
    dt = compute_dtype(cfg)
    x = frames.to(dt) + layers.sinusoidal_positions(t, d, device=frames.device).to(dt)
    for p in params.enc_layers:
        with lay.gathered(p):
            out, _ = attn.attention(p.attn, layers.rmsnorm(x, p.norm1), cfg, None, causal=False,
                                    lay=lay)
            x = x + out
            x = x + _mlp(p.mlp, layers.rmsnorm(x, p.norm2), lay)
    return layers.rmsnorm(x, params.enc_norm)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def _dec_rest(p: DecLayer, x: torch.Tensor, cfg: ArchConfig, ek: torch.Tensor,
              ev: torch.Tensor, lay: layers.Layout = layers.SINGLE,
              kv_heads: Optional[tuple] = None, frames_split: bool = False) -> torch.Tensor:
    """A decoder layer after its self-attention: cross-attention (over the
    kv heads ``kv_heads`` that ``ek``/``ev`` hold; under ``frames_split``
    over the rank's block of the frames, ``attn.cross_attention``), then the
    MLP."""
    x = x + attn.cross_attention(p.cross_attn, layers.rmsnorm(x, p.norm_x), cfg, ek, ev, lay,
                                 kv_heads, frames_split)
    return x + _mlp(p.mlp, layers.rmsnorm(x, p.norm2), lay)


def cross_heads(cfg: ArchConfig, lay: layers.Layout) -> tuple:
    """The kv heads ``[c0, c1)`` of a rank's cross cache: its tp block
    where the kv heads divide over tp, else every head."""
    kv = cfg.num_kv_heads
    if lay.tp.size == 1 or kv % lay.tp.size:
        return 0, kv
    n = kv // lay.tp.size
    return lay.tp.index * n, (lay.tp.index + 1) * n


def cross_frames(cfg: ArchConfig, lay: layers.Layout, specs) -> Optional[tuple]:
    """The frames ``[t0, t1)`` of a rank's cross cache where ``specs`` split
    it by frames over tp (the kv heads do not divide over tp, the frames
    do: ``sharding.cache_leaf_spec``), else None (it holds every frame)."""
    if specs is None or lay.tp.size == 1 or specs["cross_k"][3] != lay.parallel.tp_axis:
        return None
    n = cfg.frontend_len // lay.tp.size
    return lay.tp.index * n, (lay.tp.index + 1) * n


def forward_train(params: EncoderDecoder, tokens: torch.Tensor, frames: torch.Tensor,
                  cfg: ArchConfig, layout: Optional[layers.Layout] = None) -> torch.Tensor:
    """tokens (B, S+1), frames (B, T, d) → logits (B, S, V), whole on every
    rank over a mesh.  Differentiable."""
    lay = _layout(params, layout)
    split = _rows(lay, cfg, tokens.shape[0])
    logits = _trunk_logits(params, lay.batch_rows(tokens[:, :-1], split),
                           lay.batch_rows(frames, split), cfg, lay)
    return lay.gather_batch(logits, split)


def _trunk_logits(params, tokens, frames, cfg, lay) -> torch.Tensor:
    enc_out = encode(params, frames, cfg, lay)
    x = _embed(params, tokens, cfg, lay=lay)
    heads = cross_heads(cfg, lay)
    for p in params.dec_layers:
        with lay.gathered(p):
            out, _ = attn.attention(p.self_attn, layers.rmsnorm(x, p.norm1), cfg, None,
                                    causal=True, lay=lay)
            ek, ev = attn.encoder_kv(p.cross_attn, enc_out, cfg, lay, heads)
            x = _dec_rest(p, x + out, cfg, ek, ev, lay, heads)
    return _logits(params, x, lay)


def loss_fn(params: EncoderDecoder, batch: dict, cfg: ArchConfig,
            layout: Optional[layers.Layout] = None):
    """Next-token CE of ``batch["tokens"]`` (B, S+1) given ``batch["frames"]``:
    ``(ce, {"loss", "ce", "moe_aux" (0), "ce_rows"})``, f32 scalars.  Over a
    mesh each rank takes its rows where they divide over dp (``ValueError``
    otherwise) and ``ce`` is their mean summed over dp, as
    ``transformer.loss_fn``'s."""
    from repro_torch.distributed import collectives

    lay = _layout(params, layout)
    tokens, frames = batch["tokens"], batch["frames"]
    split = _rows(lay, cfg, tokens.shape[0])
    if lay.dp.size > 1 and not split:
        raise ValueError(f"a loss over a mesh takes rows that divide over dp: {tokens.shape[0]} "
                         f"rows over {lay.dp.size} ranks")
    rows = lay.batch_rows(tokens, split)
    logits = _trunk_logits(params, rows[:, :-1], lay.batch_rows(frames, split), cfg, lay)
    mine = layers.softmax_cross_entropy_logits(logits, rows[:, 1:])
    ce = collectives.sum_partials(lay.dp, mine) / lay.dp.size
    zero = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"loss": ce, "ce": ce, "moe_aux": zero, "ce_rows": mine}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int) -> dict:
    """The whole caches' shapes (decoder layers stacked on axis 0)."""
    n, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    self_shape = (n, batch, kv, cache_len, hd)
    cross = (n, batch, kv, cfg.frontend_len, hd)
    return {"self": attn.KVCache(self_shape, self_shape), "cross_k": cross, "cross_v": cross}


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int, lay: layers.Layout):
    """``(specs, slots)`` of a rank's caches over ``lay``'s mesh
    (``sharding.cache_leaf_spec``: batch over dp, heads over tp, else the
    self cache's positions and the cross caches' frames, else whole)."""
    from repro_torch.distributed import sharding

    shapes = cache_shapes(cfg, batch, cache_len)
    one = sharding.cache_leaf_spec(shapes["self"].k, lay.parallel)
    cross = sharding.cache_leaf_spec(shapes["cross_k"], lay.parallel)
    specs = {"self": attn.KVCache(one, one), "cross_k": cross, "cross_v": cross}
    slots = (0, batch)
    if one[1] is not None:
        n = batch // lay.dp.size
        slots = (lay.dp.index * n, (lay.dp.index + 1) * n)
    return specs, slots


@torch.no_grad()
def prefill(params: EncoderDecoder, tokens: torch.Tensor, frames: torch.Tensor, cfg: ArchConfig,
            cache_len: Optional[int] = None, layout: Optional[layers.Layout] = None):
    """Encode the frames and consume the prompt tokens (B, S): (last-token
    logits (B, V), caches).  ``cache_len`` (default S) sizes the self caches.
    Over a mesh the logits are whole on every rank and the caches the
    rank's blocks (a ``transformer.Caches``)."""
    lay = _layout(params, layout)
    b_full = tokens.shape[0]
    split = _rows(lay, cfg, b_full)
    tokens, frames = lay.batch_rows(tokens, split), lay.batch_rows(frames, split)
    enc_out = encode(params, frames, cfg, lay)
    cache_len = cache_len or tokens.shape[1]
    specs, slots = cache_specs(cfg, b_full, cache_len, lay) if lay.sharded else (None, None)
    kv = transformer.kv_layout(lay, specs["self"].k) if specs else None
    heads = cross_heads(cfg, lay)
    frames = cross_frames(cfg, lay, specs)
    x = _embed(params, tokens, cfg, lay=lay)
    selfs, cks, cvs = [], [], []
    for p in params.dec_layers:
        with lay.gathered(p):
            out, cache = attn.attention(p.self_attn, layers.rmsnorm(x, p.norm1), cfg, None,
                                        causal=True, return_cache=True, cache_len=cache_len,
                                        lay=lay, kv_layout=kv)
            ek, ev = attn.encoder_kv(p.cross_attn, enc_out, cfg, lay, heads)
            x = _dec_rest(p, x + out, cfg, ek, ev, lay, heads)
        if frames is not None:  # the rank keeps its block of the frames
            ek, ev = (t[:, :, frames[0]:frames[1]].contiguous() for t in (ek, ev))
        selfs.append(cache)
        cks.append(ek)
        cvs.append(ev)
    caches = {"self": attn.KVCache(torch.stack([c.k for c in selfs]),
                                   torch.stack([c.v for c in selfs])),
              "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs)}
    logits = lay.gather_batch(_logits(params, x[:, -1:], lay)[:, 0], split)
    if specs is not None:
        caches = transformer.Caches(caches, specs, slots)
    return logits, caches


@torch.no_grad()
def decode_step(params: EncoderDecoder, caches: dict, token: torch.Tensor, pos: torch.Tensor,
                cfg: ArchConfig, layout: Optional[layers.Layout] = None):
    """One decode token (B, 1) at positions ``pos`` (B,): (logits (B, V),
    caches), the self caches written in place and returned as given.  Over
    a mesh ``token`` and ``pos`` are the whole batch's and ``caches`` the
    rank's blocks (:func:`prefill`'s or :func:`init_cache`'s)."""
    lay = _layout(params, layout)
    specs = getattr(caches, "specs", None)
    if lay.sharded and specs is None:
        raise ValueError("a sharded decode step takes the rank's Caches (init_cache or prefill)")
    split = _rows(lay, cfg, token.shape[0])
    token, pos = lay.batch_rows(token, split), lay.batch_rows(pos, split)
    kv = transformer.kv_layout(lay, specs["self"].k) if specs else None
    heads = cross_heads(cfg, lay)
    split_frames = cross_frames(cfg, lay, specs) is not None
    x = _embed(params, token, cfg, pos, lay)
    self_c = caches["self"]
    for i, p in enumerate(params.dec_layers):
        with lay.gathered(p):
            out, _ = attn.attention(p.self_attn, layers.rmsnorm(x, p.norm1), cfg, None,
                                    causal=True, cache=attn.KVCache(self_c.k[i], self_c.v[i]),
                                    cache_pos=pos, lay=lay, kv_layout=kv)
            x = _dec_rest(p, x + out, cfg, caches["cross_k"][i], caches["cross_v"][i], lay,
                          heads, split_frames)
    return lay.gather_batch(_logits(params, x, lay)[:, 0], split), caches


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device,
               layout: Optional[layers.Layout] = None) -> dict:
    """Zero self caches and zero cross k/v, stacked over decoder layers
    (over a sharded ``layout``: the rank's blocks, as a ``transformer.Caches``)."""
    dt = compute_dtype(cfg)
    shapes = cache_shapes(cfg, batch, cache_len)
    if layout is None or not layout.sharded:
        specs = None
        local = shapes
    else:
        from repro_torch.distributed import sharding
        from repro_torch.distributed.parallel import mesh_shape

        specs, slots = cache_specs(cfg, batch, cache_len, layout)
        mesh = mesh_shape(layout.parallel.mesh)
        local = {"self": attn.KVCache(*(sharding.local_shape(sh, sp, mesh) for sh, sp in
                                        zip(shapes["self"], specs["self"]))),
                 "cross_k": sharding.local_shape(shapes["cross_k"], specs["cross_k"], mesh),
                 "cross_v": sharding.local_shape(shapes["cross_v"], specs["cross_v"], mesh)}

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    out = {"self": attn.KVCache(zeros(local["self"].k), zeros(local["self"].v)),
           "cross_k": zeros(local["cross_k"]), "cross_v": zeros(local["cross_v"])}
    return out if specs is None else transformer.Caches(out, specs, slots)
