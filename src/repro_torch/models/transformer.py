"""Decoder-only LM assembly for dense ``attn`` stacks and xLSTM
(``mlstm``/``slstm``) stacks (port of ``repro.models.transformer``).

Parameters are ``nn.Module``s in the reference's layout: ``embed``
(V, d), ``layers`` (one :class:`Period` per pattern period, each holding
its blocks ``b0``, ``b1``, ...), ``final_norm`` (d,) and, untied,
``lm_head`` (d, V).  The reference's ``lax.scan`` over periods is a Python
loop over ``layers``.  Caches keep the reference's stacked layout: one
cache per block position whose tensors carry a leading ``num_periods``
axis: a :class:`~repro_torch.models.attention.KVCache` ``(num_periods, B,
KV, S_max, hd)`` for ``attn``, an :class:`~repro_torch.models.ssm.MLSTMState`
or :class:`~repro_torch.models.ssm.SLSTMState` for the xLSTM blocks (their
size does not depend on ``cache_len``).

Three modes share the block code: ``forward_train`` (no caches; a forward
pass only, the teacher-forced oracle), ``prefill`` (returns caches) and
``decode_step`` (one token against the caches, written in place).  Each
takes a ``layout`` (:class:`~repro_torch.models.layers.Layout`): over a mesh
the parameters are a rank's blocks, the batch is sharded over dp where it
divides, the residual stream over tp in a sequence-parallel prefill, each
layer's FSDP blocks are gathered before it, and the logits come back whole
on every rank; the caches are a rank's blocks, as :class:`Caches`.

``attn`` blocks with the SwiGLU MLP and the self-contained ``mlstm`` and
``slstm`` blocks (no MLP, as in the reference) are ported; ``swa``/``local``
(ring caches), ``rglru``, MoE, encoder-decoder and frontend models raise
``NotImplementedError`` naming their slice, as do the loss and the backward
pass (the training slice).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm

ATTN_TYPES = ("attn",)
XLSTM_TYPES = ("mlstm", "slstm")
# The slice of the port that brings each block type or feature not ported yet.
LATER_BLOCK_SLICE = {
    "swa": "the ring-cache slice (swa/local windows)",
    "local": "the ring-cache slice (swa/local windows)",
    "rglru": "the Griffin slice (rglru blocks)",
}
MOE_SLICE = "the MoE slice"
ENCDEC_SLICE = "the encoder-decoder slice"
FRONTEND_SLICE = "the VLM/audio frontend slice"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    cfg.validate()
    for bt in cfg.block_pattern:
        if bt not in ATTN_TYPES + XLSTM_TYPES:
            if bt not in LATER_BLOCK_SLICE:
                raise ValueError(f"unknown block type {bt}")
            raise NotImplementedError(
                f"block type {bt!r} is not ported yet: it belongs to {LATER_BLOCK_SLICE[bt]}"
            )
    if cfg.is_moe:
        raise NotImplementedError(f"MoE layers are not ported yet: they belong to {MOE_SLICE}")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder models belong to {ENCDEC_SLICE}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"frontend {cfg.frontend!r} belongs to {FRONTEND_SLICE}")
    if cfg.d_ff <= 0 and any(bt in ATTN_TYPES for bt in cfg.block_pattern):
        raise NotImplementedError("attn blocks without an MLP are not ported yet")


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.w_gate = _param((cfg.d_model, cfg.d_ff), dtype, device)
        self.w_up = _param((cfg.d_model, cfg.d_ff), dtype, device)
        self.w_down = _param((cfg.d_ff, cfg.d_model), dtype, device)


class Block(nn.Module):
    """Pre-norm attention block with the SwiGLU MLP (norms in f32)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.norm1 = _param((cfg.d_model,), torch.float32, device)
        self.attn = attn.Attention(cfg, dtype=dtype, device=device)
        self.norm2 = _param((cfg.d_model,), torch.float32, device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)


class MixerBlock(nn.Module):
    """An xLSTM block: the self-contained mixer alone (never an MLP)."""

    def __init__(self, cfg: ArchConfig, bt: str, *, dtype, device):
        super().__init__()
        mixer = ssm.MLSTM if bt == "mlstm" else ssm.SLSTM
        self.mixer = mixer(cfg, dtype=dtype, device=device)


class Period(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        for j, bt in enumerate(cfg.block_pattern):
            block = (Block(cfg, dtype=dtype, device=device) if bt in ATTN_TYPES
                     else MixerBlock(cfg, bt, dtype=dtype, device=device))
            self.add_module(f"b{j}", block)


class Transformer(nn.Module):
    """All parameters of a decoder-only LM.  ``dtype`` is the matrices' type;
    norm vectors are f32.  Tensors are allocated uninitialised (``device
    ="meta"`` allocates nothing): fill them with :func:`init_params` or
    ``models.convert``."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.vocab_size, cfg.d_model), dtype, device)
        self.layers = nn.ModuleList(
            Period(cfg, dtype=dtype, device=device) for _ in range(cfg.num_periods)
        )
        self.final_norm = _param((cfg.d_model,), torch.float32, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_size), dtype, device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(
    cfg: ArchConfig, generator: torch.Generator, *, device, dtype: Optional[torch.dtype] = None,
    layout: Optional[layers.Layout] = None,
) -> Transformer:
    """Random parameters by the reference's rule, drawn on ``device`` (the
    generator's device) from ``generator``: every matrix truncated-normal
    with std ``1 / sqrt(fan_in)`` (the embedding's fan-in is its vocab axis,
    as in the reference), every norm vector ones; the sLSTM's recurrent
    ``r`` (H, 4, hd, hd) a plain normal over ``sqrt(hd)`` and its bias ``b``
    zeros (``ssm.init_slstm``).  Matrices are stored in ``dtype`` (default:
    the config's compute type), one matrix drawn in f32 at a time.  The
    draws differ from ``jax.random``'s for the same seed.

    With a sharded ``layout`` every parameter is still drawn whole, in the
    same order from the same generator, and the rank keeps its block: the
    weights are the unsharded model's, and the peak is one whole tensor."""
    dtype = dtype or compute_dtype(cfg)
    sharded = layout is not None and layout.sharded
    model = Transformer(cfg, dtype=dtype, device="meta" if sharded else device)
    blocks = {}
    for name, t in model.named_parameters():
        full = torch.empty(t.shape, dtype=t.dtype, device=device) if sharded else t
        with torch.no_grad():
            if name.endswith(".mixer.r"):
                draw = torch.randn(full.shape, generator=generator, dtype=torch.float32,
                                   device=full.device)
                full.copy_(draw.div_(math.sqrt(full.shape[-1])))
            elif name.endswith(".mixer.b"):
                full.zero_()
            elif full.ndim >= 2:
                layers.truncated_normal_(full, 1.0, generator)
            else:
                full.fill_(1.0)
        if sharded:
            blocks[name] = layout.block_of(name, full).clone()
            del full
    if sharded:
        set_params(model, blocks)
    return model


def set_params(model: nn.Module, tensors: dict) -> nn.Module:
    """Put ``tensors`` (name → tensor, any shape: a rank's blocks) in place
    of ``model``'s parameters."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
    return model


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
class Caches(dict):
    """A rank's decode caches over a mesh: ``{"b<j>": cache}`` with their
    ``specs`` (``sharding.cache_pspecs`` of the whole caches, the same
    structure) and the batch rows ``slots = (lo, hi)`` the rank holds."""

    def __init__(self, caches: dict, specs: dict, slots: tuple):
        super().__init__(caches)
        self.specs = specs
        self.slots = slots


def block_cache_shapes(cfg: ArchConfig, bt: str, batch: int, cache_len: int) -> tuple:
    """The whole shapes of one block position's cache (its NamedTuple's
    fields, leading ``num_periods`` axis)."""
    p = cfg.num_periods
    if bt in ATTN_TYPES:
        shape = (p, batch, cfg.num_kv_heads, cache_len, cfg.head_dim_)
        return attn.KVCache(shape, shape)
    if bt == "mlstm":
        h, dk, dv = ssm.mlstm_dims(cfg)
        return ssm.MLSTMState((p, batch, h, dk, dv), (p, batch, h, dk))
    return ssm.SLSTMState(*((p, batch, cfg.d_model),) * 4)


def init_block_cache(cfg: ArchConfig, bt: str, batch: int, cache_len: int, device,
                     specs=None, mesh_shape: Optional[dict] = None):
    """One block position's cache for all periods (leading ``num_periods``
    axis): zero KV for ``attn``; for ``mlstm`` zero ``c`` (B, H, dk, dv) and
    ``n`` (B, H, dk) f32; for ``slstm`` zero ``c, n, h`` and ``m = -1e30``,
    (B, d) f32 each.  With ``specs`` (the fields' specs over a mesh of
    ``mesh_shape``) a rank's blocks."""
    from repro_torch.distributed import sharding

    shapes = block_cache_shapes(cfg, bt, batch, cache_len)
    if specs is not None:
        shapes = type(shapes)(*(sharding.local_shape(sh, sp, mesh_shape)
                                for sh, sp in zip(shapes, specs)))
    if bt in ATTN_TYPES:
        dt = compute_dtype(cfg)
        return attn.KVCache(*(torch.zeros(sh, dtype=dt, device=device) for sh in shapes))
    if bt == "mlstm":
        return ssm.MLSTMState(*(torch.zeros(sh, dtype=torch.float32, device=device)
                                for sh in shapes))
    return ssm.SLSTMState(
        *(torch.zeros(sh, dtype=torch.float32, device=device) for sh in shapes[:3]),
        torch.full(shapes[3], ssm.NEG_INIT_M, dtype=torch.float32, device=device),
    )


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int, lay: layers.Layout):
    """``(specs, slots)`` of a rank's caches for ``batch`` sequences over
    ``lay``'s mesh (``sharding.cache_pspecs``)."""
    from repro_torch.distributed import sharding

    specs = sharding.cache_pspecs({f"b{j}": block_cache_shapes(cfg, bt, batch, cache_len)
                                   for j, bt in enumerate(cfg.block_pattern)}, lay.parallel)
    first = next(iter(specs.values()))[0]
    slots = (0, batch)
    if first[1] is not None:
        n = batch // lay.dp.size
        slots = (lay.dp.index * n, (lay.dp.index + 1) * n)
    return specs, slots


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device,
               layout: Optional[layers.Layout] = None) -> dict:
    """Zero caches for all layers: ``{"b<j>": cache}``, each tensor with a
    leading ``num_periods`` axis (``init_block_cache``); over a sharded
    ``layout`` the rank's blocks, as :class:`Caches`."""
    check_supported(cfg)
    if layout is None or not layout.sharded:
        return {
            f"b{j}": init_block_cache(cfg, bt, batch, cache_len, device)
            for j, bt in enumerate(cfg.block_pattern)
        }
    from repro_torch.distributed.parallel import mesh_shape

    specs, slots = cache_specs(cfg, batch, cache_len, layout)
    shape = mesh_shape(layout.parallel.mesh)
    return Caches({
        f"b{j}": init_block_cache(cfg, bt, batch, cache_len, device, specs[f"b{j}"], shape)
        for j, bt in enumerate(cfg.block_pattern)
    }, specs, slots)


def kv_layout(lay: layers.Layout, spec) -> Optional[str]:
    """The tp layout of a KV cache from its 5-dim spec: ``"heads"``,
    ``"seq"`` or None (whole)."""
    if spec is None or lay.tp.size == 1:
        return None
    tp = lay.parallel.tp_axis
    if spec[2] == tp:
        return "heads"
    if spec[3] == tp:
        return "seq"
    return None


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------
def _apply_mlp(p: Block, x: torch.Tensor, lay: layers.Layout = layers.SINGLE,
               sp: bool = False) -> torch.Tensor:
    """The SwiGLU residual: ``w_gate`` / ``w_up`` column-parallel and
    ``w_down`` row-parallel over a mesh (``x`` the rank's sequence block
    under ``sp``)."""
    xin = layers.rmsnorm(x, p.norm2)
    if sp:
        xin = lay.tp.all_gather(xin, 1)
    m = p.mlp
    out = layers.swiglu(xin, lay.w(m.w_gate), lay.w(m.w_up), lay.w(m.w_down))
    r0, r1, n = lay.rows(m.w_down)
    return x + layers.reduce_rows(lay, out, (r0, r1) != (0, n), sp)


def apply_block_train(bt: str, p, x, positions, cfg: ArchConfig,
                      lay: layers.Layout = layers.SINGLE, sp: bool = False):
    if bt == "mlstm":
        return ssm.mlstm_block(p.mixer, x, cfg, lay=lay)[0]
    if bt == "slstm":
        return ssm.slstm_block(p.mixer, x, cfg, lay=lay)[0]
    xin = layers.rmsnorm(x, p.norm1)
    out, _ = attn.attention(p.attn, xin, cfg, positions, causal=True, window=None, lay=lay,
                            sp=sp)
    return _apply_mlp(p, x + out, lay, sp)


def apply_block_prefill(bt: str, p, x, positions, cfg: ArchConfig, cache_len: int,
                        lay: layers.Layout = layers.SINGLE, sp: bool = False,
                        kv: Optional[str] = None):
    if bt == "mlstm":
        return ssm.mlstm_block(p.mixer, x, cfg, return_state=True, lay=lay)
    if bt == "slstm":
        return ssm.slstm_block(p.mixer, x, cfg, return_state=True, lay=lay)
    xin = layers.rmsnorm(x, p.norm1)
    out, cache = attn.attention(
        p.attn, xin, cfg, positions, causal=True, window=None,
        return_cache=True, cache_len=cache_len, lay=lay, sp=sp, kv_layout=kv,
    )
    return _apply_mlp(p, x + out, lay, sp), cache


def apply_block_decode(bt: str, p, x, cache, pos, cfg: ArchConfig,
                       lay: layers.Layout = layers.SINGLE, kv: Optional[str] = None):
    """One token through one block.  An ``attn`` block writes its KV cache
    in place; an xLSTM block copies its new state into ``cache`` (views of
    the batched state)."""
    if bt in XLSTM_TYPES:
        step = ssm.mlstm_decode_step if bt == "mlstm" else ssm.slstm_decode_step
        x, new = step(p.mixer, x, cfg, cache, lay)
        for dst, src in zip(cache, new):
            dst.copy_(src)
        return x, cache
    xin = layers.rmsnorm(x, p.norm1)
    out, cache = attn.attention(
        p.attn, xin, cfg, pos.reshape(-1, 1), causal=True, cache=cache, cache_pos=pos,
        lay=lay, kv_layout=kv,
    )
    return _apply_mlp(p, x + out, lay), cache


# ---------------------------------------------------------------------------
# model-level forward passes
# ---------------------------------------------------------------------------
def _layout(params: Transformer, layout: Optional[layers.Layout]) -> layers.Layout:
    return (layout or layers.SINGLE).view(params)


def _embed(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
           lay: layers.Layout = layers.SINGLE, sp: bool = False) -> torch.Tensor:
    return layers.embed_tokens(lay, params.embed, tokens, compute_dtype(cfg), sp)


def _head(params: Transformer, x: torch.Tensor, cfg: ArchConfig,
          lay: layers.Layout = layers.SINGLE) -> torch.Tensor:
    """Logits over the whole vocab: the head is column-parallel over a mesh
    (``lm_head``, or the vocab-parallel ``embed`` when tied) and the blocks
    are all-gathered over tp."""
    xf = layers.rmsnorm(x, params.final_norm)
    if cfg.tie_embeddings:
        w, (lo, hi, n) = lay.w(params.embed).T, lay.rows(params.embed)
    else:
        w, (lo, hi, n) = lay.w(params.lm_head), lay.cols(params.lm_head)
    logits = xf @ w.to(xf.dtype)
    return logits if (lo, hi) == (0, n) else lay.tp.all_gather(logits, -1)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


@torch.no_grad()
def forward_train(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
                  layout: Optional[layers.Layout] = None):
    """Full teacher-forced forward pass.  tokens (B, S+1) → (logits (B,S,V), aux).

    ``aux`` is the reference's MoE load-balance term, 0 for dense stacks.
    Over a mesh (``layout``) every rank returns the whole logits."""
    check_supported(cfg)
    lay = _layout(params, layout)
    batch_sharded, sp = lay.act(cfg, (tokens.shape[0], tokens.shape[1] - 1))
    inputs = lay.batch_rows(tokens[:, :-1], batch_sharded)
    b, s = inputs.shape
    x = _embed(params, inputs, cfg, lay, sp)
    positions = _positions(b, s, x.device)
    for period in params.layers:
        with lay.gathered(period):
            for j, bt in enumerate(cfg.block_pattern):
                x = apply_block_train(bt, getattr(period, f"b{j}"), x, positions, cfg, lay, sp)
    if sp:
        x = lay.tp.all_gather(x, 1)
    logits = lay.gather_batch(_head(params, x, cfg, lay), batch_sharded)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
            cache_len: Optional[int] = None, layout: Optional[layers.Layout] = None):
    """Process the prompt, return (last-token logits (B, V), caches).

    ``cache_len`` sizes the decode KV caches (≥ prompt length).  Over a
    mesh (``layout``) the logits are whole on every rank (the same bits) and
    the caches are the rank's blocks, as :class:`Caches`; the residual
    stream is sequence-sharded where ``layout.act`` says."""
    check_supported(cfg)
    lay = _layout(params, layout)
    b_full, s = tokens.shape
    batch_sharded, sp = lay.act(cfg, tokens.shape)
    tokens = lay.batch_rows(tokens, batch_sharded)
    b = tokens.shape[0]
    x = _embed(params, tokens, cfg, lay, sp)
    cache_len = max(cache_len or s, s)
    specs, slots = cache_specs(cfg, b_full, cache_len, lay) if lay.sharded else (None, None)
    positions = _positions(b, s, x.device)
    per_block = {f"b{j}": [] for j, _ in enumerate(cfg.block_pattern)}
    for period in params.layers:
        with lay.gathered(period):
            for j, bt in enumerate(cfg.block_pattern):
                kv = kv_layout(lay, specs[f"b{j}"][0]) if specs else None
                x, c = apply_block_prefill(bt, getattr(period, f"b{j}"), x, positions, cfg,
                                           cache_len, lay, sp, kv)
                per_block[f"b{j}"].append(c)
    caches = {
        name: type(cs[0])(*(torch.stack(leaves) for leaves in zip(*cs)))
        for name, cs in per_block.items()
    }
    last = x[:, -1:]
    if sp:  # the last position is in the last tp rank's block
        last = lay.tp.broadcast(last.contiguous(), lay.tp.size - 1)
    logits = lay.gather_batch(_head(params, last, cfg, lay)[:, 0], batch_sharded)
    if specs is not None:
        caches = Caches(caches, specs, slots)
    return logits, caches


@torch.no_grad()
def decode_step(params: Transformer, caches: dict, token: torch.Tensor, pos: torch.Tensor,
                cfg: ArchConfig, layout: Optional[layers.Layout] = None):
    """One decode step: token (B, 1), pos (B,) the token's absolute position.

    Returns (logits (B, V), caches); the caches are updated in place and
    returned as given.  Over a mesh ``token`` and ``pos`` are the whole
    batch's, ``caches`` the rank's blocks (:class:`Caches`) and the logits
    whole on every rank."""
    check_supported(cfg)
    lay = _layout(params, layout)
    specs = getattr(caches, "specs", None)
    if lay.sharded and specs is None:
        raise ValueError("a sharded decode step takes the rank's Caches (init_cache or prefill)")
    batch_sharded, _ = lay.act(cfg, token.shape, seq=False)
    token, pos = lay.batch_rows(token, batch_sharded), lay.batch_rows(pos, batch_sharded)
    x = _embed(params, token, cfg, lay)
    for i, period in enumerate(params.layers):
        with lay.gathered(period):
            for j, bt in enumerate(cfg.block_pattern):
                c = caches[f"b{j}"]
                kv = kv_layout(lay, specs[f"b{j}"][0]) if specs else None
                x, _ = apply_block_decode(
                    bt, getattr(period, f"b{j}"), x, type(c)(*(t[i] for t in c)), pos, cfg,
                    lay, kv,
                )
    logits = lay.gather_batch(_head(params, x, cfg, lay)[:, 0], batch_sharded)
    return logits, caches
