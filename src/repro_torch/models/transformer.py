"""Decoder-only LM assembly for ``attn``, ``swa`` and ``local`` stacks (with
the SwiGLU MLP or the MoE), xLSTM (``mlstm``/``slstm``) stacks and Griffin
(``rglru`` + ``local``) stacks (port of ``repro.models.transformer``).

Parameters are ``nn.Module``s in the reference's layout: ``embed``
(V, d), ``layers`` (one :class:`Period` per pattern period, each holding
its blocks ``b0``, ``b1``, ...), ``final_norm`` (d,) and, untied,
``lm_head`` (d, V).  The reference's ``lax.scan`` over periods is a Python
loop over ``layers``.  Caches keep the reference's stacked layout: one
cache per block position whose tensors carry a leading ``num_periods``
axis: a :class:`~repro_torch.models.attention.KVCache` ``(num_periods, B,
KV, S_max, hd)`` for ``attn``, a
:class:`~repro_torch.models.attention.RingKVCache` of ``min(window,
cache_len)`` slots for ``swa`` and ``local``, an
:class:`~repro_torch.models.ssm.MLSTMState` or
:class:`~repro_torch.models.ssm.SLSTMState` for the xLSTM blocks and an
:class:`~repro_torch.models.rglru.RGLRUState` for ``rglru`` (their size
does not depend on ``cache_len``).

Three modes share the block code: ``forward_train`` (no caches; the
teacher-forced pass, differentiable, and :func:`loss_fn` over it),
``prefill`` (returns caches) and
``decode_step`` (one token against the caches, written in place).  Each
takes a ``layout`` (:class:`~repro_torch.models.layers.Layout`): over a mesh
the parameters are a rank's blocks, the batch is sharded over dp where it
divides, the residual stream over tp in a sequence-parallel prefill, each
layer's FSDP blocks are gathered before it, and the logits come back whole
on every rank; the caches are a rank's blocks, as :class:`Caches`.

Attention blocks carry the SwiGLU MLP or the MoE (``models/moe.py``; its
load-balance aux is ``forward_train``'s second output and ``loss_fn``'s
``moe_aux``) when ``d_ff > 0``, and are attention alone (no ``norm2``, no
``mlp``) when ``d_ff == 0``, as the reference builds them; the xLSTM blocks are self-contained (no MLP, as in the
reference); an ``rglru`` block (``models/rglru.py``) is followed by the MLP
when ``d_ff > 0``.  A VLM's precomputed patch embeddings (``prefix_emb``,
the reference's stub frontend) go before the tokens in ``forward_train``
and ``prefill``; the positions cover them, and ``forward_train`` drops them
before the head.  Encoder-decoder models are ``models/encdec.py``'s.  Over a
mesh an ``rglru`` block follows the layout (``rglru.rglru_block``): its
recurrence runs on the rank's width block.  Parameters are made with
``requires_grad=False`` in the compute type (the serving copy);
:func:`trainable_params` turns f32 masters into a trainer's parameters.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, rglru, ssm

ATTN_TYPES = ("attn", "swa", "local")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a config this module does not build: an unknown block
    type or frontend, an encoder-decoder (``models.encdec``'s)."""
    cfg.validate()
    for bt in cfg.block_pattern:
        if bt not in ATTN_TYPES + layers.RECURRENT_TYPES:
            raise ValueError(f"unknown block type {bt}")
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: encoder-decoder models are built by models.encdec")
    if cfg.frontend not in (None, "patch_stub"):
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} belongs to an encoder-decoder")


def block_window(cfg: ArchConfig, bt: str) -> Optional[int]:
    """The attention window of block type ``bt`` (None: full causal)."""
    if bt == "swa":
        return cfg.sliding_window
    if bt == "local":
        return cfg.local_window
    return None


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


class MoEMLP(nn.Module):
    """The MoE in the MLP's place (the reference's ``{"moe": ...}``)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.moe = moe.MoE(cfg, dtype=dtype, device=device)


class Block(nn.Module):
    """Pre-norm attention block with the SwiGLU MLP or the MoE (norms in f32);
    attention alone where ``d_ff == 0``."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.norm1 = _param((cfg.d_model,), torch.float32, device)
        self.attn = attn.Attention(cfg, dtype=dtype, device=device)
        if cfg.d_ff > 0:
            self.norm2 = _param((cfg.d_model,), torch.float32, device)
            mlp = MoEMLP if cfg.is_moe else MLP
            self.mlp = mlp(cfg, dtype=dtype, device=device)


class MixerBlock(nn.Module):
    """A recurrent block: an xLSTM mixer alone (never an MLP), or the RG-LRU
    mixer followed by the MLP or the MoE (norm ``norm2``) when ``d_ff > 0``."""

    def __init__(self, cfg: ArchConfig, bt: str, *, dtype, device):
        super().__init__()
        mixer = {"mlstm": ssm.MLSTM, "slstm": ssm.SLSTM, "rglru": rglru.RGLRU}[bt]
        self.mixer = mixer(cfg, dtype=dtype, device=device)
        if bt == "rglru" and cfg.d_ff > 0:
            self.norm2 = _param((cfg.d_model,), torch.float32, device)
            self.mlp = (MoEMLP if cfg.is_moe else MLP)(cfg, dtype=dtype, device=device)


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
    as in the reference; each expert of an MoE stack (E, d_in, d_out) is
    its own matrix, of fan-in ``d_in``, as the reference ``vmap``s its
    init over experts), every norm vector ones; the sLSTM's recurrent
    ``r`` (H, 4, hd, hd) a plain normal over ``sqrt(hd)`` and its bias ``b``
    zeros (``ssm.init_slstm``); the RG-LRU's conv, biases and ``lambda`` by
    ``rglru.init_rglru_param``.  Matrices are stored in ``dtype`` (default:
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
            elif ".mixer." in name and rglru.init_rglru_param(name, full, cfg, generator):
                pass
            elif ".moe.w_" in name:
                for expert in full:
                    layers.truncated_normal_(expert, 1.0, generator)
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


def trainable_params(model: Transformer) -> Transformer:
    """Mark every parameter of ``model`` as requiring a gradient, in place:
    the f32 masters a trainer builds (``init_params(..., dtype=torch.float32)``,
    the reference's ``dense_init`` type).  Returns ``model``."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def compute_copy(params: nn.Module, cast: bool = True) -> nn.Module:
    """The reference's compute copy of f32 masters on a mesh (its train
    step's ``_compute_copy``, made once a step): a module over the same
    blocks whose f32 matrices (``ndim >= 2``) are cast to bf16, so that the
    FSDP gathers and the gradient reductions move bf16; the norm vectors are
    the masters' tensors.  ``cast=False`` keeps every leaf f32 (the
    reference makes no compute copy for an MoE stack, whose experts'
    gradients it reduces in f32).  Every parameter is a new leaf requiring a
    gradient, of which the step takes the gradients."""
    model = type(params)(params.cfg, dtype=torch.bfloat16 if cast else torch.float32,
                         device="meta")
    for name, p in params.named_parameters():
        t = p.detach()
        if cast and t.dtype == torch.float32 and t.ndim >= 2:
            t = t.to(torch.bfloat16)
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=True))
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
    if bt in ("swa", "local"):
        w = min(block_window(cfg, bt), cache_len)
        shape = (p, batch, cfg.num_kv_heads, w, cfg.head_dim_)
        return attn.RingKVCache(shape, shape, (p, batch, w))
    if bt in ATTN_TYPES:
        shape = (p, batch, cfg.num_kv_heads, cache_len, cfg.head_dim_)
        return attn.KVCache(shape, shape)
    if bt == "mlstm":
        h, dk, dv = ssm.mlstm_dims(cfg)
        return ssm.MLSTMState((p, batch, h, dk, dv), (p, batch, h, dk))
    if bt == "rglru":
        return rglru.RGLRUState(*((p,) + sh for sh in rglru.rglru_state_shapes(cfg, batch)))
    return ssm.SLSTMState(*((p, batch, cfg.d_model),) * 4)


def init_block_cache(cfg: ArchConfig, bt: str, batch: int, cache_len: int, device,
                     specs=None, mesh_shape: Optional[dict] = None):
    """One block position's cache for all periods (leading ``num_periods``
    axis): zero KV for ``attn``; for ``swa`` and ``local`` a zero ring with
    ``kpos`` -1 (B, W) int32; for ``mlstm`` zero ``c`` (B, H, dk, dv) and
    ``n`` (B, H, dk) f32; for ``slstm`` zero ``c, n, h`` and ``m = -1e30``,
    (B, d) f32 each; for ``rglru`` zero ``h`` (B, d_rnn) and ``conv``
    (B, cw-1, d_rnn), f32 (``rglru_init_state``).  With ``specs`` (the fields' specs over a mesh of
    ``mesh_shape``) a rank's blocks."""
    from repro_torch.distributed import sharding

    shapes = block_cache_shapes(cfg, bt, batch, cache_len)
    if specs is not None:
        shapes = type(shapes)(*(sharding.local_shape(sh, sp, mesh_shape)
                                for sh, sp in zip(shapes, specs)))
    if bt in ("swa", "local"):
        dt = compute_dtype(cfg)
        return attn.RingKVCache(torch.zeros(shapes.k, dtype=dt, device=device),
                                torch.zeros(shapes.v, dtype=dt, device=device),
                                torch.full(shapes.kpos, -1, dtype=torch.int32, device=device))
    if bt in ATTN_TYPES:
        dt = compute_dtype(cfg)
        return attn.KVCache(*(torch.zeros(sh, dtype=dt, device=device) for sh in shapes))
    if bt in ("mlstm", "rglru"):
        return type(shapes)(*(torch.zeros(sh, dtype=torch.float32, device=device)
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
def _apply_mlp(p: Block, x: torch.Tensor, cfg: ArchConfig, lay: layers.Layout = layers.SINGLE,
               sp: bool = False, ctx: Optional[moe.Context] = None) -> torch.Tensor:
    """The MLP residual: the SwiGLU with ``w_gate`` / ``w_up`` column-parallel
    and ``w_down`` row-parallel over a mesh (``x`` the rank's sequence block
    under ``sp``), or the MoE (``moe.apply``; its experts' ``f`` split over
    tp alike), which records its aux in ``ctx``."""
    m = p.mlp
    down = m.moe.w_down if cfg.is_moe else m.w_down
    r0, r1, n = lay.rows(down)
    partial = (r0, r1) != (0, n)
    xin = lay.tp_input(layers.rmsnorm(x, lay.tp_shared(p.norm2, sp)), sp, partial)
    if cfg.is_moe:
        out = moe.apply(m.moe, xin, cfg, lay, ctx)
    else:
        out = layers.swiglu(xin, lay.w(m.w_gate), lay.w(m.w_up), lay.w(m.w_down))
    return x + layers.reduce_rows(lay, out, partial, sp)


def _mix_train(bt: str, p, x, positions, cfg: ArchConfig, lay: layers.Layout = layers.SINGLE,
               sp: bool = False) -> torch.Tensor:
    """A block's mixer residual in a teacher-forced pass (an xLSTM block is
    its mixer alone)."""
    if bt == "mlstm":
        return ssm.mlstm_block(p.mixer, x, cfg, lay=lay)[0]
    if bt == "slstm":
        return ssm.slstm_block(p.mixer, x, cfg, lay=lay)[0]
    if bt == "rglru":
        return rglru.rglru_block(p.mixer, x, cfg, lay=lay, sp=sp)[0]
    xin = layers.rmsnorm(x, lay.tp_shared(p.norm1, sp))
    out, _ = attn.attention(p.attn, xin, cfg, positions, causal=True,
                            window=block_window(cfg, bt), lay=lay, sp=sp)
    return x + out


def _mlp_after(p, x, cfg: ArchConfig, lay: layers.Layout = layers.SINGLE, sp: bool = False,
               ctx: Optional[moe.Context] = None) -> torch.Tensor:
    """The block's MLP residual where it has one (``d_ff > 0``), else ``x``."""
    return _apply_mlp(p, x, cfg, lay, sp, ctx) if hasattr(p, "mlp") else x


def apply_block_train(bt: str, p, x, positions, cfg: ArchConfig,
                      lay: layers.Layout = layers.SINGLE, sp: bool = False,
                      ctx: Optional[moe.Context] = None):
    x = _mix_train(bt, p, x, positions, cfg, lay, sp)
    return _mlp_after(p, x, cfg, lay, sp, ctx)


def apply_block_prefill(bt: str, p, x, positions, cfg: ArchConfig, cache_len: int,
                        lay: layers.Layout = layers.SINGLE, sp: bool = False,
                        kv: Optional[str] = None, ctx: Optional[moe.Context] = None):
    """One block over the prompt: its output and its cache (an ``swa`` or
    ``local`` block's ring of ``min(window, cache_len)`` slots)."""
    if bt == "mlstm":
        return ssm.mlstm_block(p.mixer, x, cfg, return_state=True, lay=lay)
    if bt == "slstm":
        return ssm.slstm_block(p.mixer, x, cfg, return_state=True, lay=lay)
    if bt == "rglru":
        x, state = rglru.rglru_block(p.mixer, x, cfg, return_state=True, lay=lay, sp=sp)
        return _mlp_after(p, x, cfg, lay, sp, ctx), state
    w = block_window(cfg, bt)
    xin = layers.rmsnorm(x, p.norm1)
    out, cache = attn.attention(
        p.attn, xin, cfg, positions, causal=True, window=w,
        return_cache=True, cache_len=cache_len, lay=lay, sp=sp, kv_layout=kv,
        ring=None if w is None else min(w, cache_len),
    )
    return _mlp_after(p, x + out, cfg, lay, sp, ctx), cache


def apply_block_decode(bt: str, p, x, cache, pos, cfg: ArchConfig,
                       lay: layers.Layout = layers.SINGLE, kv: Optional[str] = None,
                       ctx: Optional[moe.Context] = None):
    """One token through one block.  An attention block writes its KV cache
    or ring in place; a recurrent block copies its new state into ``cache``
    (views of the batched state; the RG-LRU's conv tail is cast to the
    cache's f32)."""
    if bt in layers.RECURRENT_TYPES:
        if bt == "rglru":
            x, new = rglru.rglru_decode_step(p.mixer, x, cfg, cache, lay)
        else:
            step = ssm.mlstm_decode_step if bt == "mlstm" else ssm.slstm_decode_step
            x, new = step(p.mixer, x, cfg, cache, lay)
        for dst, src in zip(cache, new):
            dst.copy_(src)
        return _mlp_after(p, x, cfg, lay, ctx=ctx), cache
    xin = layers.rmsnorm(x, p.norm1)
    out, cache = attn.attention(
        p.attn, xin, cfg, pos.reshape(-1, 1), causal=True, window=block_window(cfg, bt),
        cache=cache, cache_pos=pos, lay=lay, kv_layout=kv,
    )
    return _mlp_after(p, x + out, cfg, lay, ctx=ctx), cache


# ---------------------------------------------------------------------------
# model-level forward passes
# ---------------------------------------------------------------------------
def _layout(params: Transformer, layout: Optional[layers.Layout]) -> layers.Layout:
    return (layout or layers.SINGLE).view(params)


def _embed(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
           lay: layers.Layout = layers.SINGLE, sp: bool = False,
           prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embeddings, after ``prefix`` (B, P, d) where given (a VLM's
    patch embeddings, cast to the compute type); under ``sp`` the rank's
    sequence block of the whole."""
    if prefix is None:
        return layers.embed_tokens(lay, params.embed, tokens, compute_dtype(cfg), sp)
    from repro_torch.distributed import collectives

    x = layers.embed_tokens(lay, params.embed, tokens, compute_dtype(cfg), False)
    x = torch.cat([prefix.to(device=x.device, dtype=x.dtype), x], dim=1)
    return collectives.split(lay.tp, x, 1) if sp else x


def _prefix_len(prefix: Optional[torch.Tensor]) -> int:
    return 0 if prefix is None else prefix.shape[1]


def _head(params: Transformer, x: torch.Tensor, cfg: ArchConfig,
          lay: layers.Layout = layers.SINGLE) -> torch.Tensor:
    """Logits over the whole vocab: the head is column-parallel over a mesh
    (``lm_head``, or the vocab-parallel ``embed`` when tied) and the blocks
    are all-gathered over tp."""
    from repro_torch.distributed import collectives

    xf = layers.rmsnorm(x, params.final_norm)
    if cfg.tie_embeddings:
        w, (lo, hi, n) = lay.w(params.embed).T, lay.rows(params.embed)
    else:
        w, (lo, hi, n) = lay.w(params.lm_head), lay.cols(params.lm_head)
    if (lo, hi) == (0, n):
        return xf @ w.to(xf.dtype)
    logits = collectives.enter_sharded(lay.tp, xf) @ w.to(xf.dtype)
    return collectives.gather_whole(lay.tp, logits, -1)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _period_train(period: Period, x, positions, cfg: ArchConfig, lay: layers.Layout, sp: bool,
                  ctx: Optional[moe.Context] = None):
    with lay.gathered(period):
        for j, bt in enumerate(cfg.block_pattern):
            x = apply_block_train(bt, getattr(period, f"b{j}"), x, positions, cfg, lay, sp, ctx)
    return x


def _trunk(params: Transformer, inputs: torch.Tensor, cfg: ArchConfig, lay: layers.Layout,
           sp: bool, remat: bool, ctx: Optional[moe.Context] = None,
           prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The residual stream after the last period for ``inputs`` (the rank's
    rows; its sequence block under ``sp``) after ``prefix`` (the rank's rows
    of the patch embeddings, or None), whole along the sequence; the MoE
    layers record their aux in ``ctx``."""
    from repro_torch.distributed import collectives

    b, s = inputs.shape
    x = _embed(params, inputs, cfg, lay, sp, prefix)
    positions = _positions(b, s + _prefix_len(prefix), x.device)
    remat = remat and torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters())
    for period in params.layers:
        if remat:  # the FSDP gather runs again in the recomputation
            x = checkpoint(_period_train, period, x, positions, cfg, lay, sp, ctx,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _period_train(period, x, positions, cfg, lay, sp, ctx)
    return collectives.gather_whole(lay.tp, x, 1) if sp else x


def forward_train(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
                  layout: Optional[layers.Layout] = None, remat: bool = True,
                  prefix_emb: Optional[torch.Tensor] = None):
    """Full teacher-forced pass.  tokens (B, S+1) → (logits (B,S,V), aux).
    ``prefix_emb`` (B, P, d): a VLM's patch embeddings before the tokens;
    the logits are the tokens' alone.

    ``aux`` is the reference's MoE load-balance term averaged over the
    layers (each layer's over the whole batch; under expert parallelism the
    mean of the ep ranks' own, as the reference's ``pmean``), 0 for dense
    stacks.  Over a mesh (``layout``) every rank returns the whole logits.

    Differentiable: gradients reach every parameter that requires one
    (:func:`trainable_params`; each matrix is cast to the compute type at
    its use), over a mesh too (the collectives carry gradients).  While
    autograd records, ``remat`` (the reference's ``parallel.remat``, on by
    default) runs each period under one ``torch.utils.checkpoint``: its
    activations, and over a mesh its FSDP gather, are recomputed in the
    backward pass, kernels included."""
    check_supported(cfg)
    lay = _layout(params, layout)
    p_len = _prefix_len(prefix_emb)
    batch_sharded, sp = lay.act(cfg, (tokens.shape[0], p_len + tokens.shape[1] - 1))
    ctx = moe.Context(batch_sharded, moe.AuxParts(cfg.num_experts))
    prefix = None if prefix_emb is None else lay.batch_rows(prefix_emb, batch_sharded)
    x = _trunk(params, lay.batch_rows(tokens[:, :-1], batch_sharded), cfg, lay, sp, remat, ctx,
               prefix)
    logits = lay.gather_batch(_head(params, x[:, p_len:], cfg, lay), batch_sharded)
    aux, _ = ctx.aux.finish(lay, x.device)
    return logits, aux / cfg.num_layers


def loss_fn(params: Transformer, batch: dict, cfg: ArchConfig,
            layout: Optional[layers.Layout] = None, aux_coef: float = 0.01,
            remat: bool = True):
    """Next-token CE + ``aux_coef`` times the MoE load-balance aux (0 for
    dense stacks) of ``batch["tokens"]`` (B, S+1) after
    ``batch.get("patch_emb")`` (a VLM's prefix).  Returns ``(loss, {"loss",
    "ce", "moe_aux", "ce_rows"})``, f32 scalars, and for an MoE stack also
    ``"moe_dropped"``: the (token, expert) rows each EP layer dropped, summed
    over the ep ranks (int64, one a layer that took EP; empty otherwise).

    Over a mesh with dp > 1 each rank takes its rows of the batch (they must
    divide over dp, ``ValueError`` otherwise), and ``ce`` is the mean over
    the whole batch: each rank's mean (``ce_rows``) summed over dp and
    divided by its size (the sum's gradient passes through), the same bits
    on every rank."""
    from repro_torch.distributed import collectives

    check_supported(cfg)
    tokens, prefix = batch["tokens"], batch.get("patch_emb")
    lay = _layout(params, layout)
    p_len = _prefix_len(prefix)
    batch_sharded, sp = lay.act(cfg, (tokens.shape[0], p_len + tokens.shape[1] - 1))
    if lay.dp.size > 1 and not batch_sharded:
        raise ValueError(f"a loss over a mesh takes rows that divide over dp: {tokens.shape[0]} "
                         f"rows over {lay.dp.size} ranks")
    rows = lay.batch_rows(tokens, batch_sharded)
    if prefix is not None:
        prefix = lay.batch_rows(prefix, batch_sharded)
    ctx = moe.Context(batch_sharded, moe.AuxParts(cfg.num_experts))
    x = _trunk(params, rows[:, :-1], cfg, lay, sp, remat, ctx, prefix)
    logits = _head(params, x[:, p_len:], cfg, lay)
    mine = layers.softmax_cross_entropy_logits(logits, rows[:, 1:])
    ce = collectives.sum_partials(lay.dp, mine) / lay.dp.size
    aux, dropped = ctx.aux.finish(lay, ce.device)
    aux = aux / cfg.num_layers
    loss = ce + aux_coef * aux
    metrics = {"loss": loss, "ce": ce, "moe_aux": aux, "ce_rows": mine}
    if cfg.is_moe:
        metrics["moe_dropped"] = dropped
    return loss, metrics


@torch.no_grad()
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
            cache_len: Optional[int] = None, layout: Optional[layers.Layout] = None,
            prefix_emb: Optional[torch.Tensor] = None):
    """Process the prompt, return (last-token logits (B, V), caches).

    ``cache_len`` sizes the decode KV caches (≥ the processed length:
    ``prefix_emb``'s P patch embeddings, a VLM's, and then the prompt; the
    next token's position is P + L).  Over a mesh (``layout``) the logits
    are whole on every rank (the same bits) and the caches are the rank's
    blocks, as :class:`Caches`; the residual stream is sequence-sharded
    where ``layout.act`` says."""
    check_supported(cfg)
    lay = _layout(params, layout)
    b_full, s = tokens.shape[0], _prefix_len(prefix_emb) + tokens.shape[1]
    batch_sharded, sp = lay.act(cfg, (b_full, s))
    tokens = lay.batch_rows(tokens, batch_sharded)
    if prefix_emb is not None:
        prefix_emb = lay.batch_rows(prefix_emb, batch_sharded)
    b = tokens.shape[0]
    x = _embed(params, tokens, cfg, lay, sp, prefix_emb)
    cache_len = max(cache_len or s, s)
    specs, slots = cache_specs(cfg, b_full, cache_len, lay) if lay.sharded else (None, None)
    positions = _positions(b, s, x.device)
    ctx = moe.Context(batch_sharded)
    per_block = {f"b{j}": [] for j, _ in enumerate(cfg.block_pattern)}
    for period in params.layers:
        with lay.gathered(period):
            for j, bt in enumerate(cfg.block_pattern):
                kv = kv_layout(lay, specs[f"b{j}"][0]) if specs else None
                x, c = apply_block_prefill(bt, getattr(period, f"b{j}"), x, positions, cfg,
                                           cache_len, lay, sp, kv, ctx)
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
    ctx = moe.Context(batch_sharded)
    for i, period in enumerate(params.layers):
        with lay.gathered(period):
            for j, bt in enumerate(cfg.block_pattern):
                c = caches[f"b{j}"]
                kv = kv_layout(lay, specs[f"b{j}"][0]) if specs else None
                x, _ = apply_block_decode(
                    bt, getattr(period, f"b{j}"), x, type(c)(*(t[i] for t in c)), pos, cfg,
                    lay, kv, ctx,
                )
    logits = lay.gather_batch(_head(params, x, cfg, lay)[:, 0], batch_sharded)
    return logits, caches


def loss_ep_stacked(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
                    shards: int, aux_coef: float = 0.01) -> dict:
    """The stacked twin of :func:`loss_fn` under expert parallelism over
    ``shards`` dp ranks (``moe_impl="ep"`` on a ``(shards, 1)`` mesh), on one
    device: shard ``i`` takes its rows of ``tokens`` (B, S+1), runs every
    block but the MoE on them alone, as its rank would, and the MoE layers
    exchange over ``StackedGroup(shards)``.  Returns per shard the row CE
    (``ce_rows``), its loss (``ce_rows + aux_coef · moe_aux``), and the aux
    and drops of the group, as each rank's :func:`loss_fn` gives them, and
    the group's ``loss`` and ``ce`` (the rows' CE summed over the shards over
    their number).  Differentiable where the parameters require gradients
    (the exchange's transposes carry them): the stacked EP train step's
    loss (``train.step.make_ep_stacked_train_step``)."""
    from repro_torch.core import exchange

    check_supported(cfg)
    if tokens.shape[0] % shards:
        raise ValueError(f"{tokens.shape[0]} rows do not divide over {shards} shards")
    group = exchange.StackedGroup(shards)
    rows = tokens.chunk(shards, dim=0)
    xs = [_embed(params, r[:, :-1], cfg) for r in rows]
    b, s, d = xs[0].shape
    positions = _positions(b, s, xs[0].device)
    acc = moe.AuxParts(cfg.num_experts)
    for period in params.layers:
        for j, bt in enumerate(cfg.block_pattern):
            p = getattr(period, f"b{j}")
            xs = [_mix_train(bt, p, x, positions, cfg) for x in xs]
            m = p.mlp.moe
            xin = torch.stack([layers.rmsnorm(x, p.norm2).reshape(b * s, d) for x in xs])
            out, aux, dropped = moe._ep(m.router, moe._stacks(m), xin, cfg, group)
            acc.add_ep(aux, dropped)
            xs = [x + out[i].reshape(b, s, d) for i, x in enumerate(xs)]
    aux, dropped = acc.finish(layers.SINGLE, xs[0].device)
    aux = aux / cfg.num_layers
    ce_rows = torch.stack([layers.softmax_cross_entropy_logits(_head(params, x, cfg), r[:, 1:])
                           for x, r in zip(xs, rows)])
    ce = ce_rows.sum() / shards
    return {"ce_rows": ce_rows, "loss_rows": ce_rows + aux_coef * aux, "moe_aux": aux,
            "moe_dropped": dropped, "ce": ce, "loss": ce + aux_coef * aux}
