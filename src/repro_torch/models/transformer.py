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
``decode_step`` (one token against the caches, written in place).

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
    cfg: ArchConfig, generator: torch.Generator, *, device, dtype: Optional[torch.dtype] = None
) -> Transformer:
    """Random parameters by the reference's rule, drawn on ``device`` (the
    generator's device) from ``generator``: every matrix truncated-normal
    with std ``1 / sqrt(fan_in)`` (the embedding's fan-in is its vocab axis,
    as in the reference), every norm vector ones; the sLSTM's recurrent
    ``r`` (H, 4, hd, hd) a plain normal over ``sqrt(hd)`` and its bias ``b``
    zeros (``ssm.init_slstm``).  Matrices are stored in ``dtype`` (default:
    the config's compute type), one matrix drawn in f32 at a time.  The
    draws differ from ``jax.random``'s for the same seed."""
    model = Transformer(cfg, dtype=dtype or compute_dtype(cfg), device=device)
    for name, t in model.named_parameters():
        with torch.no_grad():
            if name.endswith(".mixer.r"):
                draw = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                                   device=t.device)
                t.copy_(draw.div_(math.sqrt(t.shape[-1])))
            elif name.endswith(".mixer.b"):
                t.zero_()
            elif t.ndim >= 2:
                layers.truncated_normal_(t, 1.0, generator)
            else:
                t.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_block_cache(cfg: ArchConfig, bt: str, batch: int, cache_len: int, device):
    """One block position's cache for all periods (leading ``num_periods``
    axis): zero KV for ``attn``; for ``mlstm`` zero ``c`` (B, H, dk, dv) and
    ``n`` (B, H, dk) f32; for ``slstm`` zero ``c, n, h`` and ``m = -1e30``,
    (B, d) f32 each."""
    p = cfg.num_periods
    if bt in ATTN_TYPES:
        shape = (p, batch, cfg.num_kv_heads, cache_len, cfg.head_dim_)
        dt = compute_dtype(cfg)
        return attn.KVCache(torch.zeros(shape, dtype=dt, device=device),
                            torch.zeros(shape, dtype=dt, device=device))
    if bt == "mlstm":
        h, dk, dv = ssm.mlstm_dims(cfg)
        return ssm.MLSTMState(
            torch.zeros((p, batch, h, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((p, batch, h, dk), dtype=torch.float32, device=device),
        )
    shape = (p, batch, cfg.d_model)
    return ssm.SLSTMState(
        *(torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(3)),
        torch.full(shape, ssm.NEG_INIT_M, dtype=torch.float32, device=device),
    )


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device) -> dict:
    """Zero caches for all layers: ``{"b<j>": cache}``, each tensor with a
    leading ``num_periods`` axis (``init_block_cache``)."""
    check_supported(cfg)
    return {
        f"b{j}": init_block_cache(cfg, bt, batch, cache_len, device)
        for j, bt in enumerate(cfg.block_pattern)
    }


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------
def _apply_mlp(p: Block, x: torch.Tensor) -> torch.Tensor:
    xin = layers.rmsnorm(x, p.norm2)
    return x + layers.swiglu(xin, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down)


def apply_block_train(bt: str, p, x, positions, cfg: ArchConfig):
    if bt == "mlstm":
        return ssm.mlstm_block(p.mixer, x, cfg)[0]
    if bt == "slstm":
        return ssm.slstm_block(p.mixer, x, cfg)[0]
    xin = layers.rmsnorm(x, p.norm1)
    out, _ = attn.attention(p.attn, xin, cfg, positions, causal=True, window=None)
    return _apply_mlp(p, x + out)


def apply_block_prefill(bt: str, p, x, positions, cfg: ArchConfig, cache_len: int):
    if bt == "mlstm":
        return ssm.mlstm_block(p.mixer, x, cfg, return_state=True)
    if bt == "slstm":
        return ssm.slstm_block(p.mixer, x, cfg, return_state=True)
    xin = layers.rmsnorm(x, p.norm1)
    out, cache = attn.attention(
        p.attn, xin, cfg, positions, causal=True, window=None,
        return_cache=True, cache_len=cache_len,
    )
    return _apply_mlp(p, x + out), cache


def apply_block_decode(bt: str, p, x, cache, pos, cfg: ArchConfig):
    """One token through one block.  An ``attn`` block writes its KV cache
    in place; an xLSTM block copies its new state into ``cache`` (views of
    the batched state)."""
    if bt in XLSTM_TYPES:
        step = ssm.mlstm_decode_step if bt == "mlstm" else ssm.slstm_decode_step
        x, new = step(p.mixer, x, cfg, cache)
        for dst, src in zip(cache, new):
            dst.copy_(src)
        return x, cache
    xin = layers.rmsnorm(x, p.norm1)
    out, cache = attn.attention(
        p.attn, xin, cfg, pos.reshape(-1, 1), causal=True, cache=cache, cache_pos=pos,
    )
    return _apply_mlp(p, x + out), cache


# ---------------------------------------------------------------------------
# model-level forward passes
# ---------------------------------------------------------------------------
def _embed(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return params.embed[tokens.to(torch.long)].to(compute_dtype(cfg))


def _head(params: Transformer, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = layers.rmsnorm(x, params.final_norm)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return xf @ w.to(xf.dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


@torch.no_grad()
def forward_train(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig):
    """Full teacher-forced forward pass.  tokens (B, S+1) → (logits (B,S,V), aux).

    ``aux`` is the reference's MoE load-balance term, 0 for dense stacks."""
    check_supported(cfg)
    x = _embed(params, tokens[:, :-1], cfg)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for period in params.layers:
        for j, bt in enumerate(cfg.block_pattern):
            x = apply_block_train(bt, getattr(period, f"b{j}"), x, positions, cfg)
    logits = _head(params, x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
            cache_len: Optional[int] = None):
    """Process the prompt, return (last-token logits (B, V), caches).

    ``cache_len`` sizes the decode KV caches (≥ prompt length)."""
    check_supported(cfg)
    x = _embed(params, tokens, cfg)
    b, s, _ = x.shape
    cache_len = max(cache_len or s, s)
    positions = _positions(b, s, x.device)
    per_block = {f"b{j}": [] for j, _ in enumerate(cfg.block_pattern)}
    for period in params.layers:
        for j, bt in enumerate(cfg.block_pattern):
            x, c = apply_block_prefill(bt, getattr(period, f"b{j}"), x, positions, cfg, cache_len)
            per_block[f"b{j}"].append(c)
    caches = {
        name: type(cs[0])(*(torch.stack(leaves) for leaves in zip(*cs)))
        for name, cs in per_block.items()
    }
    logits = _head(params, x[:, -1:], cfg)[:, 0]
    return logits, caches


@torch.no_grad()
def decode_step(params: Transformer, caches: dict, token: torch.Tensor, pos: torch.Tensor,
                cfg: ArchConfig):
    """One decode step: token (B, 1), pos (B,) the token's absolute position.

    Returns (logits (B, V), caches); the caches are updated in place and
    returned as given."""
    check_supported(cfg)
    x = _embed(params, token, cfg)
    for i, period in enumerate(params.layers):
        for j, bt in enumerate(cfg.block_pattern):
            c = caches[f"b{j}"]
            x, _ = apply_block_decode(
                bt, getattr(period, f"b{j}"), x, type(c)(*(t[i] for t in c)), pos, cfg
            )
    logits = _head(params, x, cfg)[:, 0]
    return logits, caches
