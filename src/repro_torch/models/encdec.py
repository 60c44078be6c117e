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
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
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
                dtype: Optional[torch.dtype] = None) -> EncoderDecoder:
    """Random parameters by the reference's rule on ``device`` from
    ``generator``: every matrix truncated-normal with std ``1 / sqrt(fan_in)``
    (the embedding's fan-in its vocab axis), norms ones, the MLPs' biases
    zeros; matrices in ``dtype`` (default: the compute type).  The draws
    differ from ``jax.random``'s for the same seed."""
    model = EncoderDecoder(cfg, dtype=dtype or compute_dtype(cfg), device=device)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if t.ndim >= 2:
                layers.truncated_normal_(t, 1.0, generator)
            elif name.rpartition(".")[2] in ("b_in", "b_out"):
                t.zero_()
            else:
                t.fill_(1.0)
    return model


def _mlp(m: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    return layers.gelu_mlp(x, m.w_in, m.b_in, m.w_out, m.b_out)


def _embed(params: EncoderDecoder, tokens: torch.Tensor, cfg: ArchConfig,
           pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings plus sinusoidal positions (0..S-1, or ``pos`` (B,)
    for one decode token), added in the compute type."""
    x = params.embed[tokens.to(torch.long)].to(compute_dtype(cfg))
    if pos is None:
        pe = layers.sinusoidal_positions(x.shape[1], cfg.d_model, device=x.device)
    else:
        pe = layers.sinusoidal_at(pos, cfg.d_model)[:, None, :]
    return x + pe.to(x.dtype)


def _logits(params: EncoderDecoder, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(x, params.dec_norm)
    return x @ params.embed.T.to(x.dtype)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def encode(params: EncoderDecoder, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames (B, T, d), the stub frontend's embeddings → (B, T, d)."""
    _, t, d = frames.shape
    dt = compute_dtype(cfg)
    x = frames.to(dt) + layers.sinusoidal_positions(t, d, device=frames.device).to(dt)
    for p in params.enc_layers:
        out, _ = attn.attention(p.attn, layers.rmsnorm(x, p.norm1), cfg, None, causal=False)
        x = x + out
        x = x + _mlp(p.mlp, layers.rmsnorm(x, p.norm2))
    return layers.rmsnorm(x, params.enc_norm)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def _dec_rest(p: DecLayer, x: torch.Tensor, cfg: ArchConfig, ek: torch.Tensor,
              ev: torch.Tensor) -> torch.Tensor:
    """A decoder layer after its self-attention: cross-attention, then the MLP."""
    x = x + attn.cross_attention(p.cross_attn, layers.rmsnorm(x, p.norm_x), cfg, ek, ev)
    return x + _mlp(p.mlp, layers.rmsnorm(x, p.norm2))


def forward_train(params: EncoderDecoder, tokens: torch.Tensor, frames: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """tokens (B, S+1), frames (B, T, d) → logits (B, S, V).  Differentiable."""
    enc_out = encode(params, frames, cfg)
    x = _embed(params, tokens[:, :-1], cfg)
    for p in params.dec_layers:
        out, _ = attn.attention(p.self_attn, layers.rmsnorm(x, p.norm1), cfg, None, causal=True)
        ek, ev = attn.encoder_kv(p.cross_attn, enc_out, cfg)
        x = _dec_rest(p, x + out, cfg, ek, ev)
    return _logits(params, x)


def loss_fn(params: EncoderDecoder, batch: dict, cfg: ArchConfig):
    """Next-token CE of ``batch["tokens"]`` (B, S+1) given ``batch["frames"]``:
    ``(ce, {"loss", "ce", "moe_aux" (0), "ce_rows"})``, f32 scalars."""
    logits = forward_train(params, batch["tokens"], batch["frames"], cfg)
    ce = layers.softmax_cross_entropy_logits(logits, batch["tokens"][:, 1:])
    zero = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"loss": ce, "ce": ce, "moe_aux": zero, "ce_rows": ce}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params: EncoderDecoder, tokens: torch.Tensor, frames: torch.Tensor, cfg: ArchConfig,
            cache_len: Optional[int] = None):
    """Encode the frames and consume the prompt tokens (B, S): (last-token
    logits (B, V), caches).  ``cache_len`` (default S) sizes the self caches."""
    enc_out = encode(params, frames, cfg)
    cache_len = cache_len or tokens.shape[1]
    x = _embed(params, tokens, cfg)
    selfs, cks, cvs = [], [], []
    for p in params.dec_layers:
        out, cache = attn.attention(p.self_attn, layers.rmsnorm(x, p.norm1), cfg, None,
                                    causal=True, return_cache=True, cache_len=cache_len)
        ek, ev = attn.encoder_kv(p.cross_attn, enc_out, cfg)
        x = _dec_rest(p, x + out, cfg, ek, ev)
        selfs.append(cache)
        cks.append(ek)
        cvs.append(ev)
    caches = {"self": attn.KVCache(torch.stack([c.k for c in selfs]),
                                   torch.stack([c.v for c in selfs])),
              "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs)}
    return _logits(params, x[:, -1:])[:, 0], caches


@torch.no_grad()
def decode_step(params: EncoderDecoder, caches: dict, token: torch.Tensor, pos: torch.Tensor,
                cfg: ArchConfig):
    """One decode token (B, 1) at positions ``pos`` (B,): (logits (B, V),
    caches), the self caches written in place and returned as given."""
    x = _embed(params, token, cfg, pos)
    self_c = caches["self"]
    for i, p in enumerate(params.dec_layers):
        out, _ = attn.attention(p.self_attn, layers.rmsnorm(x, p.norm1), cfg, None, causal=True,
                                cache=attn.KVCache(self_c.k[i], self_c.v[i]), cache_pos=pos)
        x = _dec_rest(p, x + out, cfg, caches["cross_k"][i], caches["cross_v"][i])
    return _logits(params, x)[:, 0], caches


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device) -> dict:
    """Zero self caches and zero cross k/v, stacked over decoder layers."""
    dt = compute_dtype(cfg)
    hd, kv, n = cfg.head_dim_, cfg.num_kv_heads, cfg.num_layers

    def zeros(length):
        return torch.zeros((n, batch, kv, length, hd), dtype=dt, device=device)

    return {"self": attn.KVCache(zeros(cache_len), zeros(cache_len)),
            "cross_k": zeros(cfg.frontend_len), "cross_v": zeros(cfg.frontend_len)}
