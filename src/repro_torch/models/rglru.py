"""RG-LRU / Griffin recurrent block (port of ``repro.models.rglru``).

Block: x → {gate branch: linear → tanh-GELU} ⊗ {rec branch: linear → causal
depthwise conv (width ``conv_width``) → RG-LRU} → linear out (+ residual).

RG-LRU (Real-Gated Linear Recurrent Unit):
    r_t = σ(W_a u_t + b_a)                    (recurrence gate)
    i_t = σ(W_x u_t + b_x)                    (input gate)
    a_t = exp(-c · softplus(Λ) · r_t),  c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(max(1 - a_t², 1e-12)) ⊙ (i_t ⊙ u_t)

As in the reference, the conv runs in the activation's type (``conv_w`` cast
to it, taps summed in the order ``i = 0 .. cw-1``), the gates' products
``W_a`` / ``W_x`` and the recurrence in f32 on the widened ``u`` (the port
leaves ``torch.backends.cuda.matmul.allow_tf32`` at its default, off, so
these are f32 products as the reference's), and ``h`` is kept in f32.

The reference scans the recurrence with ``jax.lax.associative_scan``; the
port runs :func:`linear_scan`, Hillis–Steele doubling over the sequence on
the pairs ``(a, b)`` in f32: ``ceil(log2 S)`` rounds of a few elementwise
ops, so a 6,144-token prefill costs 13 rounds, not 6,144 steps.  No
``cumsum`` of ``log a``: over thousands of steps its f32 differences lose
the small terms.  Both trees compute the same recurrence; they round in
another order.  There is no Pallas kernel here, so no CUDA kernel either:
the scan is plain tensor code, inside the profiler range :data:`SCAN_RANGE`.

Parameters carry the reference's names (``mixer.w_gate``, ...,
``mixer.lambda``); matrices (``ndim >= 2``, ``conv_w`` included) in the
compute type, as the reference's serving copy rounds them, and the vectors
(``norm``, ``conv_b``, ``b_a``, ``b_x``, ``lambda``) in f32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers

_C = 8.0
# The profiler range around the recurrence's scan (and its decode step).
SCAN_RANGE = "rglru.scan"


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, d_rnn) f32 recurrent state
    conv: torch.Tensor  # (B, conv_width - 1, d_rnn) trailing conv inputs


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class RGLRU(nn.Module):
    """Parameters of one Griffin recurrent block (matrices in ``dtype``,
    vectors f32)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        d, dr, cw = cfg.d_model, cfg.rnn_width, cfg.conv_width
        f32 = torch.float32
        self.norm = _param((d,), f32, device)
        self.w_gate = _param((d, dr), dtype, device)
        self.w_rec = _param((d, dr), dtype, device)
        self.conv_w = _param((cw, dr), dtype, device)
        self.conv_b = _param((dr,), f32, device)
        self.w_a = _param((dr, dr), dtype, device)
        self.b_a = _param((dr,), f32, device)
        self.w_x = _param((dr, dr), dtype, device)
        self.b_x = _param((dr,), f32, device)
        setattr(self, "lambda", _param((dr,), f32, device))
        self.w_out = _param((dr, d), dtype, device)


def init_rglru_param(name: str, t: torch.Tensor, cfg: ArchConfig,
                     generator: torch.Generator) -> bool:
    """Fill ``t`` in place where the reference's ``init_rglru`` has its own
    rule for leaf ``name`` and return True: ``conv_w`` a plain normal over
    ``sqrt(conv_width)``, the biases zeros, ``lambda`` = softplus⁻¹(-log(u)
    / c) for ``u ~ U(0.9, 0.999)`` (so ``a`` lies in (0.9, 0.999) at r = 1).
    Other leaves (the norm, the dense matrices) take the common rule."""
    leaf = name.rpartition(".")[2]
    with torch.no_grad():
        if leaf == "conv_w":
            draw = torch.randn(t.shape, generator=generator, dtype=torch.float32, device=t.device)
            t.copy_(draw.div_(math.sqrt(float(cfg.conv_width))))
        elif leaf in ("conv_b", "b_a", "b_x"):
            t.zero_()
        elif leaf == "lambda":
            u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
            u.uniform_(0.9, 0.999, generator=generator)
            t.copy_(torch.log(torch.expm1(-torch.log(u) / _C)))
        else:
            return False
    return True


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          prev: Optional[torch.Tensor] = None):
    """x (B, S, d), w (cw, d) → (out (B, S, d), tail (B, cw-1, d)), both in
    x's type.  ``prev`` (B, cw-1, d) carries the decode history (zeros when
    None); the taps are summed in the order i = 0 .. cw-1."""
    cw = w.shape[0]
    bsz, s, d = x.shape
    if prev is None:
        prev = torch.zeros((bsz, cw - 1, d), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)  # (B, S+cw-1, d)
    wt = w.to(x.dtype)
    out = xp[:, 0:s] * wt[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * wt[i]
    tail = xp[:, xp.shape[1] - (cw - 1):] if cw > 1 else torch.zeros_like(prev)
    return out + b.to(x.dtype), tail


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` over dim 1 of a/b (B, S, d) from h0
    (B, d), all f32: h0 is folded into step 0, then Hillis–Steele doubling,
    each round combining every position with the one ``step`` before it,
    ``(a_l, b_l) ∘ (a_r, b_r) = (a_l a_r, a_r b_l + b_r)``."""
    b = b.clone()
    b[:, 0] += a[:, 0] * h0
    s = a.shape[1]
    step = 1
    while step < s:
        a_r, b_r = a[:, step:], b[:, step:]
        b = torch.cat([b[:, :step], torch.addcmul(b_r, a_r, b[:, :s - step])], dim=1)
        if step * 2 < s:  # the last round needs no products of a
            a = torch.cat([a[:, :step], a_r * a[:, :s - step]], dim=1)
        step *= 2
    return b


def rglru_block(p: RGLRU, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[RGLRUState] = None, *, return_state: bool = False,
                lay: layers.Layout = layers.SINGLE, sp: bool = False):
    """Griffin recurrent residual block: x (B, S, d) → (out, new state or
    None).  ``state`` carries h and the conv tail of earlier tokens.

    Over a mesh (``lay``) the block follows the reference's rules:
    ``w_gate`` / ``w_rec`` / ``w_a`` / ``w_x`` column-parallel and ``w_out``
    row-parallel over tp, so a rank holds a block of ``rnn_width``.  It
    takes that block of the vectors every rank holds whole (``conv_w``,
    ``conv_b``, ``lambda``, ``b_a``, ``b_x``), gathers ``uf`` over tp (in
    f32) for the gates' products, whose contraction runs over the whole
    width, and scans its own block over the whole sequence (never split by
    sequence); ``w_out``'s partial sums are summed over tp (reduce-scattered
    along the sequence under ``sp``, whose input is gathered first).  The
    state (``h``, ``conv``) is the rank's width block, as
    ``sharding.cache_leaf_spec`` splits it."""
    bsz = x.shape[0]
    dtype = x.dtype
    c0, c1, n = lay.cols(p.w_rec)
    partial = (c0, c1) != (0, n)
    xin = lay.tp_input(layers.rmsnorm(x, lay.tp_shared(p.norm, sp)), sp, partial)
    s = xin.shape[1]

    def mine(v):  # the rank's width block of a vector every rank holds whole
        return lay.tp_shared(v, partial)[..., c0:c1]

    gate = F.gelu(xin @ lay.w(p.w_gate).to(dtype), approximate="tanh")
    u = xin @ lay.w(p.w_rec).to(dtype)
    prev = state.conv if state is not None else None
    u, conv_tail = causal_depthwise_conv(u, mine(p.conv_w), mine(p.conv_b), prev)

    uf = u.float()
    (whole,) = layers.take_cols(lay, [(uf, (c0, c1, n), (0, n))])
    r = torch.sigmoid(whole @ lay.w(p.w_a).float() + mine(p.b_a))
    i = torch.sigmoid(whole @ lay.w(p.w_x).float() + mine(p.b_x))
    lam = mine(getattr(p, "lambda"))
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    a = torch.exp(-_C * softplus * r)
    bterm = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    h0 = state.h if state is not None else torch.zeros((bsz, c1 - c0), dtype=torch.float32,
                                                       device=x.device)
    with torch.profiler.record_function(SCAN_RANGE):
        if s == 1:  # decode: one step, no scan
            h = (a[:, 0] * h0 + bterm[:, 0])[:, None, :]
        else:
            h = linear_scan(a, bterm, h0)
    out = (h.to(dtype) * gate) @ lay.w(p.w_out).to(dtype)
    out = x + layers.reduce_rows(lay, out, partial, sp)
    new_state = RGLRUState(h=h[:, -1], conv=conv_tail) if return_state else None
    return out, new_state


def rglru_decode_step(p: RGLRU, x: torch.Tensor, cfg: ArchConfig, state: RGLRUState,
                      lay: layers.Layout = layers.SINGLE):
    """One token (x (B, 1, d)) from ``state``: (out, new state)."""
    return rglru_block(p, x, cfg, state, return_state=True, lay=lay)


def rglru_state_shapes(cfg: ArchConfig, batch: int) -> RGLRUState:
    return RGLRUState((batch, cfg.rnn_width), (batch, cfg.conv_width - 1, cfg.rnn_width))


def rglru_init_state(cfg: ArchConfig, batch: int, device=None) -> RGLRUState:
    """Zero h (B, d_rnn) and conv tail (B, cw-1, d_rnn), both f32 (the
    prefill's tail is in the activation's type; a slot write casts it)."""
    return RGLRUState(*(torch.zeros(sh, dtype=torch.float32, device=device)
                        for sh in rglru_state_shapes(cfg, batch)))
