"""xLSTM blocks: chunkwise-parallel mLSTM and recurrent sLSTM (port of
``repro.models.ssm``).

mLSTM (matrix LSTM) keeps a per-head matrix state
``C_t = f_t·C_{t-1} + i_t·v_t k_tᵀ`` with read-out
``h_t = (C_t q_t) / max(|n_t·q_t|, 1)``, in the reference's exact chunkwise
factorisation: within a chunk of Q tokens a decay-weighted causal
attention, across chunks only the (dk × dv) state is carried.  Sigmoid
input and forget gates, as in the reference.  It has no kernel: its
products are ``torch.matmul``/``einsum`` and the reference's ``lax.scan``
over chunks is a loop.

sLSTM has recurrent state feedback (h_{t-1} enters the gates) with per-head
block-diagonal recurrent weights.  The reference's block runs a
``lax.scan`` of :func:`_slstm_step`; the port's block runs the recurrence
through kernel 7 (``kernels/slstm.py``: the CUDA kernel on the card, its
plain twin on the CPU), as the reference's kernel test wires it: the bias
is folded into the input projection (``pre = x·W_in + b``, then
``pre + h·r``), where the scan adds it last (``(x·W_in + h·r) + b``).
:func:`_slstm_step` stays as the per-step oracle of that wiring.

Modules carry the reference's parameter names: ``mixer.w_up``, ...,
``mixer.r`` (H, 4, hd, hd) in the compute type (the reference's serving
copy rounds it to bf16 too), ``mixer.b`` (4d,) f32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import slstm as kslstm
from repro_torch.models import layers

NEG_INIT_M = -1e30  # the sLSTM stabiliser's initial value


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dk, dv)
    n: torch.Tensor  # (B, H, dk)


def mlstm_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    d_inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    h = cfg.num_heads
    dv = d_inner // h
    dk = max(16, dv // 2)
    return h, dk, dv


class MLSTM(nn.Module):
    """Parameters of one mLSTM block (matrices in ``dtype``, norms f32)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        h, dk, dv = mlstm_dims(cfg)
        d_inner = h * dv
        self.norm = _param((d,), torch.float32, device)
        self.w_up = _param((d, d_inner), dtype, device)
        self.w_gate = _param((d, d_inner), dtype, device)
        self.wq = _param((d_inner, h * dk), dtype, device)
        self.wk = _param((d_inner, h * dk), dtype, device)
        self.wv = _param((d_inner, h * dv), dtype, device)
        self.w_if = _param((d_inner, 2 * h), dtype, device)  # input + forget gates
        self.out_norm = _param((d_inner,), torch.float32, device)
        self.w_down = _param((d_inner, d), dtype, device)


def _mlstm_chunk(q, k, v, log_f, i_gate, state: MLSTMState):
    """Exact chunkwise mLSTM over one chunk.

    q/k: (B,H,Q,dk), v: (B,H,Q,dv), log_f/i_gate: (B,H,Q).
    Returns (h (B,H,Q,dv), new_state).
    """
    bq = q.shape[2]
    # cumulative decay within the chunk: F_t = Π_{u<=t} f_u
    cum = torch.cumsum(log_f, dim=-1)  # (B,H,Q) = log F_t
    total = cum[..., -1]
    # inter-chunk: contribution of the carried state, decayed to each position.
    decay_to_t = torch.exp(cum)[..., None]  # (B,H,Q,1)
    h_inter = (q @ state.c) * decay_to_t
    n_inter = torch.einsum("bhqk,bhk->bhq", q, state.n) * decay_to_t[..., 0]
    # intra-chunk: decay-weighted causal attention.
    # ratio[t,s] = exp(logF_t - logF_s) for s <= t  (in (0,1], stable).  The
    # exponent is masked before exp: above the diagonal it can overflow to
    # inf, and the masked inf would make the gradient 0 * inf = NaN (the
    # reference exponentiates first; its forward values are the same).
    causal = torch.ones((bq, bq), dtype=torch.bool, device=q.device).tril()
    ratio = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :], -torch.inf))
    gate = torch.where(causal, ratio * i_gate[..., None, :], 0.0)
    scores = (q @ k.transpose(-1, -2)) * gate
    h_intra = scores @ v
    # normaliser q_t·n_t = Σ_{s<=t} ratio·i_s·(q_t·k_s) — exactly Σ_s scores.
    qn = scores.sum(dim=-1) + n_inter  # (B,H,Q)
    denom = torch.clamp(qn.abs(), min=1.0)[..., None]
    h = (h_intra + h_inter) / denom
    # state update: C' = F_Q·C + Σ_s (F_Q/F_s) i_s k_s v_sᵀ
    carry_decay = torch.exp(total)[..., None, None]
    tail = torch.exp(total[..., None] - cum) * i_gate  # (B,H,Q)
    kt = k * tail[..., None]
    c_new = state.c * carry_decay + kt.transpose(-1, -2) @ v
    n_new = state.n * carry_decay[..., 0] + kt.sum(dim=2)
    return h, MLSTMState(c_new, n_new)


def _rank_heads(lay: layers.Layout, have: tuple, n_heads: int, width: int) -> tuple[int, int]:
    """The heads ``[h0, h1)`` a rank runs: those of a tp block ``have = (lo,
    hi, n)`` of a head-major dim (``width`` entries a head) when it holds
    whole heads; else every head."""
    lo, hi, n = have
    if (lo, hi) == (0, n) or lo % width or hi % width:
        return 0, n_heads
    return lo // width, hi // width


def state_tp_dims(lay: layers.Layout, cfg: ArchConfig, bt: str) -> tuple:
    """For each field of a block's state, the dim of its per-layer ``(B,
    ...)`` tensor that the cache spec (``sharding.cache_leaf_spec``) puts on
    tp, or None."""
    n_fields = 2 if bt == "mlstm" else 4
    if lay.tp.size == 1:
        return (None,) * n_fields
    from repro_torch.distributed import sharding

    if bt == "mlstm":
        h, dk, dv = mlstm_dims(cfg)
        shapes = ((1, 1, h, dk, dv), (1, 1, h, dk))
    else:
        shapes = ((1, 1, cfg.d_model),) * 4
    out = []
    for shape in shapes:
        spec = sharding.cache_leaf_spec(shape, lay.parallel)
        dims = [i - 1 for i, e in enumerate(spec) if e is not None and e == lay.parallel.tp_axis]
        out.append(dims[0] if dims else None)
    return tuple(out)


def mlstm_block(
    p: MLSTM,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[MLSTMState] = None,
    *,
    chunk: int = 256,
    return_state: bool = False,
    lay: layers.Layout = layers.SINGLE,
):
    """Full mLSTM residual block. x (B,S,d) → (out, new_state or None).

    Over a mesh a rank runs the heads of its tp block of ``wq``: ``u`` and
    the gate pre-activations are gathered over tp (their blocks do not line
    up with the heads), ``out_norm`` takes its mean over tp and ``w_down``
    is row-parallel; ``state`` and the returned state are the rank's cache
    spec blocks (``state_tp_dims``)."""
    b, s, d = x.shape
    h, dk, dv = mlstm_dims(cfg)
    d_inner = h * dv
    dtype = x.dtype
    h0, h1 = _rank_heads(lay, lay.cols(p.wq), h, dk)
    hl = h1 - h0
    tp_c, tp_n = state_tp_dims(lay, cfg, "mlstm")
    r0, r1, _ = lay.rows(p.w_down)
    partial = (r0, r1) != (0, d_inner)
    xin = lay.tp_input(layers.rmsnorm(x, p.norm), False, partial)
    z = F.silu(xin @ lay.w(p.w_gate).to(dtype))
    (u,) = layers.take_cols(lay, [(xin @ lay.w(p.w_up).to(dtype), lay.cols(p.w_up), (0, d_inner))])
    q, k, v, gates = layers.take_cols(lay, [
        (u @ lay.w(p.wq).to(dtype), lay.cols(p.wq), (h0 * dk, h1 * dk)),
        (u @ lay.w(p.wk).to(dtype), lay.cols(p.wk), (h0 * dk, h1 * dk)),
        (u @ lay.w(p.wv).to(dtype), lay.cols(p.wv), (h0 * dv, h1 * dv)),
        (u @ lay.w(p.w_if).to(dtype), lay.cols(p.w_if), (0, 2 * h)),
    ])
    q = q.reshape(b, s, hl, dk)
    # the reference divides by sqrt(dk) rounded to the compute type
    k = k.reshape(b, s, hl, dk) / torch.tensor(
        math.sqrt(dk), dtype=torch.float32).to(dtype)
    v = v.reshape(b, s, hl, dv)
    gates = gates.reshape(b, s, 2, h)[..., h0:h1]
    i_gate = torch.sigmoid(gates[:, :, 0].float())  # (B,S,H)
    f_gate = torch.sigmoid(gates[:, :, 1].float())
    log_f = torch.log(torch.clamp(f_gate, min=1e-6))

    # (B,H,S,*) layout, f32 recurrence internals
    qt = q.transpose(1, 2).float()
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    ig = i_gate.transpose(1, 2)
    lf = log_f.transpose(1, 2)

    if state is None:
        state = MLSTMState(
            c=torch.zeros((b, hl, dk, dv), dtype=torch.float32, device=x.device),
            n=torch.zeros((b, hl, dk), dtype=torch.float32, device=x.device),
        )
    else:
        state = MLSTMState(layers.from_block(lay, state.c, tp_c, 1, (h0, h1)),
                           layers.from_block(lay, state.n, tp_n, 1, (h0, h1)))

    chunk = min(chunk, s)
    if s % chunk:
        # zero padding: i = 0 and log f = 0 there, so the carried state is unchanged
        pad = chunk - s % chunk
        qt, kt, vt = (F.pad(t, (0, 0, 0, pad)) for t in (qt, kt, vt))
        ig, lf = (F.pad(t, (0, pad)) for t in (ig, lf))
    outs = []
    for c0 in range(0, qt.shape[2], chunk):
        sl = slice(c0, c0 + chunk)
        hc, state = _mlstm_chunk(qt[:, :, sl], kt[:, :, sl], vt[:, :, sl], lf[:, :, sl],
                                 ig[:, :, sl], state)
        outs.append(hc)
    hs = torch.cat(outs, dim=2)[:, :, :s]
    hs = hs.transpose(1, 2).reshape(b, s, hl * dv).to(dtype)
    have = (h0 * dv, h1 * dv, d_inner)
    (z,) = layers.take_cols(lay, [(z, lay.cols(p.w_gate), have[:2])])
    hs = layers.rmsnorm_cols(lay, hs, p.out_norm, have, partial=partial) * z
    (hs,) = layers.take_cols(lay, [(hs, have, (r0, r1))])
    out = layers.reduce_rows(lay, hs @ lay.w(p.w_down).to(dtype), partial, False)
    if not return_state:
        return x + out, None
    hv = (h0, h1, h)
    return x + out, MLSTMState(layers.to_block(lay, state.c, 1, hv, tp_c),
                               layers.to_block(lay, state.n, 1, hv, tp_n))


def mlstm_decode_step(p: MLSTM, x, cfg: ArchConfig, state: MLSTMState,
                      lay: layers.Layout = layers.SINGLE):
    """Single-token mLSTM step. x (B,1,d)."""
    return mlstm_block(p, x, cfg, state, chunk=1, return_state=True, lay=lay)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d) stabiliser


class SLSTM(nn.Module):
    """Parameters of one sLSTM block: ``w_in`` (d, 4d), ``r`` (H, 4, hd, hd)
    and ``w_down`` (d, d) in ``dtype``; ``b`` (4d,) and the norms f32."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        hd = d // h
        self.norm = _param((d,), torch.float32, device)
        self.w_in = _param((d, 4 * d), dtype, device)  # input projections of gates i, f, z, o
        self.r = _param((h, 4, hd, hd), dtype, device)  # block-diagonal recurrent weights
        self.b = _param((4 * d,), torch.float32, device)
        self.out_norm = _param((d,), torch.float32, device)
        self.w_down = _param((d, d), dtype, device)


def slstm_init_state(cfg: ArchConfig, batch: int, device) -> SLSTMState:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMState(z, z.clone(), z.clone(), torch.full_like(z, NEG_INIT_M))


def _slstm_step(p: SLSTM, cfg: ArchConfig, xt: torch.Tensor, st: SLSTMState):
    """One sLSTM timestep as the reference's scan takes it.  xt: (B, 4d)
    preprojected input contribution (without the bias)."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    b = xt.shape[0]
    # recurrent contribution: per-head block-diagonal matmul of h_{t-1}
    hprev = st.h.reshape(b, h, hd)
    rec = torch.einsum("bhd,hgde->bhge", hprev, p.r.float())  # (B,H,4,hd)
    rec = rec.transpose(1, 2).reshape(b, 4 * d)
    pre = xt + rec + p.b
    itil, ftil, ztil, otil = torch.chunk(pre, 4, dim=-1)
    # exponential gating with stabiliser (paper eq. sLSTM)
    m_new = torch.maximum(ftil + st.m, itil)
    i = torch.exp(itil - m_new)
    f = torch.exp(ftil + st.m - m_new)
    z = torch.tanh(ztil)
    o = torch.sigmoid(otil)
    c = f * st.c + i * z
    n = f * st.n + i
    hnew = o * c / torch.clamp(n, min=1.0)
    return hnew, SLSTMState(c, n, hnew, m_new)


def slstm_block(
    p: SLSTM,
    x: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[SLSTMState] = None,
    *,
    return_state: bool = False,
    lay: layers.Layout = layers.SINGLE,
):
    """Recurrent sLSTM residual block. x (B,S,d) → (out, new_state or None).

    The recurrence is one call of kernel 7 over the whole sequence; its
    input is the projection viewed as ``(B, H, S, 4, hd)`` (no copy) and its
    ``hs`` comes back in the ``(B, S, d)`` layout.

    Over a mesh a rank runs the heads of its tp block of ``w_down``'s rows:
    ``w_in``'s column block is one gate of every head (gate-major, i | f | z
    | o), so the projection is gathered over tp and kernel 7 takes the
    rank's heads of it; ``out_norm`` takes its mean over tp and ``w_down`` is
    row-parallel; states are the rank's cache spec blocks."""
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    dtype = x.dtype
    r0, r1, _ = lay.rows(p.w_down)
    partial = (r0, r1) != (0, d)
    h0, h1 = _rank_heads(lay, (r0, r1, d), h, hd)
    hl = h1 - h0
    tp_dims = state_tp_dims(lay, cfg, "slstm")
    xin = lay.tp_input(layers.rmsnorm(x, p.norm), False, partial)
    (proj,) = layers.take_cols(lay, [(xin @ lay.w(p.w_in).to(dtype), lay.cols(p.w_in),
                                      (0, 4 * d))])
    pre = proj.float() + lay.tp_shared(p.b, partial)  # (B,S,4d)
    if state is None:
        state = slstm_init_state(cfg, b, x.device)
        if hl != h:
            state = SLSTMState(*(t[:, h0 * hd:h1 * hd] for t in state))
    else:
        state = SLSTMState(*(layers.from_block(lay, t, dim, 1, (h0 * hd, h1 * hd))
                             for t, dim in zip(state, tp_dims)))
    pre5 = pre.view(b, s, 4, h, hd).permute(0, 3, 1, 2, 4)[:, h0:h1]  # (B,H',S,4,hd)
    hs, *finals = kslstm.SlstmSequence.apply(pre5, lay.tp_shared(p.r, partial)[h0:h1],
                                             *(t.reshape(b, hl, hd).contiguous() for t in state))
    hs = hs.permute(0, 2, 1, 3).reshape(b, s, hl * hd).to(dtype)  # (B,S,d')
    have = (h0 * hd, h1 * hd, d)
    hs = layers.rmsnorm_cols(lay, hs, p.out_norm, have, partial=partial)
    (hs,) = layers.take_cols(lay, [(hs, have, (r0, r1))])
    out = layers.reduce_rows(lay, hs @ lay.w(p.w_down).to(dtype), partial, False)
    if not return_state:
        return x + out, None
    new = SLSTMState(*(layers.to_block(lay, t.reshape(b, hl * hd), 1, have, dim)
                       for t, dim in zip(finals, tp_dims)))
    return x + out, new


def slstm_decode_step(p: SLSTM, x, cfg: ArchConfig, state: SLSTMState,
                      lay: layers.Layout = layers.SINGLE):
    return slstm_block(p, x, cfg, state, return_state=True, lay=lay)
