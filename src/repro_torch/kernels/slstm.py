"""Kernel 7 wrapper: the sLSTM recurrence (``csrc/slstm.cu``).

Replaces the Pallas ``slstm_sequence`` (``repro/kernels/slstm.py``): for
every (b, h) and each step t in order, ``pre_t = pre[b, h, t] + h·r[h]``,
``m' = max(f̃ + m, ĩ)``, ``i = exp(ĩ − m')``, ``f = exp(f̃ + m − m')``,
``c' = f·c + i·tanh(z̃)``, ``n' = f·n + i``, ``h' = σ(õ)·c' / max(n', 1)``.
``pre`` is ``(B, H, S, 4, hd)`` f32 (gates i, f, z, o), ``r`` ``(H, 4, hd,
hd)`` f32 or bf16 (widened exactly), the states ``(B, H, hd)`` f32; the
result is ``hs`` ``(B, H, S, hd)`` and the final ``(c, n, h, m)``.

The TPU kernel keeps ``r[h]`` in VMEM for the whole sequence; at hd = 512
that is 4 MB, which no SM holds.  The CUDA kernel splits each (b, h) over
``hd / 16`` blocks by hidden unit, each keeping its slice of ``r`` in shared
memory for the whole sequence and exchanging ``h_t`` through L2 with a
barrier per (b, h) per step, in one cooperative launch (see the source).
Bound on the H100: operations, 8·hd² FLOP per (b, h, step) on the f32
units (67 TFLOP/s); the S dependent steps add a floor the bound does not see.

The TPU kernel's ``t_block`` and ``seq_len`` have no counterpart: the CUDA
kernel takes any S.  ``pre`` may be any strided view whose last axis is
contiguous (the sLSTM block passes its ``(B, S, 4, H, hd)`` projection
permuted, without a copy); ``hs`` is returned as a ``(B, H, S, hd)`` view
of a ``(B, S, H, hd)`` buffer, the block's layout.  On CUDA tensors the
wrapper launches the kernel or raises; on CPU tensors it runs
:func:`slstm_sequence_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAME = "slstm_sequence"
R_DTYPES = (torch.float32, torch.bfloat16)


def _step(xt, r, c, n, h, m):
    """One step over ``(B, H, ·)``: xt (B, H, 4, hd), r (H, 4, hd, hd) f32."""
    pre = xt + torch.einsum("bhd,hgde->bhge", h, r)
    itil, ftil, ztil, otil = pre.unbind(2)
    m_new = torch.maximum(ftil + m, itil)
    i = torch.exp(itil - m_new)
    f = torch.exp(ftil + m - m_new)
    c2 = f * c + i * torch.tanh(ztil)
    n2 = f * n + i
    h2 = torch.sigmoid(otil) * c2 / torch.clamp(n2, min=1.0)
    return c2, n2, h2, m_new


def slstm_sequence_plain(pre, r, c0, n0, h0, m0):
    """The kernel's plain twin: one step of tensor ops per time step."""
    b, hh, s, _, hd = pre.shape
    rf = r.float()
    c, n, h, m = c0, n0, h0, m0
    hs = []
    for t in range(s):
        c, n, h, m = _step(pre[:, :, t], rf, c, n, h, m)
        hs.append(h)
    out = torch.stack(hs, 2) if hs else pre.new_empty((b, hh, 0, hd))
    return out, (c, n, h, m)


def _check(pre, r, states) -> None:
    if pre.ndim != 5 or pre.shape[3] != 4:
        raise ValueError(f"{NAME}: pre (B, H, S, 4, hd) expected, got {tuple(pre.shape)}")
    b, h, _, _, hd = pre.shape
    if tuple(r.shape) != (h, 4, hd, hd):
        raise ValueError(f"{NAME}: r {tuple(r.shape)} != {(h, 4, hd, hd)}")
    for s in states:
        if tuple(s.shape) != (b, h, hd):
            raise ValueError(f"{NAME}: state {tuple(s.shape)} != {(b, h, hd)}")
        if s.dtype != torch.float32:
            raise TypeError(f"{NAME}: states must be float32, got {s.dtype}")
    if pre.dtype != torch.float32 or r.dtype not in R_DTYPES:
        raise TypeError(f"{NAME}: pre must be float32 and r one of {R_DTYPES}, got "
                        f"{pre.dtype}, {r.dtype}")


def slstm_sequence(pre, r, c0, n0, h0, m0):
    """Run the sLSTM recurrence.  Returns ``(hs (B, H, S, hd), (c, n, h, m))``.

    One launch on the card (hd a multiple of 4; ``pre``'s last axis and
    ``r`` and the states contiguous)."""
    states = (c0, n0, h0, m0)
    _check(pre, r, states)
    if not build.on_card(NAME, pre):
        return slstm_sequence_plain(pre, r, c0, n0, h0, m0)
    b, hh, s, _, hd = pre.shape
    if hd % 4:
        raise ValueError(f"{NAME}: the CUDA kernel takes head dims that are multiples of 4, "
                         f"got {hd}")
    if pre.stride(4) != 1:
        raise ValueError(f"{NAME}: pre's last axis must be contiguous")
    build.require_cuda(NAME, r, *states)
    if pre.device != r.device:
        raise ValueError(f"{NAME}: tensors on {pre.device} and {r.device}")
    hs = torch.empty((b, s, hh, hd), dtype=torch.float32, device=pre.device).permute(0, 2, 1, 3)
    finals = tuple(torch.empty_like(c0) for _ in range(4))
    if s == 0 or b * hh == 0:
        for dst, src in zip(finals, states):
            dst.copy_(src)
        return hs, finals
    xbuf = torch.empty((2, b * hh, hd), dtype=torch.float32, device=pre.device)
    counters = torch.zeros((b * hh,), dtype=torch.int32, device=pre.device)
    build.launch(
        NAME, pre.data_ptr(), *pre.stride()[:4], r.data_ptr(), int(r.dtype == torch.bfloat16),
        *(t.data_ptr() for t in states), hs.data_ptr(), *hs.stride()[:3],
        *(t.data_ptr() for t in finals), xbuf.data_ptr(), counters.data_ptr(),
        b, hh, s, hd, build.stream_of(pre),
    )
    return hs, finals
