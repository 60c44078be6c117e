"""Kernel 7 wrapper: the sLSTM recurrence (``csrc/slstm.cu``).

Replaces the Pallas ``slstm_sequence`` (``repro/kernels/slstm.py``): for
every (b, h) and each step t in order, ``pre_t = pre[b, h, t] + h·r[h]``,
``m' = max(f̃ + m, ĩ)``, ``i = exp(ĩ − m')``, ``f = exp(f̃ + m − m')``,
``c' = f·c + i·tanh(z̃)``, ``n' = f·n + i``, ``h' = σ(õ)·c' / max(n', 1)``.
``pre`` is ``(B, H, S, 4, hd)`` f32 (gates i, f, z, o), ``r`` ``(H, 4, hd,
hd)`` f32 or bf16 (widened exactly), the states ``(B, H, hd)`` f32; the
result is ``hs`` ``(B, H, S, hd)`` and the final ``(c, n, h, m)``.

The TPU kernel keeps ``r[h]`` in VMEM for the whole sequence; at hd = 512
that is 2 MB in bf16 and 4 MB in f32, which no SM holds, so each head is
split over several blocks by hidden unit and ``h_t`` is exchanged between
them at every step.  The variant follows r's dtype alone (see the source):
bf16 r (the serving copy) takes ``slstm_cluster``, one thread-block cluster
per (head, slice of up to 4 batch rows) with its slice of r in registers as
tensor-core fragments and ``h_t`` broadcast through distributed shared
memory; f32 r takes ``slstm_coop``, a cooperative launch that keeps r in
shared memory and exchanges ``h_t`` through L2 with a barrier per (b, h).
:func:`launch_plan` computes either plan in plain Python.  Bound on the
H100: operations, 8·hd² FLOP per (b, h, step) on the f32 units (67
TFLOP/s); the S dependent steps add a floor the bound does not see.

The TPU kernel's ``t_block`` and ``seq_len`` have no counterpart: the CUDA
kernel takes any S.  ``pre`` may be any strided view whose last axis is
contiguous (the sLSTM block passes its ``(B, S, 4, H, hd)`` projection
permuted, without a copy); ``hs`` is returned as a ``(B, H, S, hd)`` view
of a ``(B, S, H, hd)`` buffer, the block's layout.  On CUDA tensors the
wrapper launches the kernel or raises; on CPU tensors it runs
:func:`slstm_sequence_plain`.

:class:`SlstmSequence` is the differentiable form the sLSTM block calls:
its forward is the kernel (the twin on the CPU); its backward recomputes
:func:`slstm_sequence_plain` from the saved inputs under autograd and
returns that function's vector-Jacobian product.  The reference trains
through its scan, with no backward kernel.
"""
from __future__ import annotations

import torch

from repro_torch import counting
from repro_torch.kernels import build

NAME = "slstm_sequence"
# The profiler range around the plain twin's recomputation and gradient.
BACKWARD_RANGE = "slstm_sequence.backward"
R_DTYPES = (torch.float32, torch.bfloat16)

# The cluster kernel's limits (``csrc/slstm.cu``): cluster size, head dim,
# the SM's register file, registers a thread keeps besides its r fragments.
MAX_CLUSTER, MAX_HD, REG_FILE, REG_RESERVE = 16, 512, 65536, 64
PRE_DEPTH = 8  # steps of pre a gate lane loads ahead
# The cooperative kernel: threads and units a block, shared memory a block
# may opt into on the H100.
COOP_THREADS, COOP_MAX_UNITS, MAX_SMEM_OPTIN = 256, 16, 232448
PLAN_KEYS = ("variant", "cluster", "units", "threads", "smem_bytes", "rows", "slices")


def _k_steps(hd: int) -> int:
    ks = 1
    while 16 * ks < hd:
        ks <<= 1
    return ks


def _max_warps(ks: int) -> int:
    w = 16
    while w > 1 and 32 * w * (4 * ks + REG_RESERVE) > REG_FILE:
        w >>= 1
    return w


def _coop_smem(hd: int, units: int) -> int:
    cols = 4 * units
    return 4 * (cols * (hd + 4) + hd + (COOP_THREADS // cols) * cols + cols)


def launch_plan(hd: int, r_dtype, batch: int) -> dict:
    """The launch the C entry point makes, in plain Python (the card's
    ``slstm_plan`` reports the same and the residency).

    bf16 r, ``variant`` "cluster": ``cluster`` P blocks a head, the smallest
    P <= 16 whose ``units`` U (a multiple of 4, P·U >= hd) make U / 4 warps
    that fit the register file with ``r_regs`` = 4·ks registers of r a
    thread (ks = k-steps of 16, a power of two); ``rows`` batch rows a
    cluster, ``slices`` clusters a head.  f32 r, ``variant``
    "cooperative": hd / U blocks a (b, h) group, U = 16 halved until it
    divides hd and the block's shared memory fits; ``slices`` (launches)
    depend on the card's residency and are None here."""
    if hd <= 0 or hd % 4:
        raise ValueError(f"{NAME}: head dims must be positive multiples of 4, got {hd}")
    if r_dtype == torch.bfloat16:
        if hd > MAX_HD:
            raise ValueError(f"{NAME}: the cluster kernel takes head dims up to {MAX_HD}, got {hd}")
        ks = _k_steps(hd)
        mw = _max_warps(ks)
        p = next(p for p in range(1, MAX_CLUSTER + 1)
                 if -(-hd // (4 * p)) <= mw or p == MAX_CLUSTER)
        u = 4 * -(-hd // (4 * p))
        rows = 2 if batch <= 2 else 4
        return {"variant": "cluster", "cluster": p, "units": u, "threads": 8 * u,
                "smem_bytes": (8 * hd * u + 2 * rows * 4 * ks * 32 + 16
                               + PRE_DEPTH * 4 * u * 16),
                "rows": rows, "slices": -(-batch // rows), "k_steps": ks, "r_regs": 4 * ks}
    units = COOP_MAX_UNITS
    while hd % units:
        units >>= 1
    while units > 4 and _coop_smem(hd, units) > MAX_SMEM_OPTIN:
        units >>= 1
    return {"variant": "cooperative", "cluster": hd // units, "units": units,
            "threads": COOP_THREADS, "smem_bytes": _coop_smem(hd, units), "rows": 1,
            "slices": None, "k_steps": None, "r_regs": 0}


def card_plan(hd: int, r_dtype, batch: int, heads: int) -> dict:
    """The C entry point's own plan on the card (``slstm_plan``), with
    ``resident``: the clusters (f32: groups) the card holds at once."""
    import ctypes

    out = (ctypes.c_int * 8)()
    code = build.library().slstm_plan(hd, int(r_dtype == torch.bfloat16), batch, heads, out)
    if code != 0:
        raise RuntimeError(f"{NAME}: slstm_plan failed: "
                           f"{build.library().kernel_error_string(code).decode()} ({code})")
    plan = dict(zip(PLAN_KEYS, list(out)[:7]))
    plan["variant"] = "cluster" if plan["variant"] == 1 else "cooperative"
    plan["resident"] = out[7]
    return plan


def _step(xt, r, c, n, h, m):
    """One step over ``(B, H, ·)``: xt (B, H, 4, hd), r (H, 4, hd, hd) f32."""
    return _gates(xt + torch.einsum("bhd,hgde->bhge", h, r), c, n, m)


def _gates(pre, c, n, m):
    """The gate math of one step from its pre-activations ``(B, H, 4, hd)``."""
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


def kernel_work(pre_shape, r_elem: int) -> tuple:
    """``(flops, bytes)`` of one launch on pre ``(B, H, S, 4, hd)``: the
    recurrent product ``h r`` of every step (2 FLOPs a multiply-add); pre
    read once, r (``r_elem`` bytes an element) and the four states read
    once, hs and the four finals written once."""
    b, h, s, _, hd = pre_shape
    flops = 2.0 * b * h * s * 4 * hd * hd
    nbytes = 4.0 * (b * h * s * 4 * hd + b * h * s * hd + 8 * b * h * hd) + r_elem * 4 * h * hd * hd
    return flops, nbytes


def backward_work(pre_shape, r_elem: int) -> tuple:
    """``(flops, bytes)`` of the recurrence's backward as one fused pass:
    two products a step (the gradient through ``h r`` and into ``r``); pre,
    hs and dhs read, dpre written, r read and dr written."""
    b, h, s, _, hd = pre_shape
    flops = 4.0 * b * h * s * 4 * hd * hd
    nbytes = 4.0 * (2 * b * h * s * 4 * hd + 2 * b * h * s * hd) + 2 * r_elem * 4 * h * hd * hd
    return flops, nbytes


def slstm_sequence(pre, r, c0, n0, h0, m0):
    """Run the sLSTM recurrence.  Returns ``(hs (B, H, S, hd), (c, n, h, m))``.

    One launch on the card (hd a multiple of 4, at most 512 for bf16 r;
    ``pre``'s last axis and ``r`` and the states contiguous).  Where the
    card cannot place the plan's cluster, it raises with the plan.  On meta
    tensors (the dry run) it records the launch's work
    (:func:`kernel_work`) and returns empty results."""
    states = (c0, n0, h0, m0)
    _check(pre, r, states)
    if pre.is_meta:
        counting.record_kernel(NAME, *kernel_work(pre.shape, r.element_size()))
        b, hh, s, _, hd = pre.shape
        return pre.new_empty((b, hh, s, hd)), tuple(t.new_empty(t.shape) for t in states)
    if not build.on_card(NAME, pre):
        return slstm_sequence_plain(pre, r, c0, n0, h0, m0)
    b, hh, s, _, hd = pre.shape
    if hd % 4:
        raise ValueError(f"{NAME}: the CUDA kernel takes head dims that are multiples of 4, "
                         f"got {hd}")
    if pre.stride(4) != 1:
        raise ValueError(f"{NAME}: pre's last axis must be contiguous")
    if not all(t.is_contiguous() for t in (r, *states)):
        raise ValueError(f"{NAME}: r and the states must be contiguous")
    build.require_cuda(NAME, r, *states)
    if pre.device != r.device:
        raise ValueError(f"{NAME}: tensors on {pre.device} and {r.device}")
    hs = torch.empty((b, s, hh, hd), dtype=torch.float32, device=pre.device).permute(0, 2, 1, 3)
    finals = torch.empty((4, b, hh, hd), dtype=torch.float32, device=pre.device).unbind(0)
    if s == 0 or b * hh == 0:
        for dst, src in zip(finals, states):
            dst.copy_(src)
        return hs, finals
    bf16 = r.dtype == torch.bfloat16
    if bf16 and hd > MAX_HD:
        raise ValueError(f"{NAME}: the cluster kernel takes head dims up to {MAX_HD}, got {hd}")
    scratch = (0, 0)
    if not bf16:  # the cooperative kernel's h exchange and barrier counters
        xbuf = torch.empty((2, b * hh, hd), dtype=torch.float32, device=pre.device)
        counters = torch.zeros((b * hh,), dtype=torch.int32, device=pre.device)
        scratch = (xbuf.data_ptr(), counters.data_ptr())
    build.library()  # a failed build raises here, before the launch is tried
    try:
        build.launch(
            NAME, pre.data_ptr(), *pre.stride()[:4], r.data_ptr(), int(bf16),
            *(t.data_ptr() for t in states), hs.data_ptr(), *hs.stride()[:3],
            *(t.data_ptr() for t in finals), *scratch, b, hh, s, hd, build.stream_of(pre),
        )
    except RuntimeError as err:
        raise RuntimeError(f"{err}; plan on this card: {card_plan(hd, r.dtype, b, hh)}") from err
    return hs, finals


class SlstmSequence(torch.autograd.Function):
    """``SlstmSequence.apply(pre, r, c0, n0, h0, m0)`` → ``(hs, c, n, h, m)``,
    :func:`slstm_sequence`'s results as a flat tuple.

    Forward: one launch of kernel 7 (the plain twin on CPU tensors).
    Backward: :func:`slstm_sequence_plain` recomputed from the saved
    inputs, one step of tensor ops a time step, differentiated by autograd
    (a final state with no gradient counts as zeros)."""

    @staticmethod
    def forward(ctx, pre, r, c0, n0, h0, m0):
        hs, finals = slstm_sequence(pre, r, c0, n0, h0, m0)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(pre, r, c0, n0, h0, m0)
        return (hs, *finals)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        if saved[0].is_meta:  # traced: the fused backward's work, empty gradients
            counting.record_kernel(BACKWARD_RANGE,
                                   *backward_work(saved[0].shape, saved[1].element_size()))
            return tuple(torch.empty_like(t) if need else None
                         for t, need in zip(saved, ctx.needs_input_grad))
        with torch.enable_grad(), torch.profiler.record_function(BACKWARD_RANGE):
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            hs, finals = slstm_sequence_plain(*inputs)
            live = [(o, g) for o, g in zip((hs, *finals), grads) if o.requires_grad]
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in live], wanted, [g for _, g in live],
                                           allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in inputs)
