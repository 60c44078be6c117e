"""Kernel 6 wrapper: flash attention over the flattened-head layout
(``csrc/flash_attention.cu``).

Replaces the Pallas ``flash_attention_fhsd``
(``repro/kernels/flash_attention.py``): q ``(Hq, Sq, D)``, k/v
``(Hkv, Skv, D)`` with ``Hq == Hkv * q_heads_per_kv``, query head ``h``
reading kv head ``h // q_heads_per_kv``; causal (aligned to the end of the
kv axis, offset ``Skv - Sq``), sliding-window or full; f32 scores, softmax
and accumulator; a row with no live key gives 0; the result in q's type.
The TPU kernel's ``block_q``/``block_kv`` have no counterpart: the CUDA
kernel's tiles are fixed (128 x 128 in bf16, 128 x 64 at D = 256; 64 x 64
in f32).

The kernel reads q, k, v and writes o through strides (see
:func:`card_strides`), so :func:`flash_attention_bhsd` takes the permuted
views of a model's projections, with a batch dimension, and an output
buffer in the model's own layout.  On CUDA tensors the wrappers launch the
kernel or raise; on CPU tensors they run :func:`flash_attention_plain`.

:class:`FlashAttention` is the differentiable form a model calls: its
forward is the kernel (the twin on the CPU); its backward recomputes
:func:`flash_attention_plain` from the saved q, k, v under autograd and
returns that function's vector-Jacobian product.  The reference has no
backward kernel either: it trains through the einsum attention.

On meta tensors (the dry run, ``launch/dryrun.py``) nothing runs: the
wrapper records the work one launch does (:func:`kernel_work`: the live
(query, key) pairs of the causal or windowed mask, not the twin's whole
score matrix; q, k and v read once, o written once) with
``counting.record_kernel`` and returns an empty result; the backward
records a fused backward's work (:func:`backward_work`), not the twin's.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch import counting
from repro_torch.kernels import build

NAME = "flash_attention"
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
NEG_INF = -1e30
# The profiler range around the plain twin's recomputation and gradient.
BACKWARD_RANGE = "flash_attention.backward"


def live_mask(sq: int, skv: int, *, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """``(Sq, Skv)`` bool: the keys each query row may attend to."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        offset = skv - sq
        mask &= k_pos <= q_pos + offset
        if window is not None:
            mask &= k_pos > q_pos + offset - window
    elif window is not None:
        mask &= (k_pos - q_pos).abs() < window
    return mask


def live_pairs(sq: int, skv: int, *, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs of :func:`live_mask` that hold, counted in
    closed form per query row (no ``(Sq, Skv)`` mask is made)."""
    i = np.arange(sq, dtype=np.int64)
    if causal:
        hi = np.minimum(i + (skv - sq), skv - 1)
        lo = np.zeros_like(i) if window is None else np.maximum(i + (skv - sq) - window + 1, 0)
    elif window is not None:
        hi = np.minimum(i + window - 1, skv - 1)
        lo = np.maximum(i - window + 1, 0)
    else:
        return sq * skv
    return int(np.maximum(hi - lo + 1, 0).sum())


def kernel_work(q_shape, k_shape, elem: int, *, causal: bool, window: Optional[int]) -> tuple:
    """``(flops, bytes)`` of one launch on q ``(B, Hq, Sq, D)`` over k/v
    ``(B, Hkv, Skv, D)``: two products of ``D`` a live pair (q·k and p·v,
    2 FLOPs a multiply-add) for every query head; q, k, v read once and o
    written once, ``elem`` bytes an element."""
    b, hq, sq, d = q_shape
    hkv, skv = k_shape[1], k_shape[2]
    pairs = live_pairs(sq, skv, causal=causal, window=window)
    flops = 4.0 * b * hq * pairs * d
    nbytes = float(elem) * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
    return flops, nbytes


def backward_work(q_shape, k_shape, elem: int, *, causal: bool, window: Optional[int]) -> tuple:
    """``(flops, bytes)`` of a fused flash backward: five products a live pair
    (the scores again, dV, dP, dQ, dK); q, k, v, o and dO read, dQ, dK, dV
    written."""
    flops, _ = kernel_work(q_shape, k_shape, elem, causal=causal, window=window)
    b, hq, sq, d = q_shape
    hkv, skv = k_shape[1], k_shape[2]
    return 2.5 * flops, float(elem) * (4 * b * hq * sq * d + 4 * b * hkv * skv * d)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_heads_per_kv: int = 1,
) -> torch.Tensor:
    """The kernel's plain twin: the masked grouped einsum in f32.

    q ``(..., Hq, Sq, D)``, k/v ``(..., Hkv, Skv, D)`` with the same leading
    dims.  Query heads are viewed as ``(Hkv, G)`` so kv is broadcast, not
    copied, over the group; fully masked rows give 0.
    """
    *lead, hq, sq, d = q.shape
    hkv, skv, _ = k.shape[-3:]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(*lead, hkv, q_heads_per_kv, sq, d) * scale
    s = torch.einsum("...kgqd,...ktd->...kgqt", qg, k.float())
    mask = live_mask(sq, skv, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("...kgqt,...ktd->...kgqd", p, v.float())
    out = torch.where(mask.any(dim=1)[:, None], out, 0.0)
    return out.reshape(*lead, hq, sq, d).to(q.dtype)


def card_strides(t: torch.Tensor, name: str) -> tuple[int, ...]:
    """The element strides of all but the last dim of ``t``, as the kernel
    takes them; raises ValueError for a view it does not take.

    The last dim must be contiguous, every other stride a multiple of 16
    bytes and the base 16-byte aligned: what a TMA tensor map takes (the f32
    kernel keeps the same rule).  A dim of size 1 is never stepped, so its
    stride is replaced by a valid one.  Pure Python: runs without a card.
    """
    elem = t.element_size()
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{NAME}: {name} needs a contiguous last dim, got strides {t.stride()}")
    strides = []
    for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
        if size == 1:
            stride = 16 // elem * t.shape[-1]
        if stride <= 0 or (stride * elem) % 16:
            raise ValueError(f"{NAME}: {name}'s strides {t.stride()} are not positive multiples "
                             f"of 16 bytes")
        strides.append(stride)
    if t.data_ptr() % 16:
        raise ValueError(f"{NAME}: {name}'s base is not 16-byte aligned")
    return tuple(strides)


def _check(q, k, v, q_heads_per_kv: int) -> None:
    if q.ndim not in (3, 4) or k.ndim != q.ndim or v.shape != k.shape:
        raise ValueError(
            f"{NAME}: q ([B,] Hq, Sq, D) and k, v ([B,] Hkv, Skv, D) expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.ndim == 4 and k.shape[0] != q.shape[0]:
        raise ValueError(f"{NAME}: batch sizes differ: q {q.shape[0]}, k {k.shape[0]}")
    if k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{NAME}: head dims differ: q {q.shape[-1]}, k {k.shape[-1]}")
    if q.shape[-3] != k.shape[-3] * q_heads_per_kv:
        raise ValueError(
            f"{NAME}: GQA mismatch: {q.shape[-3]} != {k.shape[-3]} * {q_heads_per_kv}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"{NAME}: q, k, v must share one of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_bhsd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_heads_per_kv: int = 1,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of q ``(B, Hq, Sq, D)`` over k/v ``(B, Hkv, Skv, D)``, any
    views :func:`card_strides` takes; returns ``out`` (allocated
    ``(B, Hq, Sq, D)`` when None, else written in place through its
    strides) in q's type.  One launch on the card (D in 32/64/128/256)."""
    _check(q, k, v, q_heads_per_kv)
    if q.ndim != 4:
        raise ValueError(f"{NAME}: flash_attention_bhsd takes (B, H, S, D) tensors")
    if window is not None and window < 0:
        raise ValueError(f"{NAME}: window must be >= 0 or None, got {window}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype or out.device != q.device):
        raise ValueError(f"{NAME}: out must be {tuple(q.shape)} {q.dtype} on {q.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if q.is_meta:  # traced, not run: the launch's work and an empty result
        counting.record_kernel(NAME, *kernel_work(q.shape, k.shape, q.element_size(),
                                                  causal=causal, window=window))
        return torch.empty_like(q) if out is None else out
    if not build.on_card(NAME, q):
        got = flash_attention_plain(
            q, k, v, causal=causal, window=window, scale=scale, q_heads_per_kv=q_heads_per_kv
        )
        return got if out is None else out.copy_(got)
    nb, hq, sq, d = q.shape
    skv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: the CUDA kernel takes head dims {HEAD_DIMS}, got {d}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    for t in (k, v, out):
        if t.device != q.device:
            raise ValueError(f"{NAME}: tensors on {t.device} and {q.device}")
    strides = [s for t, n in ((q, "q"), (k, "k"), (v, "v"), (out, "out"))
               for s in card_strides(t, n)]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    build.launch(
        NAME, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        nb, hq, sq, skv, d, q_heads_per_kv, int(causal), -1 if window is None else int(window),
        float(scale), int(q.dtype == torch.bfloat16), build.stream_of(q),
    )
    return out


def flash_attention_fhsd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_heads_per_kv: int = 1,
) -> torch.Tensor:
    """Attention of q ``(Hq, Sq, D)`` over k/v ``(Hkv, Skv, D)``; ``(Hq, Sq, D)``
    in q's type.  The reference's layout; views are taken as
    :func:`flash_attention_bhsd` takes them."""
    _check(q, k, v, q_heads_per_kv)
    if q.ndim != 3:
        raise ValueError(f"{NAME}: flash_attention_fhsd takes (H, S, D) tensors")
    return flash_attention_bhsd(
        q[None], k[None], v[None], causal=causal, window=window, scale=scale,
        q_heads_per_kv=q_heads_per_kv,
    )[0]


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, window, scale, q_heads_per_kv)``:
    attention of q ``(B, Hq, Sq, D)`` over k/v ``(B, Hkv, Skv, D)``, any views
    :func:`card_strides` takes, returned as ``(B, Sq, Hq, D)`` (the layout
    whose last two dims merge into a model's heads without a copy) in q's
    type.

    Forward: one launch of the kernel through :func:`flash_attention_bhsd`
    (the plain twin on CPU tensors).  Backward: the plain twin recomputed
    from the saved inputs in f32, differentiated by autograd; its gradients
    come back in the inputs' types."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], scale: Optional[float],
                q_heads_per_kv: int):
        b, hq, sq, d = q.shape
        out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
        flash_attention_bhsd(q, k, v, causal=causal, window=window, scale=scale,
                             q_heads_per_kv=q_heads_per_kv, out=out.permute(0, 2, 1, 3))
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        q_heads_per_kv=q_heads_per_kv)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        if q.is_meta:  # traced: a fused backward's work, empty gradients
            counting.record_kernel(BACKWARD_RANGE, *backward_work(
                q.shape, k.shape, q.element_size(), causal=ctx.opts["causal"],
                window=ctx.opts["window"]))
            return (*(torch.empty_like(t) if need else None
                      for t, need in zip((q, k, v), ctx.needs_input_grad[:3])),
                    None, None, None, None)
        with torch.enable_grad(), torch.profiler.record_function(BACKWARD_RANGE):
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
            out = flash_attention_plain(*inputs, **ctx.opts)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out.permute(0, 2, 1, 3)))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None, None)
