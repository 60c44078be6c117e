"""Kernel 6 wrapper: flash attention over the flattened-head layout
(``csrc/flash_attention.cu``).

Replaces the Pallas ``flash_attention_fhsd``
(``repro/kernels/flash_attention.py``): q ``(Hq, Sq, D)``, k/v
``(Hkv, Skv, D)`` with ``Hq == Hkv * q_heads_per_kv``, query head ``h``
reading kv head ``h // q_heads_per_kv``; causal (aligned to the end of the
kv axis, offset ``Skv - Sq``), sliding-window or full; f32 scores, softmax
and accumulator; a row with no live key gives 0; the result in q's type.
The TPU kernel's ``block_q``/``block_kv`` have no counterpart: the CUDA
kernel's tiles are fixed (64 x 64).  On CUDA tensors the wrapper launches
the kernel or raises; on CPU tensors it runs :func:`flash_attention_plain`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)
NEG_INF = -1e30


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

    Query heads are viewed as ``(Hkv, G)`` so kv is broadcast, not copied,
    over the group; fully masked rows give 0.
    """
    hq, sq, d = q.shape
    hkv, skv, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(hkv, q_heads_per_kv, sq, d) * scale
    s = torch.einsum("kgqd,ktd->kgqt", qg, k.float())
    mask = live_mask(sq, skv, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("kgqt,ktd->kgqd", p, v.float())
    out = torch.where(mask.any(dim=1)[:, None], out, 0.0)
    return out.reshape(hq, sq, d).to(q.dtype)


def _check(q, k, v, q_heads_per_kv: int) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(
            f"{NAME}: q (Hq, Sq, D) and k, v (Hkv, Skv, D) expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"{NAME}: head dims differ: q {q.shape[2]}, k {k.shape[2]}")
    if q.shape[0] != k.shape[0] * q_heads_per_kv:
        raise ValueError(
            f"{NAME}: GQA mismatch: {q.shape[0]} != {k.shape[0]} * {q_heads_per_kv}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"{NAME}: q, k, v must share one of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


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
    in q's type.  One launch on the card (contiguous inputs, D in 32/64/128)."""
    _check(q, k, v, q_heads_per_kv)
    if window is not None and window < 0:
        raise ValueError(f"{NAME}: window must be >= 0 or None, got {window}")
    if not build.on_card(NAME, q):
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, scale=scale, q_heads_per_kv=q_heads_per_kv
        )
    hq, sq, d = q.shape
    skv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: the CUDA kernel takes head dims {HEAD_DIMS}, got {d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    build.require_cuda(NAME, q, k, v, out)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    build.launch(
        NAME, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        hq, sq, skv, d, q_heads_per_kv, int(causal), -1 if window is None else int(window),
        float(scale), int(q.dtype == torch.bfloat16), build.stream_of(q),
    )
    return out
