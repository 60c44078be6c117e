"""Kernel 5 wrapper: the paper's linear bucket probe (``csrc/bucket_probe.cu``).

Replaces the Pallas ``bucket_probe_2d`` (``repro/kernels/bucket_probe.py``):
for each query slot, the number of ``j < max_probe`` with
``starts + j < ends`` and ``table[starts + j] == q``.  On CUDA tensors the
wrapper launches the kernel or raises; on CPU tensors it runs
:func:`bucket_probe_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAME = "bucket_probe"


def bucket_probe_plain(
    starts: torch.Tensor,
    ends: torch.Tensor,
    q: torch.Tensor,
    table: torch.Tensor,
    max_probe: int,
) -> torch.Tensor:
    """The kernel's plain twin: ``(..., N)`` slots over a ``(..., M)`` table.

    Walks the windows one probe step at a time (the reference materialises
    ``(N, max_probe)``, which does not fit at 2^27 slots) and stops after the
    longest window; the steps it skips match nothing.  Indices are clipped
    into the table as the reference clips them.
    """
    m = table.shape[-1]
    acc = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    if q.numel() == 0 or m == 0:
        return acc
    lo = starts.to(torch.int64)
    hi = ends.to(torch.int64)
    trips = min(int(max_probe), int((hi - lo).max()))
    for j in range(max(trips, 0)):
        idx = lo + j
        vals = torch.gather(table, -1, torch.clamp(idx, 0, m - 1))
        acc += ((idx < hi) & (vals == q)).to(torch.int32)
    return acc


def _check(starts, ends, q, table) -> None:
    for label, t in (("starts", starts), ("ends", ends), ("q", q), ("table", table)):
        if t.dtype != torch.int32:
            raise TypeError(f"{NAME}: {label} must be int32, got {t.dtype}")
    if not (starts.shape == ends.shape == q.shape) or q.ndim not in (1, 2):
        raise ValueError(
            f"{NAME}: starts {tuple(starts.shape)}, ends {tuple(ends.shape)} and q "
            f"{tuple(q.shape)} must share one (N,) or (S, N) shape"
        )
    if table.ndim != q.ndim or table.shape[:-1] != q.shape[:-1]:
        raise ValueError(
            f"{NAME}: table {tuple(table.shape)} does not match q {tuple(q.shape)}"
        )


def bucket_probe(
    starts: torch.Tensor,
    ends: torch.Tensor,
    q: torch.Tensor,
    table: torch.Tensor,
    max_probe: int = 64,
) -> torch.Tensor:
    """int32 match counts of ``q`` in its window ``table[starts:ends]``,
    capped at ``max_probe`` words; ``(S, N)`` slots take a ``(S, M)`` table
    (one launch for S shards), ``(N,)`` slots a ``(M,)`` table."""
    _check(starts, ends, q, table)
    if not 0 <= max_probe < 2**31:
        raise ValueError(f"{NAME}: max_probe must be in [0, 2^31), got {max_probe}")
    if not build.on_card(NAME, q):
        return bucket_probe_plain(starts, ends, q, table, max_probe)
    starts, ends, q, table = (t.contiguous() for t in (starts, ends, q, table))
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    num_shards = 1 if q.ndim == 1 else q.shape[0]
    n, table_len = q.shape[-1], table.shape[-1]
    if out.numel() == 0:
        return out
    if table_len == 0:  # no window can hold a word
        return out.zero_()
    build.require_cuda(NAME, starts, ends, q, table, out)
    build.launch(
        NAME, starts.data_ptr(), ends.data_ptr(), q.data_ptr(), table.data_ptr(),
        n, table_len, num_shards, int(max_probe), out.data_ptr(), build.stream_of(q),
    )
    return out
