"""Kernels 3 and 4 wrappers: CSR gather (``csrc/csr_gather.cu``).

Replace the Pallas ``csr_gather_2d`` and ``csr_gather_batched_2d``
(``repro/kernels/bucket_probe.py``).  Both take the exact ``num_rows + 1``
prefix sums of the run lengths, the run starts and an int32 table, and
return ``(values, row_idx)`` per output slot.  On CUDA tensors the wrappers
launch the kernel or raise; on CPU tensors they run :func:`gather_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashgraph
from repro_torch.kernels import build

SINGLE = "csr_gather"
BATCHED = "csr_gather_batched"


def gather_plain(
    offsets: torch.Tensor,
    starts: torch.Tensor,
    table: torch.Tensor,
    capacity: int,
    fill: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of both kernels: ``offsets`` ``(..., N+1)`` with
    ``offsets[..., 0] == 0``, ``starts`` ``(..., N)``, a 1-D ``table``."""
    counts = torch.diff(offsets, dim=-1)
    _, rows, vals, _ = hashgraph.csr_gather(starts, counts, table, capacity, fill=fill)
    return vals, rows


def _check(name, offsets, starts, table, lead: int) -> int:
    for label, t in (("offsets", offsets), ("starts", starts), ("table", table)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t.dtype}")
    if offsets.ndim != lead + 1 or starts.ndim != lead + 1 or table.ndim != 1:
        raise ValueError(
            f"{name}: shapes offsets {tuple(offsets.shape)}, starts "
            f"{tuple(starts.shape)}, table {tuple(table.shape)}"
        )
    num_rows = starts.shape[-1]
    if offsets.shape[-1] != num_rows + 1 or offsets.shape[:-1] != starts.shape[:-1]:
        raise ValueError(
            f"{name}: offsets {tuple(offsets.shape)} do not match starts "
            f"{tuple(starts.shape)}"
        )
    if num_rows >= 2**31 - 1:
        raise ValueError(f"{name}: {num_rows} rows exceed int32")
    return num_rows


def _launch(name, offsets, starts, table, capacity, fill, num_sources):
    num_rows = starts.shape[-1]
    dev = offsets.device
    vals = torch.empty((num_sources, capacity), dtype=torch.int32, device=dev)
    rows = torch.empty((num_sources, capacity), dtype=torch.int32, device=dev)
    if capacity == 0 or num_sources == 0:
        return vals, rows
    if table.numel() == 0:  # then no slot is valid; keep the kernel's reads in bounds
        table = torch.full((1,), fill, dtype=torch.int32, device=dev)
    build.require_cuda(name, offsets, starts, table, vals, rows)
    args = [
        offsets.data_ptr(), starts.data_ptr(), table.data_ptr(), table.numel(),
        vals.data_ptr(), rows.data_ptr(), capacity, num_rows,
    ]
    if name == BATCHED:
        args.append(num_sources)
    build.launch(name, *args, int(fill), build.stream_of(offsets))
    return vals, rows


def csr_gather_2d(
    offsets: torch.Tensor,
    starts: torch.Tensor,
    table: torch.Tensor,
    capacity: int,
    fill: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3: one CSR.  ``offsets`` ``(N+1,)``, ``starts`` ``(N,)`` → two ``(capacity,)``."""
    _check(SINGLE, offsets, starts, table, lead=0)
    if not build.on_card(SINGLE, offsets):
        return gather_plain(offsets, starts, table, capacity, fill)
    vals, rows = _launch(
        SINGLE, offsets.contiguous(), starts.contiguous(), table.contiguous(),
        capacity, fill, 1,
    )
    return vals[0], rows[0]


def csr_gather_batched_2d(
    offsets: torch.Tensor,
    starts: torch.Tensor,
    table: torch.Tensor,
    capacity: int,
    fill: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4: one CSR per source over a shared table.  ``offsets``
    ``(S, N+1)``, ``starts`` ``(S, N)`` → two ``(S, capacity)``."""
    _check(BATCHED, offsets, starts, table, lead=1)
    if not build.on_card(BATCHED, offsets):
        return gather_plain(offsets, starts, table, capacity, fill)
    return _launch(
        BATCHED, offsets.contiguous(), starts.contiguous(), table.contiguous(),
        capacity, fill, offsets.shape[0],
    )
