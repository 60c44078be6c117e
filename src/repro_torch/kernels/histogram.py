"""Kernel 2 wrapper: coarse-bin histogram (``csrc/histogram.cu``).

Replaces the Pallas ``histogram_2d`` (``repro/kernels/histogram.py``) with the
paper's shared-memory ``atomicAdd`` form.  On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs :func:`bin_histogram_plain`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, common

NAME = "bin_histogram"
# Shared memory one block may opt into on Hopper (227 KB).
MAX_SHARED_BYTES = 232448


def bin_histogram_plain(bins: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Counts of int32 ids in ``[0, num_bins)``; other ids are ignored."""
    flat = bins.reshape(-1).to(torch.int64)
    ok = (flat >= 0) & (flat < num_bins)
    hist = torch.zeros(num_bins + 1, dtype=torch.int64, device=bins.device)
    hist.scatter_add_(0, torch.where(ok, flat, num_bins), torch.ones_like(flat))
    return hist[:num_bins].to(torch.int32)


def bin_histogram(bins: torch.Tensor, num_bins: int, *,
                  block_rows: Optional[int] = None) -> torch.Tensor:
    """``(num_bins,)`` int32 histogram of the int32 bin ids in ``bins``.
    ``block_rows`` (None: resolved) sets the CTA's tile on the card."""
    if bins.dtype != torch.int32:
        raise TypeError(f"{NAME}: bins must be int32, got {bins.dtype}")
    if num_bins <= 0:
        raise ValueError(f"{NAME}: num_bins must be positive, got {num_bins}")
    if not build.on_card(NAME, bins):
        return bin_histogram_plain(bins, num_bins)
    if num_bins * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"{NAME}: {num_bins} bins need {num_bins * 4} bytes of shared memory, "
            f"more than the {MAX_SHARED_BYTES} a block can hold"
        )
    if bins.numel() == 0:
        return torch.zeros(num_bins, dtype=torch.int32, device=bins.device)
    bins = bins.reshape(-1).contiguous()
    if bins.data_ptr() % 16:
        bins = bins.clone()  # the kernel's vector loads need 16-byte alignment
    hist = torch.empty(num_bins, dtype=torch.int32, device=bins.device)
    build.require_cuda(NAME, bins, hist)
    threads = common.launch_threads("bin_histogram", block_rows, n=bins.numel())
    build.launch(
        NAME, bins.data_ptr(), bins.numel(), hist.data_ptr(), num_bins, threads,
        build.stream_of(bins),
    )
    return hist
