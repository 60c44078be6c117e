"""Phase 1 of Alg. 2 — coarse binning and balanced splits (port of
``repro.core.partition``).

The histogram runs in the bin-histogram kernel on the card
(``repro_torch.kernels.histogram``).  Split selection keeps the reference's
``searchsorted(side="left") + 1`` and ``cummax`` repair exactly, so both
packages cut the hash range at the same points.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import histogram
from repro_torch.utils import cdiv


def choose_num_bins(hash_range: int, num_devices: int, align: int = 128) -> int:
    """Paper's guidance: ``BINS_G = O(sqrt(HR))``, with ``BINS_G > DEVICES``."""
    raw = int(math.isqrt(max(1, hash_range)))
    raw = max(raw, 4 * num_devices, align)
    raw = min(raw, hash_range)  # never more bins than hash values
    return cdiv(raw, align) * align


def bin_size_for(hash_range: int, num_bins: int) -> int:
    return cdiv(hash_range, num_bins)


def local_bin_histogram(
    buckets: torch.Tensor,
    num_bins: int,
    hash_range: int,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Histogram of hash values into ``num_bins`` coarse bins (Alg. 2 l.6-8).

    Rows with ``valid`` False get bin id -1, which the histogram ignores.
    """
    bsz = bin_size_for(hash_range, num_bins)
    bins = torch.clamp(torch.div(buckets, bsz, rounding_mode="floor"), 0, num_bins - 1)
    bins = bins.to(torch.int32)
    if valid is not None:
        bins = torch.where(valid, bins, -1).to(torch.int32)
    return histogram.bin_histogram(bins, num_bins)


def _balanced_targets(total: torch.Tensor, num_devices: int) -> torch.Tensor:
    """``floor(d * total / DEVICES)`` for d = 1..DEVICES-1 without overflow."""
    d = torch.arange(1, num_devices, dtype=torch.int64, device=total.device)
    q = total // num_devices
    r = total % num_devices
    return d * q + (d * r) // num_devices


def balanced_hash_splits(
    global_hist: torch.Tensor, num_devices: int, hash_range: int
) -> torch.Tensor:
    """Split points ``(DEVICES + 1,)`` int32: device ``d`` owns hash values in
    ``[splits[d], splits[d+1])``, each holding ≈ N/DEVICES keys."""
    num_bins = global_hist.shape[0]
    bsz = bin_size_for(hash_range, num_bins)
    prefix = torch.cumsum(global_hist.to(torch.int64), 0)  # inclusive CDF
    targets = _balanced_targets(prefix[-1], num_devices)
    # First bin whose inclusive CDF reaches the target; the device boundary
    # is the end of that bin.
    split_bins = torch.searchsorted(prefix, targets, side="left") + 1
    hash_splits = torch.clamp(split_bins * bsz, max=hash_range)
    if hash_splits.numel():
        hash_splits = torch.cummax(hash_splits, 0).values  # monotone repair
    zero = torch.zeros(1, dtype=torch.int64, device=global_hist.device)
    top = torch.full((1,), hash_range, dtype=torch.int64, device=global_hist.device)
    return torch.cat([zero, hash_splits, top]).to(torch.int32)


def destination_of(buckets: torch.Tensor, hash_splits: torch.Tensor) -> torch.Tensor:
    """Owning device of each hash value (Alg. 2 ``Search``), int32."""
    d = torch.searchsorted(hash_splits, buckets.contiguous(), right=True, out_int32=True)
    return torch.clamp(d - 1, 0, hash_splits.shape[0] - 2).to(torch.int32)
