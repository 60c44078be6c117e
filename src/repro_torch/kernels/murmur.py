"""Kernel 1 wrapper: fused murmur3 + bucket id (``csrc/murmur.cu``).

Replaces the Pallas ``murmur_bucket_2d`` (``repro/kernels/murmur.py``).  On a
CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs the plain twin, :func:`repro_torch.core.hashing.hash_to_buckets_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import build

NAME = "murmur_bucket"


def murmur_bucket_plain(
    keys: torch.Tensor, table_size: int, seed: int = hashing.DEFAULT_SEED
) -> torch.Tensor:
    """The kernel's plain PyTorch twin."""
    return hashing.hash_to_buckets_plain(keys, table_size, seed)


def murmur_bucket(
    keys: torch.Tensor, table_size: int, seed: int = hashing.DEFAULT_SEED
) -> torch.Tensor:
    """int32 bucket ids ``murmur3(keys, seed) % table_size``, same shape as ``keys``.

    ``keys`` is an int32 tensor holding uint32 bit patterns.
    """
    hashing.check_table_size(table_size)
    if keys.dtype != torch.int32:
        raise TypeError(f"{NAME}: keys must be int32 (uint32 bits), got {keys.dtype}")
    if not build.on_card(NAME, keys):
        return murmur_bucket_plain(keys, table_size, seed)
    keys = keys.contiguous()
    if keys.data_ptr() % 16:
        keys = keys.clone()  # the kernel's vector loads need 16-byte alignment
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    if keys.numel() == 0:
        return out
    build.require_cuda(NAME, keys, out)
    build.launch(
        NAME,
        keys.data_ptr(),
        out.data_ptr(),
        keys.numel(),
        seed & 0xFFFFFFFF,
        table_size,
        build.stream_of(keys),
    )
    return out
