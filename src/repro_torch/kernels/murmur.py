"""Kernel 1 wrappers: fused murmur3 + bucket id (``csrc/murmur.cu``).

Replaces the Pallas ``murmur_bucket_2d`` (``repro/kernels/murmur.py``).  Two
entries:

- :func:`murmur_bucket`, one word a key, the bucket id;
- :func:`murmur_hash`, 1 or 2 words a key, the bucket id and/or the raw
  32-bit hash under ``FINGERPRINT_SEED`` (the fingerprint lane) from one
  read of the keys.

On a CUDA tensor each wrapper launches the kernel or raises; on a CPU
tensor it runs its plain twin (:func:`murmur_bucket_plain`,
:func:`murmur_hash_plain`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import hashing
from repro_torch.kernels import build, common

NAME = "murmur_bucket"
HASH_NAME = "murmur_hash"


def murmur_bucket_plain(
    keys: torch.Tensor, table_size: int, seed: int = hashing.DEFAULT_SEED
) -> torch.Tensor:
    """The kernel's plain PyTorch twin."""
    return hashing.hash_to_buckets_plain(keys, table_size, seed)


def murmur_bucket(
    keys: torch.Tensor, table_size: int, seed: int = hashing.DEFAULT_SEED, *,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """int32 bucket ids ``murmur3(keys, seed) % table_size``, same shape as ``keys``.

    ``keys`` is an int32 tensor holding uint32 bit patterns.  ``block_rows``
    (None: ``common.resolve_block_rows("murmur", ...)``) sets the CTA's tile
    on the card; the plain twin ignores it.
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
    threads = common.launch_threads("murmur", block_rows, n=keys.numel())
    build.launch(
        NAME,
        keys.data_ptr(),
        out.data_ptr(),
        keys.numel(),
        seed & 0xFFFFFFFF,
        table_size,
        threads,
        build.stream_of(keys),
    )
    return out


def murmur_hash_plain(
    keys: torch.Tensor,
    table_size: int,
    seed: int = hashing.DEFAULT_SEED,
    *,
    lanes: int = 1,
    fingerprint: bool = False,
    buckets: bool = True,
) -> tuple:
    """The two-output kernel's plain twin: ``(bucket ids or None,
    fingerprints or None)``."""
    b = hashing.hash_to_buckets_plain(keys, table_size, seed, lanes) if buckets else None
    f = hashing.fingerprint32(keys, lanes) if fingerprint else None
    return b, f


def murmur_hash(
    keys: torch.Tensor,
    table_size: int,
    seed: int = hashing.DEFAULT_SEED,
    *,
    lanes: int = 1,
    fingerprint: bool = False,
    buckets: bool = True,
    block_rows: Optional[int] = None,
) -> tuple:
    """``(buckets, fingerprints)`` of ``lanes``-word keys, each int32 of the
    key shape (``keys.shape[:-1]`` for 2 lanes) or None where not asked.

    ``buckets`` are ``murmur3(keys, seed) % table_size``; ``fingerprints``
    the raw hash under ``FINGERPRINT_SEED`` as int32 bits.  ``keys`` is an
    int32 tensor of uint32 lane bits, ``(...)`` or ``(..., 2)``.
    ``block_rows`` as :func:`murmur_bucket`'s (resolved with ``width`` the
    lanes).
    """
    hashing.check_table_size(table_size)
    if keys.dtype != torch.int32:
        raise TypeError(f"{HASH_NAME}: keys must be int32 (uint32 bits), got {keys.dtype}")
    if lanes > 1 and (keys.ndim < 1 or keys.shape[-1] != lanes):
        raise ValueError(f"{HASH_NAME}: {lanes}-lane keys need a trailing dim of {lanes}, "
                         f"got {tuple(keys.shape)}")
    if not (buckets or fingerprint):
        raise ValueError(f"{HASH_NAME}: asked for no output")
    if not build.on_card(HASH_NAME, keys):
        return murmur_hash_plain(keys, table_size, seed, lanes=lanes,
                                 fingerprint=fingerprint, buckets=buckets)
    if lanes == 1 and not fingerprint:
        return murmur_bucket(keys, table_size, seed, block_rows=block_rows), None
    if lanes not in (1, 2):
        raise ValueError(f"{HASH_NAME}: the kernel takes 1 or 2 lanes, got {lanes}")
    keys = keys.contiguous()
    if keys.data_ptr() % 16:
        keys = keys.clone()  # 16-byte loads
    shape = keys.shape[:-1] if lanes > 1 else keys.shape
    b = torch.empty(shape, dtype=torch.int32, device=keys.device) if buckets else None
    f = torch.empty(shape, dtype=torch.int32, device=keys.device) if fingerprint else None
    outs = [t for t in (b, f) if t is not None]
    if keys.numel() == 0:
        return b, f
    build.require_cuda(HASH_NAME, keys, *outs)
    n = keys.numel() // lanes
    threads = common.launch_threads("murmur", block_rows, n=n, width=lanes)
    build.launch(
        HASH_NAME, keys.data_ptr(), None if b is None else b.data_ptr(),
        None if f is None else f.data_ptr(), n, lanes, seed & 0xFFFFFFFF,
        hashing.FINGERPRINT_SEED, table_size, threads, build.stream_of(keys),
    )
    return b, f
