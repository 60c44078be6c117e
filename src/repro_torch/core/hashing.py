"""MurmurHash3_x86_32 in plain PyTorch (port of ``repro.core.hashing``).

``torch.uint32`` has no shifts or ``%``, so the 32-bit lanes are carried as
int64 and masked with ``& 0xFFFFFFFF`` after every multiply and shift.  A
32 × 32-bit product can exceed int64, so :func:`_mul32` splits the constant
into 16-bit halves and never overflows.

:func:`hash_to_buckets` is the function of the Pallas ``murmur_bucket_2d``
kernel: on a CUDA tensor it launches the port's CUDA kernel
(``repro_torch.kernels.murmur``), on a CPU tensor it runs the plain lanes
below.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_N = 0xE6546B64

DEFAULT_SEED = 0x9747B28C  # seed used by the reference murmur CLI examples
# Seed of the probe fingerprint lane (used from the next slice on).
FINGERPRINT_SEED = 0x5BD1E995


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in ``[0, 2^32)`` without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 finalizer on int64 lanes holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


def murmur3_u32(keys: torch.Tensor, seed: int = DEFAULT_SEED) -> torch.Tensor:
    """MurmurHash3_x86_32 of each 32-bit key; int64 result in ``[0, 2^32)``.

    ``keys`` holds uint32 values in any integer dtype (the int32 bit pattern
    included).  Matches the C reference for a 4-byte little-endian input.
    """
    k = keys.to(torch.int64) & _MASK
    k = _mul32(k, _C1)
    k = _rotl32(k, 15)
    k = _mul32(k, _C2)
    h = k ^ (seed & _MASK)
    h = _rotl32(h, 13)
    h = (h * 5 + _N) & _MASK
    h = h ^ 4  # total length in bytes
    return fmix32(h)


def check_table_size(table_size: int) -> None:
    if table_size <= 0 or table_size > 2**31 - 1:
        raise ValueError(f"table_size must be in [1, 2^31-1], got {table_size}")


def hash_to_buckets(
    keys: torch.Tensor, table_size: int, seed: int = DEFAULT_SEED
) -> torch.Tensor:
    """``hash(e) mod V`` (Alg. 1 line 2 / Alg. 2 line 4) as int32.

    ``keys`` is an int32 (uint32 bit pattern) tensor of any shape; the result
    has the same shape.  CUDA tensors go through the murmur kernel.
    """
    from repro_torch.kernels import murmur

    return murmur.murmur_bucket(keys, table_size, seed)


def hash_to_buckets_plain(
    keys: torch.Tensor, table_size: int, seed: int = DEFAULT_SEED
) -> torch.Tensor:
    """Plain PyTorch ``hash_to_buckets`` (the murmur kernel's twin)."""
    check_table_size(table_size)
    return (murmur3_u32(keys, seed) % table_size).to(torch.int32)
