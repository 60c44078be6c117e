"""MurmurHash3_x86_32 in plain PyTorch (port of ``repro.core.hashing``).

``torch.uint32`` has no shifts or ``%``, so the 32-bit lanes are carried as
int64 and masked with ``& 0xFFFFFFFF`` after every multiply and shift.  A
32 × 32-bit product can exceed int64, so :func:`_mul32` splits the constant
into 16-bit halves and never overflows.

Keys have 1 lane (``(...)`` int32 uint32 bits) or L lanes (``(..., L)``
int32, lane 0 the first 4-byte block: for the 2-lane uint64 packing, the
8-byte little-endian key).  :func:`murmur3_stream` hashes L words a row,
:func:`murmur3_packed` dispatches on the lane count and
:func:`fingerprint32` is the same stream under ``FINGERPRINT_SEED``.

:func:`hash_to_buckets` is the function of the Pallas ``murmur_bucket_2d``
kernel and :func:`hash_and_fingerprint` its two-output form: on a CUDA
tensor they launch the port's kernel 1 (``repro_torch.kernels.murmur``), on
a CPU tensor they run the plain lanes below.
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
# Seed of the probe fingerprint lane: independent of the bucket hash, so keys
# that share a bucket are not biased toward sharing a fingerprint.
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


def _mix(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One 4-byte block ``k`` into the running hash ``h`` (int64 lanes)."""
    k = _mul32(k.to(torch.int64) & _MASK, _C1)
    k = _rotl32(k, 15)
    k = _mul32(k, _C2)
    h = h ^ k
    h = _rotl32(h, 13)
    return (h * 5 + _N) & _MASK


def murmur3_u32(keys: torch.Tensor, seed: int = DEFAULT_SEED) -> torch.Tensor:
    """MurmurHash3_x86_32 of each 32-bit key; int64 result in ``[0, 2^32)``.

    ``keys`` holds uint32 values in any integer dtype (the int32 bit pattern
    included).  Matches the C reference for a 4-byte little-endian input.
    """
    h = _mix(torch.full_like(keys, seed & _MASK, dtype=torch.int64), keys)
    return fmix32(h ^ 4)  # total length in bytes


def murmur3_stream(words: torch.Tensor, seed: int = DEFAULT_SEED) -> torch.Tensor:
    """MurmurHash3_x86_32 over the trailing axis of 32-bit words.

    ``words[..., i]`` is the i-th 4-byte block of the message (uint32 values
    in any integer dtype); returns int64 in ``[0, 2^32)`` with the axis
    reduced.
    """
    h = torch.full(words.shape[:-1], seed & _MASK, dtype=torch.int64, device=words.device)
    for i in range(words.shape[-1]):
        h = _mix(h, words[..., i])
    return fmix32(h ^ (4 * words.shape[-1]))


def murmur3_packed(keys: torch.Tensor, seed: int = DEFAULT_SEED, lanes: int = 1) -> torch.Tensor:
    """MurmurHash3_x86_32 of 1-lane ``(...)`` or ``lanes``-lane ``(..., L)``
    keys: :func:`murmur3_u32` or :func:`murmur3_stream`; int64 in
    ``[0, 2^32)`` of the key shape."""
    if lanes == 1:
        return murmur3_u32(keys, seed)
    return murmur3_stream(keys, seed)


def fingerprint32(keys: torch.Tensor, lanes: int = 1, seed: int = FINGERPRINT_SEED) -> torch.Tensor:
    """32-bit probe fingerprint of 1-lane or packed keys, as int32 bits: the
    :func:`murmur3_packed` stream under ``FINGERPRINT_SEED``."""
    h = murmur3_packed(keys, seed, lanes)
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def check_table_size(table_size: int) -> None:
    if table_size <= 0 or table_size > 2**31 - 1:
        raise ValueError(f"table_size must be in [1, 2^31-1], got {table_size}")


def hash_to_buckets(
    keys: torch.Tensor, table_size: int, seed: int = DEFAULT_SEED, lanes: int = 1
) -> torch.Tensor:
    """``hash(e) mod V`` (Alg. 1 line 2 / Alg. 2 line 4) as int32.

    ``keys`` is an int32 tensor of uint32 lane bits, ``(...)`` for 1 lane or
    ``(..., lanes)``; the result has the key shape.  CUDA tensors go through
    the murmur kernel.
    """
    from repro_torch.kernels import murmur

    if lanes == 1:
        return murmur.murmur_bucket(keys, table_size, seed)
    return murmur.murmur_hash(keys, table_size, seed, lanes=lanes)[0]


def hash_and_fingerprint(
    keys: torch.Tensor, table_size: int, seed: int = DEFAULT_SEED, lanes: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hash_to_buckets, fingerprint32)`` of the same keys from one read
    of them (one kernel 1 launch on the card)."""
    from repro_torch.kernels import murmur

    return murmur.murmur_hash(keys, table_size, seed, lanes=lanes, fingerprint=True)


def hash_to_buckets_plain(
    keys: torch.Tensor, table_size: int, seed: int = DEFAULT_SEED, lanes: int = 1
) -> torch.Tensor:
    """Plain PyTorch ``hash_to_buckets`` (the murmur kernel's twin)."""
    check_table_size(table_size)
    return (murmur3_packed(keys, seed, lanes) % table_size).to(torch.int32)
