"""Table schema — key width and payload shape (port of ``repro.core.schema``).

A :class:`TableSchema` names the key dtype (``uint32`` or ``uint64``) and
the number of int32 payload columns ``C``; build, query, retrieve, join,
delete, upsert, fold and compact take every combination.

Representation (one rule for the whole port)
--------------------------------------------
PyTorch has no shifts, ``%`` or ``searchsorted`` for ``uint32`` and no
``uint64`` arithmetic, so keys travel as **int32 tensors holding uint32 lane
bits**:

* 1-lane keys (``uint32``): ``(N,)`` int32, the uint32 bit pattern (the JAX
  package's ``EMPTY_KEY = 0xFFFFFFFF`` is ``-1`` here).  Stacked on the
  shard axis: ``(D, N)``.
* 2-lane keys (``uint64``): ``(N, 2)`` int32, lane 0 the low word and lane
  1 the high word, as the reference's :func:`pack_u64`; stacked ``(D, N,
  2)``.  A contiguous ``(..., 2)`` pair viewed as int64 is the uint64 bit
  pattern (little-endian); XOR that view with ``-2**63`` and signed order
  is the reference's packed order (lane 1 most significant).  That int64
  "order view" is what ``torch.sort`` and ``torch.searchsorted`` take
  (``hashgraph.key_order``).
* EMPTY is all ones in every lane (``-1`` in each int32, ``-1`` in the
  int64 view), the largest key in either order, as the reference requires.
* Values are ``(N,)`` int32 for ``C = 1`` (unchanged) and ``(N, C)`` int32
  row-major for ``C > 1``, so a gather slot reads a row's C words together;
  stacked ``(D, N)`` / ``(D, N, C)``.
* The fingerprint lane is a ``(D, M)`` int32 field ``fingerprints`` of
  ``HashGraph`` (the uint32 bits of ``hashing.fingerprint32``), or ``None``.

Every routine that needs unsigned order or arithmetic widens to int64 and
masks.  :func:`pack_u64` / :func:`unpack_u64` convert numpy uint64 arrays
to and from the 2-lane layout on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_KEY_DTYPES = ("uint32", "uint64")


def pack_u64(keys) -> np.ndarray:
    """Host-side: numpy uint64 (or python ints) ``(N,)`` → ``(N, 2)`` uint32.

    Lane 0 is the low 32 bits, lane 1 the high 32 bits.
    """
    a = np.asarray(keys, dtype=np.uint64)
    lo = (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (a >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=-1)


def unpack_u64(packed) -> np.ndarray:
    """Host-side inverse of :func:`pack_u64`: ``(..., 2)`` uint32 or int32
    lanes (numpy or tensor) → np.uint64."""
    if isinstance(packed, torch.Tensor):
        packed = packed.detach().cpu().numpy()
    a = np.asarray(packed).astype(np.uint32)
    lo = a[..., 0].astype(np.uint64)
    hi = a[..., 1].astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def u32_bits(keys) -> torch.Tensor:
    """Host or device keys → int32 tensor carrying their uint32 bit pattern.

    numpy arrays and tensors of a 64-bit type are range-checked (a 1-lane
    schema rejects wide keys instead of wrapping them mod 2^32); 32-bit
    inputs are reinterpreted as they are.
    """
    if isinstance(keys, torch.Tensor):
        if keys.dtype == torch.int32:
            return keys
        if keys.dtype == torch.uint32:
            return keys.view(torch.int32)
        wide = keys.to(torch.int64)
        if bool(((wide < 0) | (wide > 0xFFFFFFFF)).any()):
            raise ValueError(
                "uint32 schema got key values out of range; "
                "use TableSchema('uint64')"
            )
        return torch.where(wide >= 2**31, wide - 2**32, wide).to(torch.int32)
    a = np.asarray(keys)
    if a.dtype in (np.uint64, np.int64) and (
        (a < 0).any() or (a > 0xFFFFFFFF).any()
    ):
        raise ValueError(
            "uint32 schema got 64-bit key values out of range; "
            "use TableSchema('uint64')"
        )
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.uint32)).view(np.int32))


def u64_lanes(keys) -> torch.Tensor:
    """Host or device 64-bit keys → ``(N, 2)`` int32 lane bits.

    Takes numpy uint64 / non-negative int64 ``(N,)`` (split into lanes), a
    numpy ``(N, 2)`` array of 32-bit lanes, a tensor of ``torch.uint64``
    (the bit pattern) or non-negative int64 ``(N,)``, or a tensor ``(N, 2)``
    of 32-bit lanes; other layouts are returned for the caller's shape
    check.
    """
    if isinstance(keys, torch.Tensor):
        if keys.ndim == 1 and keys.dtype in (torch.int64, torch.uint64):
            if keys.dtype == torch.int64 and bool((keys < 0).any()):
                raise ValueError("uint64 schema got negative int64 keys")
            return keys.contiguous().view(torch.int32).reshape(-1, 2)
        if keys.dtype == torch.uint32:
            return keys.view(torch.int32)
        return keys.to(torch.int32) if keys.dtype != torch.int32 else keys
    a = np.asarray(keys)
    if a.dtype in (np.uint64, np.int64) and a.ndim == 1:
        if a.dtype == np.int64 and (a < 0).any():
            raise ValueError("uint64 schema got negative int64 keys")
        a = pack_u64(a.astype(np.uint64))
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.uint32)).view(np.int32))


@dataclasses.dataclass(frozen=True)
class TableSchema:
    """Key width + payload shape of one hash table.

    ``key_dtype`` — ``"uint32"`` (1 lane) or ``"uint64"`` (2 lanes).
    ``value_cols`` — number of int32 payload columns (1 keeps the 1-D
    layout; > 1 stores ``(N, C)``).
    """

    key_dtype: str = "uint32"
    value_cols: int = 1

    def __post_init__(self):
        if self.key_dtype not in _KEY_DTYPES:
            raise ValueError(
                f"key_dtype must be one of {_KEY_DTYPES}, got {self.key_dtype!r}"
            )
        if not 1 <= int(self.value_cols):
            raise ValueError(f"value_cols must be >= 1, got {self.value_cols}")

    @property
    def key_lanes(self) -> int:
        return 2 if self.key_dtype == "uint64" else 1

    def pack_keys(self, keys, device) -> torch.Tensor:
        """Canonical layout: ``(N,)`` int32 (uint32) or ``(N, 2)`` int32
        lanes (uint64), on ``device``."""
        if self.key_lanes == 1:
            keys = u32_bits(keys).to(device)
            if keys.ndim != 1:
                raise ValueError(
                    f"uint32 schema expects (N,) keys, got shape {tuple(keys.shape)}"
                )
        else:
            keys = u64_lanes(keys).to(device)
            if keys.ndim != 2 or keys.shape[-1] != 2:
                raise ValueError(
                    f"uint64 schema expects (N,) uint64 or (N, 2) packed uint32 keys "
                    f"(see schema.pack_u64), got shape {tuple(keys.shape)}"
                )
        return keys.contiguous()

    def pack_values(self, values, device) -> torch.Tensor:
        """Canonical payload layout: ``(N,)`` or ``(N, C)`` int32."""
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(np.ascontiguousarray(np.asarray(values)))
        values = values.to(device=device, dtype=torch.int32)
        if self.value_cols == 1:
            if values.ndim == 2 and values.shape[-1] == 1:
                values = values[:, 0]
            if values.ndim != 1:
                raise ValueError(
                    f"1-column schema expects (N,) values, got {tuple(values.shape)}"
                )
        elif values.ndim != 2 or values.shape[-1] != self.value_cols:
            raise ValueError(
                f"schema expects (N, {self.value_cols}) values, "
                f"got shape {tuple(values.shape)}"
            )
        return values.contiguous()

    def default_values(self, n: int, device) -> torch.Tensor:
        """Row ids ``arange(n)``, the 1-column default payload; a
        multi-column schema needs explicit values, as in the reference."""
        if self.value_cols != 1:
            raise ValueError(
                f"schema has {self.value_cols} value columns; "
                "pass explicit values (the row-id default is 1-column)"
            )
        return torch.arange(n, dtype=torch.int32, device=device)
