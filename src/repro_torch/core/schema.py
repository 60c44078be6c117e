"""Table schema — key width and payload shape (port of ``repro.core.schema``).

This slice carries the paper's layout only: uint32 keys and one int32 value
column.  PyTorch has no shifts, ``%`` or ``searchsorted`` for ``uint32``, so
keys travel as **int32 tensors holding the uint32 bit pattern** (the JAX
package's ``EMPTY_KEY = 0xFFFFFFFF`` is ``-1`` here).  Every routine that
needs unsigned order or arithmetic widens to int64 and masks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_KEY_DTYPES = ("uint32", "uint64")

LATER_SLICE = (
    "the port's next slice (u64x2 keys, multi-column values and the "
    "fingerprint lane)"
)


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


@dataclasses.dataclass(frozen=True)
class TableSchema:
    """Key width + payload shape of one hash table.

    Only ``TableSchema()`` (uint32 keys, one int32 column) is ported; the
    wider layouts raise ``NotImplementedError`` rather than computing
    something else.
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
        if self.key_dtype != "uint32" or int(self.value_cols) != 1:
            raise NotImplementedError(
                f"TableSchema({self.key_dtype!r}, {self.value_cols}) is not "
                f"ported yet; it belongs to {LATER_SLICE}"
            )

    def pack_keys(self, keys, device) -> torch.Tensor:
        """Canonical layout: ``(N,)`` int32 bit pattern of uint32 keys."""
        keys = u32_bits(keys).to(device)
        if keys.ndim != 1:
            raise ValueError(f"uint32 schema expects (N,) keys, got shape {tuple(keys.shape)}")
        return keys.contiguous()

    def pack_values(self, values, device) -> torch.Tensor:
        """Canonical payload layout: ``(N,)`` int32."""
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(np.ascontiguousarray(np.asarray(values)))
        values = values.to(device=device, dtype=torch.int32)
        if values.ndim == 2 and values.shape[-1] == 1:
            values = values[:, 0]
        if values.ndim != 1:
            raise ValueError(f"1-column schema expects (N,) values, got {tuple(values.shape)}")
        return values.contiguous()
