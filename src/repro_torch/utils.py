"""Small shared helpers (the port's copy of ``repro.utils.cdiv``)."""
from __future__ import annotations

import contextlib

import torch


def cdiv(a: int, b: int) -> int:
    """Ceiling division of non-negative integers."""
    return -(-a // b)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[s, idx[s, i], ...]`` of a ``(D, M)`` or ``(D, M, W)`` array: rows
    gathered along dim 1, a trailing dim (key lanes, value columns) riding
    along."""
    if x.ndim == idx.ndim:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx.unsqueeze(-1).expand(*idx.shape, x.shape[-1]))


def on_stream(stream):
    """``torch.cuda.stream(stream)``, or no context for ``None`` (the CPU)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
