"""Small shared helpers (the port's copy of ``repro.utils.cdiv``)."""
from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    """Ceiling division of non-negative integers."""
    return -(-a // b)
