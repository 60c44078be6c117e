"""Small shared helpers: the port's copies of ``repro.utils.cdiv`` and of
the tree helpers of ``repro.utils.treeutil`` (``tree_param_count``,
``tree_size_bytes``, ``tree_global_norm``), which take a module's
parameters or a (nested) dict of tensors where the reference takes a
pytree."""
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


def named_leaves(tree, prefix: str = "") -> dict:
    """``{name: tensor}`` of a tree: an ``nn.Module``'s named parameters, a
    (nested) dict's tensors by dotted path (keys sorted, as a pytree
    flattens a dict), a tensor as itself under ``prefix``."""
    if isinstance(tree, torch.nn.Module):
        return {prefix + name: p for name, p in tree.named_parameters()}
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(named_leaves(tree[key], f"{prefix}{key}."))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1] if prefix.endswith(".") else prefix: tree}
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_param_count(tree) -> int:
    """Total number of elements over the tree's tensors (meta tensors too)."""
    return sum(t.numel() for t in named_leaves(tree).values())


def tree_size_bytes(tree) -> int:
    """Total bytes over the tree's tensors (meta tensors too)."""
    return sum(t.numel() * t.element_size() for t in named_leaves(tree).values())


def tree_global_norm(tree) -> torch.Tensor:
    """Global L2 norm over the tree's tensors, an f32 scalar (each leaf's
    sum of squares in f32, summed in leaf order)."""
    leaves = list(named_leaves(tree).values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(l.detach().float().square().sum() for l in leaves)
    return torch.sqrt(sq)
