"""Global-norm gradient clipping (port of ``repro.optim.clip``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.utils import named_leaves, tree_global_norm


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, *, counted: Optional[dict] = None, axis=None):
    """Scale ``grads`` (a dict of tensors) in place so that their global L2
    norm is at most ``max_norm``.  Returns ``(grads, pre-clip norm)``.

    Over a mesh the leaves are a rank's blocks: ``counted`` (name → bool)
    says which of them this rank counts, so that each distinct block is
    counted once (``distributed.sharding.counts_block``), and the sums of
    squares are all-reduced over ``axis`` (a
    ``distributed.collectives.Axis`` over the group): every rank gets the
    same norm and the same scale."""
    if counted is None:
        norm = tree_global_norm(grads)
    else:
        leaves = named_leaves(grads)
        device = next(iter(leaves.values())).device
        sq = torch.zeros((), dtype=torch.float32, device=device)
        for name, g in leaves.items():
            if counted[name]:
                sq = sq + g.float().square().sum()
        norm = torch.sqrt(axis.all_reduce(sq.reshape(1))[0])
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in named_leaves(grads).values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm
