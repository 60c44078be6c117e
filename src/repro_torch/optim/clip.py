"""Global-norm gradient clipping (port of ``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.utils import named_leaves, tree_global_norm


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` (a dict of tensors) in place so that their global L2
    norm is at most ``max_norm``.  Returns ``(grads, pre-clip norm)``."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in named_leaves(grads).values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm
