"""AdamW with decoupled weight decay and optional reduced-precision moments
(port of ``repro.optim.adamw``).

Parameters are a module's parameters or a dict of tensors (``{name:
tensor}``, see ``repro_torch.utils.named_leaves``); the state holds the step
and one moment pair a parameter, by name.  The update runs in f32 leaf by
leaf with the reference's arithmetic, and writes the parameters and the
moments in place (the moments in ``moment_dtype``): the PyTorch optimizer's
idiom, one leaf's temporaries at a time (two leaf-sized f32 temporaries
where everything is f32).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import named_leaves

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"  # "bfloat16" halves the optimizer's memory


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """``{"step": 0-d int32, "m": {name: zeros}, "v": {name: zeros}}`` on
    the parameters' device, the moments in ``cfg.moment_dtype``."""
    dt = DTYPES[cfg.moment_dtype]
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device if leaves else torch.device("cpu")
    zeros = lambda: {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in leaves.items()}
    return {"step": torch.zeros((), dtype=torch.int32, device=device), "m": zeros(), "v": zeros()}


@torch.no_grad()
def adamw_update(params, grads: dict, state: dict, lr, cfg: AdamWConfig):
    """One AdamW step, in place.  ``lr`` is a scalar (an f32 0-d tensor from a
    schedule, or a number); bias correction counts from step 1; decoupled
    decay applies to leaves with ``ndim >= 2`` only.  Returns ``(params,
    {"step": step + 1, "m", "v"})``: the same parameter and moment tensors,
    updated."""
    step = state["step"] + 1
    t = step.float()
    c1 = 1.0 - torch.pow(cfg.b1, t)
    c2 = 1.0 - torch.pow(cfg.b2, t)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    for name, p in named_leaves(params).items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float()
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        if m.dtype == v.dtype == p.dtype == torch.float32:
            # The same arithmetic in place: two leaf-sized temporaries at most.
            m.mul_(cfg.b1).add_(g * (1.0 - cfg.b1))
            v.mul_(cfg.b2).add_(g.square().mul_(1.0 - cfg.b2))
            del g
            den = (v / c2).sqrt_().add_(cfg.eps)
            update = (m / c1).div_(den)
            del den
            p.sub_(update.add_(p * wd).mul_(lr))
            continue
        mf = m.float() * cfg.b1 + (1.0 - cfg.b1) * g
        vf = v.float() * cfg.b2 + (1.0 - cfg.b2) * g.square()
        del g
        update = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        m.copy_(mf)
        v.copy_(vf)
        del mf, vf
        pf = p.float()
        p.copy_(pf - lr * (update + wd * pf))
    return params, {"step": step, "m": state["m"], "v": state["v"]}
