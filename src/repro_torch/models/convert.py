"""Carry LM parameters across packages as numpy arrays.

:func:`params_from_numpy` takes the reference's parameter pytree (nested
dicts of numpy arrays, the ``layers`` leaves with their leading
``num_periods`` axis) to the port's :class:`~repro_torch.models.transformer.Transformer`
on a device; :func:`params_to_numpy` reads it back in that layout.  The
port keeps the reference's matrix layout (``x @ w`` with ``w`` of shape
``(d_in, d_out)``), so nothing is transposed: the period axis is unstacked
into ``layers.<i>`` and each matrix is cast to the compute type (f32 → bf16
rounds to nearest even, as the reference's ``.astype(bfloat16)`` does);
norm vectors stay f32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _as_f32(arr) -> np.ndarray:
    """A float array as f32 numpy; bf16 arrays (``ml_dtypes``) widen exactly."""
    arr = np.asarray(arr)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return arr


def params_from_numpy(
    tree: dict, cfg: ArchConfig, *, device, dtype: Optional[torch.dtype] = None
) -> transformer.Transformer:
    """The port's parameters from the reference's pytree, on ``device``.

    Matrices are stored in ``dtype`` (default: the config's compute type),
    norm vectors in f32.  Raises on a missing, extra or misshapen leaf."""
    dtype = dtype or transformer.compute_dtype(cfg)
    model = transformer.Transformer(cfg, dtype=dtype, device="meta")
    want = dict(model.named_parameters())
    state = {}
    for name, arr in _flatten(tree).items():
        arr = _as_f32(arr)
        if name.startswith("layers."):
            rest = name[len("layers."):]
            if arr.shape[0] != cfg.num_periods:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != num_periods "
                                 f"{cfg.num_periods}")
            items = [(f"layers.{i}.{rest}", arr[i]) for i in range(cfg.num_periods)]
        else:
            items = [(name, arr)]
        for key, a in items:
            if key not in want:
                raise KeyError(f"{key}: no such parameter in the port")
            if tuple(a.shape) != tuple(want[key].shape):
                raise ValueError(f"{key}: shape {a.shape} != {tuple(want[key].shape)}")
            t = torch.from_numpy(np.array(a, dtype=np.float32))
            state[key] = t.to(device=device, dtype=want[key].dtype)
    missing = sorted(set(want) - set(state))
    if missing:
        raise KeyError(f"parameters missing from the pytree: {missing}")
    model.load_state_dict(state, assign=True)
    return model


def params_to_numpy(model: transformer.Transformer) -> dict:
    """The reference's pytree layout (f32 numpy, periods stacked on axis 0)."""
    cfg = model.cfg
    flat: dict = {}
    for name, t in model.state_dict().items():
        arr = t.detach().float().cpu().numpy()
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            flat.setdefault(f"layers.{rest}", [None] * cfg.num_periods)[int(i)] = arr
        else:
            flat[name] = arr
    tree: dict = {}
    for name, val in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.stack(val) if isinstance(val, list) else val
    return tree
