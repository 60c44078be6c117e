"""Carry LM parameters across packages as numpy arrays.

:func:`params_from_numpy` takes the reference's parameter pytree (nested
dicts of numpy arrays, the ``layers`` leaves with their leading
``num_periods`` axis; an encoder-decoder's ``enc_layers`` / ``dec_layers``
leaves with their leading ``encoder_layers`` / ``num_layers`` axis) to the
port's :class:`~repro_torch.models.transformer.Transformer` or
:class:`~repro_torch.models.encdec.EncoderDecoder` on a device;
:func:`params_to_numpy` reads it back in that layout.  The
port keeps the reference's matrix layout (``x @ w`` with ``w`` of shape
``(d_in, d_out)``), so nothing is transposed: the stacked axis is unstacked
into ``layers.<i>`` and each matrix is cast to the compute type (f32 → bf16
rounds to nearest even, as the reference's ``.astype(bfloat16)`` does);
norm vectors stay f32.  With a ``parallel`` mesh over the process group the
module holds this rank's block of every parameter
(``distributed.sharding.param_pspecs``), as ``build_model(cfg,
parallel).init`` makes them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.api import model_class


def stacked_groups(cfg: ArchConfig) -> dict:
    """The stacked groups of the reference's pytree and their leading axis:
    ``{"layers": num_periods}``, or an encoder-decoder's ``{"enc_layers":
    encoder_layers, "dec_layers": num_layers}``."""
    if cfg.is_encoder_decoder:
        return {"enc_layers": cfg.encoder_layers, "dec_layers": cfg.num_layers}
    return {"layers": cfg.num_periods}


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
    tree: dict, cfg: ArchConfig, *, device, dtype: Optional[torch.dtype] = None, parallel=None,
) -> torch.nn.Module:
    """The port's parameters from the reference's pytree, on ``device``
    (with ``parallel``: this rank's blocks).

    Matrices are stored in ``dtype`` (default: the config's compute type),
    norm vectors in f32.  Raises on a missing, extra or misshapen leaf."""
    dtype = dtype or transformer.compute_dtype(cfg)
    model = model_class(cfg)(cfg, dtype=dtype, device="meta")
    groups = stacked_groups(cfg)
    want = dict(model.named_parameters())
    specs = None
    if parallel is not None and parallel.mesh is not None:
        from repro_torch.distributed import sharding

        specs = sharding.param_pspecs(model, parallel)
    state = {}
    for name, arr in _flatten(tree).items():
        arr = _as_f32(arr)
        group, _, rest = name.partition(".")
        if group in groups and rest:
            n = groups[group]
            if arr.shape[0] != n:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != {n} stacked {group}")
            items = [(f"{group}.{i}.{rest}", arr[i]) for i in range(n)]
        else:
            items = [(name, arr)]
        for key, a in items:
            if key not in want:
                raise KeyError(f"{key}: no such parameter in the port")
            if tuple(a.shape) != tuple(want[key].shape):
                raise ValueError(f"{key}: shape {a.shape} != {tuple(want[key].shape)}")
            t = torch.from_numpy(np.array(a, dtype=np.float32))
            if specs is not None:
                t = sharding.block(t, specs[key], parallel.mesh).contiguous()
            state[key] = t.to(device=device, dtype=want[key].dtype)
    missing = sorted(set(want) - set(state))
    if missing:
        raise KeyError(f"parameters missing from the pytree: {missing}")
    if specs is not None:
        return transformer.set_params(model, state)
    model.load_state_dict(state, assign=True)
    return model


def params_to_numpy(model: torch.nn.Module) -> dict:
    """The reference's pytree layout (f32 numpy, periods or layers stacked
    on axis 0)."""
    groups = stacked_groups(model.cfg)
    flat: dict = {}
    for name, t in model.state_dict().items():
        arr = t.detach().float().cpu().numpy()
        group = name.partition(".")[0]
        if group in groups:
            _, i, rest = name.split(".", 2)
            flat.setdefault(f"{group}.{rest}", [None] * groups[group])[int(i)] = arr
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
