"""Name-based sharding rules: parameters and caches → specs (port of
``repro.distributed.sharding``).

A spec is a tuple with one entry a dim: ``None`` (whole), an axis name, or
a tuple of axis names (their product, row-major), as a ``PartitionSpec``'s
entries.  Rules are *logical*: every leaf is classified by the last
component of its name into Megatron-style roles, then physical axes are
assigned only when the dimension divides the axis size (otherwise that dim
stays whole — keeps whisper-base's odd vocab safe).

Roles (trailing-dim logic; the reference's scanned stacks carry a leading
``num_periods`` dim which is never sharded — the port's layers are a list,
``layers.<i>``, so its own leaves have none):

* **column-parallel** (out-features on ``tp``): wq/wk/wv, w_gate/w_up,
  w_in, w_rec, w_if, w_a, w_x, lm_head.
* **row-parallel** (in-features on ``tp``): wo, w_down, w_out.
* **embed** (V, D): vocab on ``tp`` only.
* everything else: FSDP only.

FSDP assigns the ``dp`` axes to the largest still-unsharded dim.  KV caches
shard batch on ``dp`` and heads on ``tp`` when the head count divides;
otherwise the *sequence* dim goes on ``tp`` (sequence-sharded cache —
required for kv_heads=1 archs).  A ring cache's ``kpos`` (P, B, W) follows
its ``k``: whole over tp where ``k`` is split by heads, split along W where
``k`` is split along its slots (the reference's rule alone would put W on
tp in both cases).

Expert parallelism (``moe_impl="ep"`` where the reference takes EP): an
MoE layer's expert stacks (E, d, f) are dealt by owner over the ep axes
(:class:`Owners`): a rank holds only the experts it runs, not an FSDP
block, and its tp block of their ``f`` as the MLP's.  The reference
replicates the stacks into its ``shard_map`` (GSPMD gathers them); the
values a rank computes with are the same.

:func:`block` is the counterpart of the reference's ``to_named``: it cuts a
whole tensor into this rank's block; :func:`gather` is its inverse over the
group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.parallel import ParallelConfig, mesh_shape

# Last-path-component names → role.
_COL_PARALLEL = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_rec", "w_if",
    "w_a", "w_x", "lm_head",
}
_ROW_PARALLEL = {"wo", "w_down", "w_out"}
_EMBED = {"embed"}
_REPLICATED = {
    "norm", "norm1", "norm2", "norm_x", "out_norm", "final_norm", "enc_norm",
    "dec_norm", "q_norm", "k_norm", "b", "b_in", "b_out", "b_a", "b_x",
    "conv_b", "lambda", "r", "conv_w", "pos_emb",
}
_EXPERT_STACKS = {"w_gate", "w_up", "w_down"}  # (E, d_in, d_out) under an MoE


@dataclasses.dataclass(frozen=True)
class Owners:
    """A spec entry for the expert axis (of ``experts``) under expert
    parallelism: each rank of the ep ``axes`` (row-major index r of D) holds
    the experts it owns, ``r, r + D, ...`` when D < E and expert ``r % E``
    when D >= E (``models.moe.owned_experts``), not a contiguous block."""

    axes: tuple
    experts: int

    def count(self, size: int) -> int:
        """Experts a rank holds over ``size`` ranks."""
        return 1 if size >= self.experts else self.experts // size


def _path(path) -> Tuple[str, ...]:
    """A leaf's path as a tuple of names: a dotted string is split."""
    if isinstance(path, str):
        return tuple(path.split("."))
    return tuple(str(p) for p in path)


def _leaf_name(path) -> str:
    """Last component of a leaf's name."""
    parts = _path(path)
    return parts[-1] if parts else ""


def _axis_size(mesh_shape: dict, axes) -> int:
    if isinstance(axes, Owners):
        axes = axes.axes
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh_shape.get(axes, 1)
    n = 1
    for a in axes:
        n *= mesh_shape.get(a, 1)
    return n


def param_spec(
    path,
    shape: Tuple[int, ...],
    *,
    dp_axes: Tuple[str, ...],
    tp_axis: Optional[str],
    mesh_shape: dict,
    scanned: bool = False,
    ep_axes: Optional[Tuple[str, ...]] = None,
) -> tuple:
    """The spec of one parameter leaf (``path``: a dotted name or a tuple of
    names; ``scanned``: a leading period dim, as the reference's stacks;
    ``ep_axes``: expert parallelism over them, :class:`Owners`)."""
    name = _leaf_name(path)
    ndim = len(shape)
    spec: list = [None] * ndim
    # dims eligible for sharding (skip the leading scan dim of layer stacks)
    first = 1 if (scanned and ndim >= 2) else 0
    tp_size = _axis_size(mesh_shape, tp_axis)
    dp_size = _axis_size(mesh_shape, dp_axes)

    def try_assign(dim: int, axes) -> bool:
        size = _axis_size(mesh_shape, axes)
        if spec[dim] is None and size > 1 and shape[dim] % size == 0:
            spec[dim] = axes
            return True
        return False

    owners = False
    if ep_axes and name in _EXPERT_STACKS and ndim - first == 3:
        dvs, e = _axis_size(mesh_shape, tuple(ep_axes)), shape[first]
        if dvs > 1 and (dvs % e == 0 or e % dvs == 0):
            spec[first] = Owners(tuple(ep_axes), e)
            owners = True
    if ndim - first >= 2 and name not in _REPLICATED:
        if name in _EMBED:
            # vocab over tp only (the reference measured FSDP of d_model
            # poisoning GSPMD's propagation).
            if tp_axis:
                try_assign(first, tp_axis)
        elif name in _COL_PARALLEL and tp_axis and tp_size > 1:
            try_assign(ndim - 1, tp_axis)
        elif name in _ROW_PARALLEL and tp_axis and tp_size > 1:
            try_assign(ndim - 2, tp_axis)
        # FSDP: dp axes on the largest remaining unsharded dim.
        if dp_size > 1 and name not in _EMBED and not owners:
            order = sorted(range(first, ndim), key=lambda d: shape[d], reverse=True)
            for d in order:
                if try_assign(d, dp_axes):
                    break
    return tuple(spec)


def is_scanned_layer(path) -> bool:
    """A leaf of the reference's scanned stacks (``layers``, ``enc_layers``,
    ``dec_layers``)."""
    return any(p in ("layers", "enc_layers", "dec_layers") for p in _path(path))


def _leaves(tree) -> dict:
    """Name → leaf (anything with ``.shape``) of a module, a dict of leaves
    or a dict of block caches."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def param_pspecs(params_shapes: Any, parallel: ParallelConfig) -> dict:
    """Name → spec of every parameter of the port's module (or a name →
    shape-carrier dict).  The port's layers are unscanned leaves.  Under
    ``moe_impl="ep"`` the expert stacks are dealt by owner over the ep axes,
    which must then be the dp axes (the exchange runs over the dp group)."""
    shape = mesh_shape(parallel.mesh)
    ep_axes = None
    if parallel.moe_impl == "ep":
        ep_axes = tuple(parallel.ep_axes_)
        if ep_axes != tuple(parallel.dp_axes) and _axis_size(shape, ep_axes) > 1:
            raise ValueError(f"expert parallelism runs over the dp axes {parallel.dp_axes}, "
                             f"not {ep_axes}")
    return {
        name: param_spec(name, tuple(leaf.shape), dp_axes=parallel.dp_axes,
                         tp_axis=parallel.tp_axis, mesh_shape=shape, ep_axes=ep_axes)
        for name, leaf in _leaves(params_shapes).items()
    }


def cache_leaf_spec(shape: Tuple[int, ...], parallel: ParallelConfig) -> tuple:
    """The spec of one decode-cache leaf (stacked ``(num_periods, B, ...)``):

    * KV caches ``(P, B, KV, S, hd)``: B on dp; KV on tp when divisible,
      else S on tp (sequence-sharded decode — kv_heads < tp_size).
    * recurrent states ``(P, B, D...)``: B on dp; widest trailing dim on tp.
    """
    mesh = mesh_shape(parallel.mesh)
    dp_axes, tp_axis = parallel.dp_axes, parallel.tp_axis
    dp_size = _axis_size(mesh, dp_axes)
    tp_size = _axis_size(mesh, tp_axis)
    ndim = len(shape)
    if ndim < 2:
        return ()
    spec: list = [None] * ndim
    if dp_size > 1 and shape[1] % dp_size == 0:
        spec[1] = dp_axes  # batch
    if tp_axis and tp_size > 1 and ndim >= 3:
        # prefer heads (dim 2 of 5-dim KV), else sequence, else widest.
        if ndim == 5:
            cands = [2, 3]  # (P, B, KV, S, hd): heads, then seq
        else:
            cands = sorted(range(2, ndim), key=lambda d: shape[d], reverse=True)
        for d in cands:
            if spec[d] is None and shape[d] % tp_size == 0 and shape[d] >= tp_size:
                spec[d] = tp_axis
                break
    return tuple(spec)


def cache_pspecs(cache_shapes: Any, parallel: ParallelConfig) -> dict:
    """Specs of a decode-cache dict ``{"b<j>": NamedTuple of stacked
    leaves}``, in the same structure; a ring's ``kpos`` (P, B, W) takes its
    ``k``'s batch and slot entries."""
    out = {}
    for name, c in cache_shapes.items():
        specs = [cache_leaf_spec(tuple(getattr(t, "shape", t)), parallel) for t in c]
        if getattr(c, "_fields", ())[-1:] == ("kpos",):
            k = specs[0]
            specs[-1] = (k[0], k[1], k[3]) if k else ()
        out[name] = type(c)(*specs)
    return out


def batch_pspec(shape_len: int, parallel: ParallelConfig) -> tuple:
    """(B, ...) input batch: batch dim over dp axes."""
    if parallel.mesh is None or not parallel.dp_axes:
        return ()
    return (parallel.dp_axes, *([None] * (shape_len - 1)))


def spec_summary(params_shapes: Any, specs: dict, max_rows: int = 0) -> str:
    """Human-readable table of leaf → shape → spec."""
    rows = [f"{name:70s} {str(tuple(leaf.shape)):28s} {specs[name]}"
            for name, leaf in _leaves(params_shapes).items()]
    if max_rows:
        rows = rows[:max_rows]
    return "\n".join(rows)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def shard_bytes_per_device(shapes: Any, specs: dict, mesh_shape: dict) -> int:
    """Static per-device bytes of a sharded set of leaves (name → leaf with
    ``.shape`` and ``.dtype``; ``specs`` by the same names)."""
    total = 0
    for name, leaf in _leaves(shapes).items():
        n = math.prod(leaf.shape) if len(leaf.shape) else 1
        for dim, entry in enumerate(specs[name]):
            if isinstance(entry, Owners):
                n = n // leaf.shape[dim] * entry.count(_axis_size(mesh_shape, entry))
            elif entry is not None:
                n = -(-n // _axis_size(mesh_shape, entry))
        total += n * _itemsize(leaf.dtype)
    return total


def _entry_index(entry, coord: dict, shape: dict) -> tuple[int, int]:
    """(this rank's index, the entry's size) of one spec entry."""
    if isinstance(entry, Owners):
        entry = entry.axes
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    idx, size = 0, 1
    for a in axes:
        idx = idx * shape[a] + coord.get(a, 0)
        size *= shape[a]
    return idx, size


def block_slices(full_shape, spec: tuple, mesh, coord: Optional[dict] = None) -> tuple:
    """The slices that cut this rank's block out of a whole tensor of
    ``full_shape`` under ``spec``."""
    from repro_torch.distributed import collectives

    shape = mesh_shape(mesh)
    coord = collectives.coordinate(mesh) if coord is None else coord
    out = []
    for n, entry in zip(full_shape, tuple(spec) + (None,) * (len(full_shape) - len(spec))):
        if entry is None:
            out.append(slice(None))
            continue
        idx, size = _entry_index(entry, coord, shape)
        if isinstance(entry, Owners):
            out.append(slice(idx % n, None, size))
            continue
        if n % size:
            raise ValueError(f"dim of {n} does not divide over {entry} ({size})")
        b = n // size
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


def block(full: torch.Tensor, spec: tuple, mesh, coord: Optional[dict] = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``full`` (a view)."""
    return full[block_slices(tuple(full.shape), spec, mesh, coord)]


def local_shape(full_shape, spec: tuple, mesh_shape_: dict) -> tuple:
    """The shape of a rank's block of ``full_shape`` under ``spec``."""
    out = []
    for n, entry in zip(full_shape, tuple(spec) + (None,) * (len(full_shape) - len(spec))):
        if isinstance(entry, Owners):
            out.append(entry.count(_axis_size(mesh_shape_, entry)))
        else:
            out.append(n if entry is None else n // _axis_size(mesh_shape_, entry))
    return tuple(out)


def gather(local: torch.Tensor, spec: tuple, parallel: ParallelConfig, axes) -> torch.Tensor:
    """The whole tensor from every rank's ``local`` block (the inverse of
    :func:`block`): one all-gather per sharded dim over ``axes = (dp, tp)``
    (``collectives.bind``).  Every rank gets it."""
    dp, tp = axes
    out = local
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        if isinstance(entry, Owners):  # every rank's experts, back in expert order
            every = dp.all_gather(out, dim).movedim(dim, 0)
            if dp.size >= entry.experts:  # expert r % E on rank r: the first E ranks
                whole = every[:entry.experts]
            else:  # rank r's j-th expert is r + j·D
                whole = every.reshape(dp.size, -1, *every.shape[1:]).transpose(0, 1)
                whole = whole.reshape(entry.experts, *every.shape[1:])
            out = whole.movedim(0, dim)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        if names == ((parallel.tp_axis,) if parallel.tp_axis else ()):
            out = tp.all_gather(out, dim)
        elif names == tuple(parallel.dp_axes):
            out = dp.all_gather(out, dim)
        else:
            raise ValueError(f"spec entry {entry} is neither the tp axis nor the dp axes")
    return out


def opt_state_pspecs(param_specs: dict, grad_compression: bool = False) -> dict:
    """The AdamW state's specs (ZeRO): ``m`` and ``v``, and ``ef_error``
    under ``grad_compression``, take each parameter's spec; ``step`` is
    replicated (the reference's ``Trainer._shardings``)."""
    out = {"step": (), "m": dict(param_specs), "v": dict(param_specs)}
    if grad_compression:
        out["ef_error"] = dict(param_specs)
    return out


def flat_pspecs(tree: dict, prefix: str = "") -> dict:
    """Dotted name → spec of a nested dict of specs, by the names
    ``repro_torch.utils.named_leaves`` gives the matching tree of tensors."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat_pspecs(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = tuple(val)
    return out


class TreeSharding:
    """Where each leaf of a flattened tree lies over a mesh: ``specs`` (dotted
    name → spec) and this rank's axes of ``layout`` (a
    ``models.layers.Layout`` of the bundle).  :meth:`whole` gathers a leaf
    from every rank's block, :meth:`block` cuts this rank's block of a
    whole leaf; ``writer`` is the group's rank 0, :meth:`barrier` waits for
    every rank of the group.  A checkpoint written under one mesh restores
    under another (``CheckpointManager``)."""

    def __init__(self, specs: dict, layout):
        from repro_torch.distributed import collectives

        self.specs = dict(specs)
        self.parallel = layout.parallel
        self.axes = (layout.dp, layout.tp)
        self.coord = layout.coord
        self._world = collectives.world()

    @property
    def writer(self) -> bool:
        return self._world.index == 0

    def whole(self, name: str, local: torch.Tensor) -> torch.Tensor:
        return gather(local, self.specs[name], self.parallel, self.axes)

    def block(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return block(full, self.specs[name], self.parallel.mesh, self.coord)

    def barrier(self) -> None:
        self._world.barrier()


def counts_block(spec: tuple, mesh, coord: dict) -> bool:
    """Whether this rank counts its block of a leaf of ``spec`` in a sum over
    the group's distinct blocks: it does at index 0 of every mesh axis the
    spec leaves the leaf whole over (one copy of each block), and for
    experts dealt by owner on the first E ranks of the ep axes (the others
    repeat them)."""
    used = set()
    shape = mesh_shape(mesh)
    for entry in spec:
        if isinstance(entry, Owners):
            if _entry_index(entry, coord, shape)[0] >= entry.experts:
                return False
            entry = entry.axes
        if entry is not None:
            used.update((entry,) if isinstance(entry, str) else entry)
    return all(coord.get(a, 0) == 0 for a in mesh_shape(mesh) if a not in used)
