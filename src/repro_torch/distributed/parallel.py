"""Parallelism configuration threaded through the model and serving builders
(port of ``repro.distributed.parallel``).

Axis roles on a mesh, as in the reference:

* ``dp_axes`` — data parallel + FSDP parameter sharding (``("pod", "data")``
  multi-pod, ``("data",)`` single-pod).
* ``tp_axis`` — tensor parallel (heads / d_ff / vocab).
* ``ep_axes`` — expert-parallel dispatch axes for MoE (defaults to
  ``dp_axes``).

The reference gets the layout from GSPMD: ``jit`` with ``NamedSharding``s.
The port has no partitioner: ``mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names`` over
the process group, each rank holds the block of every parameter and cache
its spec gives it (``distributed/sharding.py``), and the block code issues
the collectives (``distributed/collectives.py``) that make the result the
unsharded model's.  An :class:`AbstractMesh` carries axis sizes only: it is
enough for the sharding rules, as ``jax.sharding.AbstractMesh`` is in the
reference's tests, and over a live group of its size the ranks take its
row-major order.

:meth:`ParallelConfig.shard_act` is the residual stream's layout per rank.
``act_barrier`` (the reference's ``optimization_barrier``, an XLA scheduling
hint) has no counterpart in eager PyTorch: it is accepted and does nothing.
``microbatches``, ``remat`` and ``grad_compression`` are the train step's
(``train.step``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, no devices (``jax.sharding.AbstractMesh``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} and {self.axis_names} differ in length")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_shape(mesh) -> dict:
    """Axis name → size of an :class:`AbstractMesh` or a ``DeviceMesh``; ``{}``
    for ``None``."""
    if mesh is None:
        return {}
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to carry parallel axes")
    return dict(zip(names, tuple(mesh.shape)))


def mesh_ranks(mesh) -> torch.Tensor:
    """The global rank at every coordinate of ``mesh`` (row-major for an
    :class:`AbstractMesh`)."""
    if isinstance(mesh, AbstractMesh):
        return torch.arange(mesh.size).reshape(mesh.axis_sizes)
    return mesh.mesh.cpu()


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    mesh: Optional[object]
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: Optional[str] = "model"
    ep_axes: Optional[Tuple[str, ...]] = None  # None → dp_axes
    moe_impl: str = "dense"  # dense | ep
    # serve-time options
    seq_shard_decode: bool = False  # shard KV cache over tp_axis on seq dim
    # train-time options
    microbatches: int = 1  # gradient accumulation steps
    remat: bool = True
    grad_compression: bool = False  # int8 + error feedback on dp all-reduce
    seq_parallel: bool = False  # residual stream sequence-sharded over tp
    act_barrier: bool = False  # an XLA hint in the reference; a no-op here

    @property
    def ep_axes_(self) -> Tuple[str, ...]:
        return self.ep_axes if self.ep_axes is not None else self.dp_axes

    @property
    def dp_spec(self) -> tuple:
        return (self.dp_axes,)

    def batch_spec(self, extra_dims: int = 1) -> tuple:
        """(B, ...) activations: batch over dp axes, rest replicated."""
        return (self.dp_axes, *([None] * extra_dims))

    def num_devices(self, axes: Tuple[str, ...]) -> int:
        if self.mesh is None:
            return 1
        shape = mesh_shape(self.mesh)
        n = 1
        for a in axes:
            n *= shape[a]
        return n

    @property
    def dp_size(self) -> int:
        return self.num_devices(self.dp_axes)

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return mesh_shape(self.mesh)[self.tp_axis]

    def act_spec(self, shape, *, batch_dim: int = 0, seq_dim: Optional[int] = 1) -> tuple:
        """The reference's ``shard_act`` constraint as a spec: batch over dp
        (+ seq over tp under sequence parallelism); ``None`` where a dim does
        not divide, everywhere off-mesh or below 2 dims."""
        spec: list = [None] * len(shape)
        if self.mesh is None or len(shape) < 2:
            return tuple(spec)
        if self.dp_axes and self.dp_size > 1 and shape[batch_dim] % self.dp_size == 0:
            spec[batch_dim] = self.dp_axes
        if (self.seq_parallel and seq_dim is not None and self.tp_axis and self.tp_size > 1
                and shape[seq_dim] % self.tp_size == 0):
            spec[seq_dim] = self.tp_axis
        return tuple(spec)

    def shard_act(self, x: torch.Tensor, *, batch_dim: int = 0,
                  seq_dim: Optional[int] = 1) -> torch.Tensor:
        """This rank's block of a whole activation ``x`` under
        :meth:`act_spec` (a view; ``x`` itself off-mesh)."""
        from repro_torch.distributed import sharding

        spec = self.act_spec(tuple(x.shape), batch_dim=batch_dim, seq_dim=seq_dim)
        if all(s is None for s in spec):
            return x
        return sharding.block(x, spec, self.mesh)


def single_device_parallel() -> ParallelConfig:
    """Degenerate config for one device (no mesh, dense MoE)."""
    return ParallelConfig(mesh=None, dp_axes=(), tp_axis=None, moe_impl="dense")
