"""The collectives a sharded model's blocks issue, over one mesh axis (the
port's own: the reference leaves them to GSPMD).

:func:`bind` turns a :class:`~repro_torch.distributed.parallel.ParallelConfig`
into this rank's two :class:`Axis` objects: ``tp`` (the ranks that differ
only in the tensor-parallel coordinate) and ``dp`` (those that differ only
in the data-parallel coordinates, row-major over ``dp_axes``).  Each holds
its own ``torch.distributed`` group, created with the group's timeout, so a
rank that stops answering fails the others' calls instead of hanging them.

Every call over an axis of size 1 is the identity and issues nothing.
Every other call is counted with :func:`repro_torch.counting.record_collective`
(``"all_reduce"``, ``"all_gather"``, ``"reduce_scatter"``, ``"broadcast"``)
with the bytes of this rank's input.  Over gloo a CUDA buffer is staged
through pinned host memory (several ranks may share one card), and a
reduce-scatter is an all-reduce and a slice: gloo's own reduce-scatter took
1.6x its all-reduce on 4 CPU processes.  Sums run in the input's type, as
GSPMD's partial sums do.
"""
from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence

import torch

from repro_torch import counting
from repro_torch.distributed.parallel import ParallelConfig, mesh_ranks, mesh_shape


class Axis:
    """This rank's place along one mesh axis (or a product of axes): ``size``
    ranks, this rank at ``index``, the group ``pg`` over them in index
    order."""

    def __init__(self, size: int = 1, index: int = 0, pg=None, backend: Optional[str] = None):
        self.size, self.index, self.pg, self.backend = int(size), int(index), pg, backend

    def __repr__(self) -> str:
        return f"Axis(size={self.size}, index={self.index}, backend={self.backend!r})"

    # -- transport ------------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _buffer(self, like: torch.Tensor, shape=None) -> torch.Tensor:
        """An empty buffer for the wire: pinned host memory under gloo for a
        CUDA tensor, else on ``like``'s device."""
        shape = tuple(like.shape) if shape is None else tuple(shape)
        if self._staged(like):
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` the backend may overwrite (on the host for gloo)."""
        return self._buffer(t).copy_(t)

    def _home(self, wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """``wire`` on ``like``'s device.  The copy back from pinned memory is
        asynchronous: the card's queue orders it before the kernels that read
        it, and the host allocator keeps the buffer until it is done."""
        return wire.to(like.device, non_blocking=True) if self._staged(like) else wire

    def _gather_parts(self, x: torch.Tensor) -> list:
        import torch.distributed as dist

        wire = self._wire(x)
        parts = [self._buffer(x) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.pg)
        return [self._home(p, x) for p in parts]

    # -- collectives ------------------------------------------------------------
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, the same bits on every rank."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        counting.record_collective("all_reduce", x.numel() * x.element_size())
        wire = self._wire(x)
        dist.all_reduce(wire, group=self.pg)
        return self._home(wire, x)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in index order."""
        if self.size == 1:
            return x
        counting.record_collective("all_gather", x.numel() * x.element_size())
        return torch.cat(self._gather_parts(x), dim=dim)

    def all_gather_cols(self, xs: Sequence[torch.Tensor]) -> list:
        """Several column blocks in one all-gather: each ``xs[i]`` (the same
        leading dims) becomes every rank's block of it concatenated along
        the last dim."""
        if self.size == 1:
            return list(xs)
        widths = [x.shape[-1] for x in xs]
        packed = torch.cat(list(xs), dim=-1)
        counting.record_collective("all_gather", packed.numel() * packed.element_size())
        parts = self._gather_parts(packed)
        out, at = [], 0
        for w in widths:
            out.append(torch.cat([p[..., at:at + w] for p in parts], dim=-1))
            at += w
        return out

    def all_gather_bytes(self, xs: Sequence[torch.Tensor]) -> list:
        """Contiguous tensors of any types in one all-gather of their bytes:
        for each ``xs[i]`` the list of every rank's copy, in index order."""
        if self.size == 1:
            return [[x] for x in xs]
        flat = [x.reshape(-1).view(torch.uint8) for x in xs]
        packed = torch.cat(flat)
        counting.record_collective("all_gather", packed.numel())
        parts = self._gather_parts(packed)
        out, at = [], 0
        for x, f in zip(xs, flat):
            n = f.numel()
            out.append([p[at:at + n].view(x.dtype).reshape(x.shape) for p in parts])
            at += n
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of every rank's ``x``."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {self.size} ranks")
        counting.record_collective("reduce_scatter", x.numel() * x.element_size())
        block = n // self.size
        if self.backend == "gloo":
            wire = self._wire(x)
            dist.all_reduce(wire, group=self.pg)
            mine = wire.narrow(dim, self.index * block, block)
            return self._home(self._buffer(x, mine.shape).copy_(mine), x)
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((block,) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, src, group=self.pg)
        return out.movedim(0, dim)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """The ``x`` of the rank at index ``src``, on every rank."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        counting.record_collective("broadcast", x.numel() * x.element_size())
        wire = self._wire(x)
        dist.broadcast(wire, src=dist.get_global_rank(self.pg, src), group=self.pg)
        return self._home(wire, x)

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of a whole ``x`` along ``dim`` (a view)."""
        if self.size == 1:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)


SINGLE = Axis()


def _groups(ranks: torch.Tensor, names: tuple, axes: tuple, me: int, backend, timeout):
    """One group per fiber of ``axes`` (every rank creates every group, in
    the same order); returns ``(size, index, group)`` of the one holding
    ``me``."""
    import torch.distributed as dist

    along = [names.index(a) for a in axes]
    other = [i for i in range(len(names)) if i not in along]
    perm = other + along
    fibers = ranks.permute(*perm).reshape(-1, math.prod(ranks.shape[i] for i in along))
    mine = None
    for fiber in fibers.tolist():
        pg = dist.new_group(fiber, backend=backend, timeout=timeout)
        if me in fiber:
            mine = (len(fiber), fiber.index(me), pg)
    return mine


def bind(parallel: Optional[ParallelConfig], timeout_s: Optional[float] = None):
    """This rank's ``(dp, tp)`` axes of ``parallel``'s mesh (a collective:
    every rank of the group calls it alike).  Off-mesh, or on a mesh of one
    device, both are :data:`SINGLE`.  Raises ``ValueError`` when the mesh's
    size is not the group's."""
    import torch.distributed as dist

    if parallel is None or parallel.mesh is None:
        return SINGLE, SINGLE
    shape = mesh_shape(parallel.mesh)
    size = math.prod(shape.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if size != world:
        raise ValueError(f"a mesh of {size} devices {shape} over a group of {world} "
                         f"rank{'s' if world != 1 else ''}")
    if size == 1:
        return SINGLE, SINGLE
    names = tuple(shape)
    ranks = mesh_ranks(parallel.mesh)
    me = dist.get_rank()
    backend = str(dist.get_backend()).lower()
    timeout = datetime.timedelta(seconds=float(timeout_s)) if timeout_s else None
    axes = {}
    for role, group_axes in (("dp", tuple(parallel.dp_axes)),
                             ("tp", (parallel.tp_axis,) if parallel.tp_axis else ())):
        if not group_axes:
            axes[role] = SINGLE
            continue
        n, idx, pg = _groups(ranks, names, group_axes, me, backend, timeout)
        axes[role] = Axis(n, idx, pg, backend) if n > 1 else SINGLE
    return axes["dp"], axes["tp"]


def coordinate(mesh) -> dict:
    """This rank's index along every axis of ``mesh`` (zeros off a group)."""
    import torch.distributed as dist

    shape = mesh_shape(mesh)
    if not shape:
        return {}
    me = dist.get_rank() if dist.is_initialized() else 0
    ranks = mesh_ranks(mesh)
    hit = (ranks == me).nonzero()
    if hit.numel() == 0:
        return {name: 0 for name in shape}
    return dict(zip(shape, (int(i) for i in hit[0])))

