"""The collectives a sharded model's blocks issue, over one mesh axis (the
port's own: the reference leaves them to GSPMD).

:func:`bind` turns a :class:`~repro_torch.distributed.parallel.ParallelConfig`
into this rank's two :class:`Axis` objects: ``tp`` (the ranks that differ
only in the tensor-parallel coordinate) and ``dp`` (those that differ only
in the data-parallel coordinates, row-major over ``dp_axes``).  Each holds
its own ``torch.distributed`` group, created with the group's timeout, so a
rank that stops answering fails the others' calls instead of hanging them.

Every call over an axis of size 1 is the identity and issues nothing
(a ``ppermute`` gives zeros).  Every other call is counted with
:func:`repro_torch.counting.record_collective` (``"all_reduce"``,
``"all_gather"``, ``"reduce_scatter"``, ``"broadcast"``, ``"all_to_all"``,
``"ppermute"``) with the bytes of this rank's input and the axis's size.  Over gloo a CUDA
buffer is staged through pinned host memory (several ranks may share one
card), and a reduce-scatter is an all-reduce and a slice: gloo's own
reduce-scatter took 1.6x its all-reduce on 4 CPU processes.  Sums run in the input's type, as
GSPMD's partial sums do.

The functions after :data:`SINGLE` are the collectives that carry
gradients (``torch.autograd.Function``s over an :class:`Axis`), for a
model trained over a mesh.  Their backward passes follow Megatron's
convention: a tensor every rank of the axis holds whole carries on every
rank the whole gradient, and a rank's block its block's gradient.  So a
sum of partial products (:func:`sum_partials`) passes its gradient through
and its pair :func:`enter_sharded` (a replicated activation entering
tp-sharded compute, or a replicated weight used on a rank's own heads or
positions) all-reduces it; an all-gather whose result feeds sharded
compute (:func:`gather`) reduce-scatters, and one whose result every rank
uses whole (:func:`gather_whole`) keeps its block of the gradient;
:func:`scatter_sum` and :func:`gather` are each other's backward, as
:func:`split` and an all-gather are; :func:`all_to_all` and
:func:`ppermute` run in reverse.  :func:`gather_blocks` is the FSDP gather
of several weight blocks, whose backward reduce-scatters their gradients
in one call.  Each is the plain :class:`Axis` call where no gradient is
wanted, and nothing over an axis of one rank.
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
    def _global(self, index: int) -> int:
        """The global rank at ``index`` of the axis."""
        import torch.distributed as dist

        return index if self.pg is None else dist.get_global_rank(self.pg, index)

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
    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of every rank's ``x``, the same
        bits on every rank."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        counting.record_collective("all_reduce", x.numel() * x.element_size(), self.size)
        wire = self._wire(x)
        dist.all_reduce(wire, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.pg)
        return self._home(wire, x)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in index order."""
        if self.size == 1:
            return x
        counting.record_collective("all_gather", x.numel() * x.element_size(), self.size)
        return torch.cat(self._gather_parts(x), dim=dim)

    def all_gather_cols(self, xs: Sequence[torch.Tensor]) -> list:
        """Several column blocks in one all-gather: each ``xs[i]`` (the same
        leading dims) becomes every rank's block of it concatenated along
        the last dim."""
        if self.size == 1:
            return list(xs)
        widths = [x.shape[-1] for x in xs]
        packed = torch.cat(list(xs), dim=-1)
        counting.record_collective("all_gather", packed.numel() * packed.element_size(), self.size)
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
        counting.record_collective("all_gather", packed.numel(), self.size)
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
        counting.record_collective("reduce_scatter", x.numel() * x.element_size(), self.size)
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

        counting.record_collective("broadcast", x.numel() * x.element_size(), self.size)
        wire = self._wire(x)
        dist.broadcast(wire, src=self._global(src), group=self.pg)
        return self._home(wire, x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Row ``j`` of ``x`` (``size`` rows along dim 0) goes to the rank at
        index ``j``; row ``i`` of the result came from the rank at index
        ``i``."""
        if self.size == 1:
            return x
        import torch.distributed as dist

        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all: {tuple(x.shape)} has no row for each of "
                             f"{self.size} ranks")
        counting.record_collective("all_to_all", x.numel() * x.element_size(), self.size)
        wire = self._wire(x.contiguous())
        out = self._buffer(x)
        dist.all_to_all_single(out, wire, group=self.pg)
        return self._home(out, x)

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Send ``x`` to the rank at index + ``shift`` and receive from the one
        at index - ``shift`` (the pipeline's hop): zeros where no rank sends
        (no wrap-around, as the reference's ``ppermute`` pairs)."""
        if self.size == 1:
            return torch.zeros_like(x)
        import torch.distributed as dist

        counting.record_collective("ppermute", x.numel() * x.element_size(), self.size)
        dst, src = self.index + shift, self.index - shift
        wire = self._wire(x.contiguous())
        out = self._buffer(x).zero_()
        ops = []
        if 0 <= dst < self.size:
            ops.append(dist.P2POp(dist.isend, wire, self._global(dst), self.pg))
        if 0 <= src < self.size:
            ops.append(dist.P2POp(dist.irecv, out, self._global(src), self.pg))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return self._home(out, x)

    def barrier(self) -> None:
        """Every rank of the axis reaches this call before any leaves it."""
        if self.size > 1:
            import torch.distributed as dist

            dist.barrier(group=self.pg)

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of a whole ``x`` along ``dim`` (a view)."""
        if self.size == 1:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)


SINGLE = Axis()


# ---------------------------------------------------------------------------
# collectives that carry gradients
# ---------------------------------------------------------------------------
def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _EnterSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.contiguous()), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, whole):
        ctx.axis, ctx.dim, ctx.whole = axis, dim, whole
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.whole:
            return ctx.axis.block(g, ctx.dim).contiguous(), None, None, None
        return ctx.axis.reduce_scatter(g.contiguous(), ctx.dim), None, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g.contiguous(), ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.block(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g.contiguous(), ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_to_all(g.contiguous()), None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return axis.ppermute(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.ppermute(g.contiguous(), -ctx.shift), None, None


def _reduce_scatter_packed(axis: Axis, grads: Sequence[torch.Tensor], dims: Sequence[int]) -> list:
    """Each ``grads[i]`` summed over the axis and cut to this rank's block
    along ``dims[i]``: one reduce-scatter a dtype."""
    out: list = [None] * len(grads)
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        rows = [grads[i].movedim(dims[i], 0).reshape(axis.size, -1) for i in idx]
        packed = axis.reduce_scatter(torch.cat(rows, dim=1), 0)[0]
        at = 0
        for i, r in zip(idx, rows):
            g, d = grads[i], dims[i]
            moved = g.movedim(d, 0).shape
            n = r.shape[1]
            block = packed[at:at + n].reshape((moved[0] // axis.size,) + tuple(moved[1:]))
            out[i] = block.movedim(0, d).contiguous()
            at += n
    return out


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        ctx.ndims = [x.ndim for x in xs]
        return tuple(axis.all_gather_cols(xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_reduce_scatter_packed(ctx.axis, [g.contiguous() for g in gs],
                                              [n - 1 for n in ctx.ndims]))


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dims, *blocks):
        ctx.axis, ctx.dims = axis, dims
        parts = axis.all_gather_bytes([b.detach() for b in blocks])
        return tuple(torch.cat(ps, dim=d) for ps, d in zip(parts, dims))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_reduce_scatter_packed(ctx.axis, [g.contiguous() for g in gs],
                                                    ctx.dims))


def enter_sharded(axis: Axis, x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged; its gradient all-reduced over ``axis``: a tensor every
    rank holds whole, entering compute that each rank does on its own
    block (Megatron's ``f``)."""
    if axis.size == 1 or not _wants_grad(x):
        return x
    return _EnterSharded.apply(x, axis)


def sum_partials(axis: Axis, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's partial ``x`` (``Axis.all_reduce``); its
    gradient passes through (Megatron's ``g``)."""
    if axis.size == 1:
        return x
    if not _wants_grad(x):
        return axis.all_reduce(x)
    return _SumPartials.apply(x, axis)


def gather(axis: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's block concatenated along ``dim``, for compute each rank
    does on its own part: the backward reduce-scatters."""
    if axis.size == 1:
        return x
    if not _wants_grad(x):
        return axis.all_gather(x, dim)
    return _Gather.apply(x, axis, dim, False)


def gather_whole(axis: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's block concatenated along ``dim``, for compute every rank
    does alike on the whole: the backward keeps the rank's block of the
    gradient (no collective)."""
    if axis.size == 1:
        return x
    if not _wants_grad(x):
        return axis.all_gather(x, dim)
    return _Gather.apply(x, axis, dim, True)


def scatter_sum(axis: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``: the
    backward all-gathers."""
    if axis.size == 1:
        return x
    if not _wants_grad(x):
        return axis.reduce_scatter(x, dim)
    return _ScatterSum.apply(x, axis, dim)


def split(axis: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a ``x`` every rank holds whole: the
    backward all-gathers."""
    if axis.size == 1:
        return x
    if not _wants_grad(x):
        return axis.block(x, dim)
    return _Split.apply(x, axis, dim)


def all_to_all(axis: Axis, x: torch.Tensor) -> torch.Tensor:
    """``Axis.all_to_all``; the backward sends the gradient's rows back."""
    if axis.size == 1 or not _wants_grad(x):
        return axis.all_to_all(x)
    return _AllToAll.apply(x, axis)


def ppermute(axis: Axis, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``Axis.ppermute``; the backward sends the gradient the other way."""
    if not _wants_grad(x):
        return axis.ppermute(x, shift)
    return _Ppermute.apply(x, axis, shift)


def gather_cols(axis: Axis, xs: Sequence[torch.Tensor]) -> list:
    """``Axis.all_gather_cols`` (one call for every column block), for
    compute each rank does on its own part: the backward reduce-scatters
    every gradient in one call (a dtype)."""
    if axis.size == 1:
        return list(xs)
    if not _wants_grad(*xs):
        return axis.all_gather_cols(xs)
    return list(_GatherCols.apply(axis, *xs))


def gather_blocks(axis: Axis, blocks: Sequence[torch.Tensor], dims: Sequence[int]) -> list:
    """The FSDP gather: every rank's ``blocks[i]`` concatenated along
    ``dims[i]``, all in one all-gather of their bytes; the backward sums the
    gradients over the axis and keeps the rank's blocks, one reduce-scatter
    a dtype."""
    if axis.size == 1:
        return list(blocks)
    if not _wants_grad(*blocks):
        parts = axis.all_gather_bytes([b.detach() for b in blocks])
        return [torch.cat(ps, dim=d) for ps, d in zip(parts, dims)]
    return list(_GatherBlocks.apply(axis, tuple(dims), *blocks))


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


def axis_of(mesh, axes: Sequence[str], timeout_s: Optional[float] = None) -> Axis:
    """This rank's :class:`Axis` along ``axes`` (row-major over them) of
    ``mesh``, which spans the process group (a collective: every rank calls
    it alike); :data:`SINGLE` where the axes hold one rank."""
    import torch.distributed as dist

    shape = mesh_shape(mesh)
    if not axes or math.prod(shape[a] for a in axes) == 1:
        return SINGLE
    timeout = datetime.timedelta(seconds=float(timeout_s)) if timeout_s else None
    n, idx, pg = _groups(mesh_ranks(mesh), tuple(shape), tuple(axes), dist.get_rank(),
                         str(dist.get_backend()).lower(), timeout)
    return Axis(n, idx, pg, str(dist.get_backend()).lower())


def world() -> Axis:
    """The whole process group as one axis (its default group; :data:`SINGLE`
    outside a group or at world 1)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return SINGLE
    return Axis(dist.get_world_size(), dist.get_rank(), None, str(dist.get_backend()).lower())


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

