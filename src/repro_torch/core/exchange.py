"""Phases 2–3 of Alg. 2 — capacity-padded exchange over a shard group (port
of ``repro.core.exchange``).

A *shard group* is the port's counterpart of the reference's ``axis_names``:
the D shards of a table and the few primitives every cross-shard step goes
through (``size``, ``local``, ``ranks()``, ``all_to_all``, ``psum``,
``pmax`` and the host-side ``agree``).  A process holds ``local`` of the D
shards as the leading axis of every per-shard tensor.  Two backends:

* :class:`StackedGroup` — all D shards on one device (``local == size``):
  the all-to-all of ``(D_src, D_dst, ...)`` blocks is a transpose, ``psum``
  and ``pmax`` of a value already reduced over the local rows are that value
  and ``ranks()`` is ``arange(D)``: no copy, launch or sync beyond what the
  single-card path always did.
* :class:`ProcessGroup` — one shard per process of a ``torch.distributed``
  group (``local == 1``, rank ``r`` holds shard ``r``): the all-to-all is one
  ``all_to_all_single`` over equal capacity-padded splits, ``psum`` /
  ``pmax`` are ``all_reduce``s.  NCCL moves CUDA buffers; gloo moves CPU
  buffers and stages CUDA ones through pinned host memory.

The reference's multi-axis mesh exchanges one hop per mesh axis; its
row-major composite rank is the process rank here, and one flat
all-to-all over the group gives the same blocks.

Every all-to-all round counts one call in :data:`CALLS` under the calling
thread's current label (``"exchange"`` unless :func:`counting_as` says
otherwise), and in the thread's open ``counting.scoped`` blocks with the
bytes one shard sends: the port's routing-budget check in place of the
reference's jaxpr collective count.  A process group's reductions count
apart, in :data:`REDUCTIONS` and ``Scope.collectives`` (``"psum"``,
``"pmax"``, ``"agree"`` for the host agreements, ``"all_gather"`` and
``"broadcast"``), so a rank's rounds equal the stacked run's.

*Gradients.*  :func:`dispatch` and :func:`combine` are differentiable in
their float payloads (an MoE trained with expert parallelism): the
stacked group's transpose is, and over a process group the round goes
through :func:`exchange_many`, whose backward is the same exchange of the
incoming gradient (one more round a call, counted in :data:`CALLS` under
the forward's label whichever thread runs it).

*Roles.*  A server issues collectives from several threads at once (reads,
writes, folds).  Over a process group each rank must issue one
communicator's collectives in one order, so :meth:`ProcessGroup.add_roles`
creates one ``torch.distributed`` group per role over the same ranks, and a
thread that enters :func:`role` sends every collective of every
``ProcessGroup`` it touches over that role's communicator.  The stacked
group has no communicator and ignores roles.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import torch

from repro_torch import counting
from repro_torch.utils import take_rows

# Label -> all-to-all rounds made under it in this process (every thread).
CALLS: collections.Counter = collections.Counter()
# Kind ("psum", "pmax", "agree", "all_gather", "broadcast") -> a process
# group's reductions in this process.
REDUCTIONS: collections.Counter = collections.Counter()
_calls_lock = threading.Lock()
_local = threading.local()


def _role() -> Optional[str]:
    return getattr(_local, "role", None)


@contextlib.contextmanager
def role(name: Optional[str]):
    """Send this thread's collectives over the ``name`` communicator of every
    process group that has one (:meth:`ProcessGroup.add_roles`); other
    threads keep their own role.  ``None`` is the group's own communicator."""
    prev = _role()
    _local.role = name
    try:
        yield
    finally:
        _local.role = prev


def _labels() -> list:
    labels = getattr(_local, "labels", None)
    if labels is None:
        labels = _local.labels = ["exchange"]
    return labels


@contextlib.contextmanager
def counting_as(label: str):
    """Count the exchange rounds this thread makes inside the block under
    ``label`` (other threads keep their own labels)."""
    labels = _labels()
    labels.append(label)
    try:
        yield
    finally:
        labels.pop()


def _count_call(*buffers: torch.Tensor) -> None:
    """One round; ``buffers`` are what it transposes, ``(D, ...)`` each."""
    _count_as(_labels()[-1], buffers)


def _count_as(label: str, buffers) -> None:
    """One round under ``label`` (not the calling thread's: a backward pass
    may run on autograd's own thread)."""
    nbytes = sum(b.numel() * b.element_size() // max(1, b.shape[0]) for b in buffers)
    with _calls_lock:
        CALLS[label] += 1
    counting.record_round(label, nbytes)


def _count_reduction(kind: str, x: Optional[torch.Tensor] = None, group: int = 0) -> None:
    with _calls_lock:
        REDUCTIONS[kind] += 1
    counting.record_collective(kind, 0 if x is None else x.numel() * x.element_size(), group)


# ---------------------------------------------------------------------------
# Shard groups
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StackedGroup:
    """All ``size`` shards stacked on one device (``local == size``)."""

    size: int

    @property
    def local(self) -> int:
        return self.size

    is_process = False
    rank = 0  # the shard id of the first local row

    def ranks(self, device) -> torch.Tensor:
        """``(local,)`` int32 shard ids of the local rows."""
        return torch.arange(self.size, dtype=torch.int32, device=device)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """The local rows of a tensor indexed by shard id along dim 0."""
        return t

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``(local, D, ...)`` blocks by destination → ``(local, D, ...)``
        blocks by source: row ``r`` holds what every source sent shard ``r``.
        A view: every caller's reshape makes the one copy."""
        return x.transpose(0, 1)

    def all_to_all_many(self, xs: Sequence[torch.Tensor]) -> list:
        """:meth:`all_to_all` of several buffers as one round."""
        return [self.all_to_all(x) for x in xs]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over every shard of ``x``, this process's partial (already
        summed over its local rows).  Stacked, that partial is the total."""
        return x

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over processes of a partial maximum."""
        return x

    def agree(self, values: Sequence[int]) -> tuple:
        """Host integers, each the maximum over the processes; one process
        has nothing to agree with."""
        return tuple(int(v) for v in values)

    def same(self, values: Sequence[int]) -> bool:
        """Did every process pass the same host integers?"""
        return True

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(local, ...)`` rows of every process → ``(size, ...)``; the
        stacked rows are every shard's already."""
        return x


_REDUCE_OPS = {"sum": "SUM", "max": "MAX"}


class ProcessGroup:
    """One shard per process of a ``torch.distributed`` process group.

    ``pg`` is the group (``None``: the default group); rank ``r`` holds
    shard ``r`` as a leading axis of 1.  Collectives go over NCCL on the
    card or gloo (CPU buffers; CUDA buffers staged through pinned host
    memory, so several ranks can share one card).  Buffers travel as bytes,
    so every dtype rides one call (NCCL has no ``bool``).
    """

    is_process = True
    local = 1

    def __init__(self, pg=None, timeout_s: Optional[float] = None):
        import torch.distributed as dist

        self._dist = dist
        self.pg = pg
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.backend = str(dist.get_backend(pg)).lower()
        self.timeout_s = timeout_s  # the role communicators' (None: torch's default)
        self._roles = {}  # role -> torch.distributed group over the same ranks
        # Host agreements travel on the transport's own device.
        if self.backend == "nccl":
            self.host_device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.host_device = torch.device("cpu")

    def __repr__(self) -> str:
        return f"ProcessGroup(size={self.size}, rank={self.rank}, backend={self.backend!r})"

    def add_roles(self, names: Sequence[str]) -> None:
        """One communicator per role over this group's ranks, created in the
        order given (a collective: every rank calls it alike); roles that
        exist are kept."""
        import datetime

        ranks = self._dist.get_process_group_ranks(self.pg or self._dist.group.WORLD)
        kw = {} if self.timeout_s is None else {
            "timeout": datetime.timedelta(seconds=float(self.timeout_s))}
        for name in names:
            if name not in self._roles:
                self._roles[name] = self._dist.new_group(ranks, backend=self.backend, **kw)

    def _comm(self):
        """The communicator of the calling thread's role (else the group's)."""
        name = _role()
        return self.pg if name is None else self._roles.get(name, self.pg)

    def ranks(self, device) -> torch.Tensor:
        return torch.tensor([self.rank], dtype=torch.int32, device=device)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.rank : self.rank + 1]

    # -- transport ------------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        if not self._staged(t):
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)

    def _exchange_bytes(self, send: torch.Tensor) -> torch.Tensor:
        """``(D, B)`` uint8 rows by destination → ``(D, B)`` rows by source."""
        wire = self._to_wire(send.contiguous())
        out = torch.empty_like(wire)
        self._dist.all_to_all_single(out, wire, group=self._comm())
        return out.to(send.device, non_blocking=False) if self._staged(send) else out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_to_all_many([x])[0]

    def all_to_all_many(self, xs: Sequence[torch.Tensor]) -> list:
        """Every ``(1, D, ...)`` buffer in one ``all_to_all_single``: each
        destination's blocks side by side as bytes, split on arrival."""
        d = self.size
        parts, widths = [], []
        for x in xs:
            if x.shape[0] != 1 or x.shape[1] != d:
                raise ValueError(f"all_to_all takes (1, {d}, ...) blocks, got {tuple(x.shape)}")
            b = x.reshape(d, -1).contiguous()
            if b.dtype == torch.bool:
                b = b.to(torch.uint8)
            b = b.view(torch.uint8)
            parts.append(b)
            widths.append(b.shape[1])
        got = self._exchange_bytes(parts[0] if len(parts) == 1 else torch.cat(parts, dim=1))
        out, at = [], 0
        for x, w in zip(xs, widths):
            chunk = got[:, at : at + w].contiguous()
            at += w
            if x.dtype == torch.bool:
                y = chunk.view(torch.uint8).to(torch.bool)
            else:
                y = chunk.view(x.dtype)
            out.append(y.reshape(x.shape))
        return out

    def _all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        wire = self._to_wire(t.clone())
        self._dist.all_reduce(wire, op=getattr(self._dist.ReduceOp, _REDUCE_OPS[op]),
                              group=self._comm())
        return wire.to(t.device) if self._staged(t) else wire

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        _count_reduction("psum", x, self.size)
        return self._all_reduce(x, "sum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        _count_reduction("pmax", x, self.size)
        return self._all_reduce(x, "max")

    def agree(self, values: Sequence[int]) -> tuple:
        _count_reduction("agree", None, self.size)
        t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=self.host_device)
        return tuple(int(v) for v in self._all_reduce(t, "max").tolist())

    def same(self, values: Sequence[int]) -> bool:
        """One MAX all-reduce of ``(v, -v)``: equal everywhere iff max == min."""
        vals = [int(v) for v in values]
        got = self.agree(vals + [-v for v in vals])
        k = len(vals)
        return all(got[i] == -got[k + i] for i in range(k))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``(1, ...)`` rows → every rank's, ``(size, ...)`` in
        rank order (one ``all_gather``, counted as ``"all_gather"``)."""
        _count_reduction("all_gather", x, self.size)
        if x.shape[0] != 1:
            raise ValueError(f"all_gather takes (1, ...) rows, got {tuple(x.shape)}")
        wire = self._to_wire(x.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        self._dist.all_gather(parts, wire, group=self._comm())
        out = torch.cat(parts)
        return out.to(x.device) if self._staged(x) else out

    def broadcast_object(self, obj):
        """Rank 0's picklable ``obj`` on every rank (the others pass
        anything; one ``broadcast_object_list``, counted as ``"broadcast"``)."""
        _count_reduction("broadcast")
        box = [obj]
        self._dist.broadcast_object_list(box, src=self._dist.get_global_rank(
            self._comm() or self._dist.group.WORLD, 0), group=self._comm(),
            device=self.host_device)
        return box[0]


class _AllToAllMany(torch.autograd.Function):
    """:meth:`ProcessGroup.all_to_all_many` that carries the gradients of its
    float buffers: an all-to-all of ``(1, D, ...)`` blocks by destination is
    its own transpose, so the backward sends each gradient's blocks back
    by the same exchange, one round for all of them, counted under the
    forward's label.  Integer buffers (ids, masks) ride the forward's one
    call and have no gradient."""

    @staticmethod
    def forward(ctx, group, label, *xs):
        ctx.group, ctx.label = group, label
        ctx.floats = [x.is_floating_point() for x in xs]
        out = group.all_to_all_many(xs)
        ctx.mark_non_differentiable(*[y for y, f in zip(out, ctx.floats) if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        idx = [i for i, f in enumerate(ctx.floats) if f]
        sent = [gs[i].contiguous() for i in idx]
        _count_as(ctx.label, sent)
        back = ctx.group.all_to_all_many(sent)
        out: list = [None] * len(gs)
        for i, g in zip(idx, back):
            out[i] = g
        return (None, None, *out)


def exchange_many(group, xs: Sequence[torch.Tensor]) -> list:
    """``group.all_to_all_many(xs)``; over a process group, where autograd
    records a float buffer that requires a gradient, through
    :class:`_AllToAllMany` (the stacked group's transpose carries gradients
    as it is)."""
    if group.is_process and torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_AllToAllMany.apply(group, _labels()[-1], *xs))
    return group.all_to_all_many(xs)


def as_group(group, size: Optional[int] = None):
    """A shard group from ``group``: ``None`` is the stacked group of
    ``size`` shards; a ``torch.distributed`` process group (or ``"world"``
    for the default one) is wrapped in a :class:`ProcessGroup`."""
    if group is None:
        return StackedGroup(int(size))
    if isinstance(group, (StackedGroup, ProcessGroup)):
        return group
    return ProcessGroup(None if group == "world" else group)


def checksum64(t: torch.Tensor) -> int:
    """An order-sensitive 64-bit checksum of an integer tensor's rows (a
    cheap test that two processes hold the same batch; wraps mod 2^64)."""
    flat = t.reshape(-1).to(torch.int64)
    if flat.numel() == 0:
        return 0
    pos = torch.arange(1, flat.numel() + 1, dtype=torch.int64, device=flat.device)
    mixed = (flat ^ (pos * 0x27D4EB2F165667C5)) * 0x165667B19E3779F9
    return int(mixed.sum())


@dataclasses.dataclass(frozen=True)
class Route:
    """Bookkeeping to reverse a dispatch, one row per source shard."""

    perm: torch.Tensor  # (D, N) int64 stable argsort by destination
    slot: torch.Tensor  # (D, N) int64 flat slot in the packed buffer
    keep: torch.Tensor  # (D, N) bool, False for capacity-dropped rows
    num_dropped: torch.Tensor  # (D,) int64 per-source overflow count
    num_dest: int
    capacity: int
    group: object = None  # the shard group the dispatch went over


def pack_by_destination(
    payloads: Sequence[torch.Tensor],
    dest: torch.Tensor,
    num_dest: int,
    capacity: int,
    fills: Sequence[int],
    count_mask: Optional[torch.Tensor] = None,
) -> tuple[list[torch.Tensor], Route]:
    """Counting-sort each shard's rows by destination into ``(D, num_dest*capacity)``.

    A payload may carry a trailing dim (key lanes, value columns): ``(D, N,
    W)`` packs into ``(D, num_dest*capacity, W)``.  The **stable** argsort
    keeps the input order inside a destination, which fixes the CSR value
    order that retrieve returns.  Rows beyond
    ``capacity`` per destination are scattered into one trash slot that is
    cut off, and counted in ``num_dropped`` where ``count_mask`` marks them.
    """
    d_src, n = dest.shape
    dev = dest.device
    sdest, perm = torch.sort(dest.to(torch.int32), dim=1, stable=True)
    targets = torch.arange(num_dest, dtype=torch.int32, device=dev).expand(d_src, -1)
    part_start = torch.searchsorted(sdest, targets.contiguous(), side="left")
    sdest = sdest.to(torch.int64)
    rank_in_part = torch.arange(n, device=dev) - torch.gather(part_start, 1, sdest)
    keep = rank_in_part < capacity
    slot = sdest * capacity + torch.where(keep, rank_in_part, 0)
    scatter_idx = torch.where(keep, slot, num_dest * capacity)
    packed = []
    for p, fill in zip(payloads, fills):
        rest = tuple(p.shape[2:])
        buf = torch.full((d_src, num_dest * capacity + 1) + rest, fill, dtype=p.dtype, device=dev)
        idx = scatter_idx if not rest else scatter_idx.unsqueeze(-1).expand(d_src, n, *rest)
        buf.scatter_(1, idx, take_rows(p, perm))
        packed.append(buf[:, :-1])
    counted = ~keep if count_mask is None else (~keep & torch.gather(count_mask, 1, perm))
    route = Route(
        perm=perm,
        slot=slot,
        keep=keep,
        num_dropped=counted.sum(dim=1),
        num_dest=num_dest,
        capacity=capacity,
    )
    return packed, route


def all_to_all_hierarchical(x: torch.Tensor, group=None) -> torch.Tensor:
    """Dense all-to-all of ``(local, D_dst, ...)`` blocks (one exchange call).

    The reference runs one ``lax.all_to_all`` per mesh axis; with the shards
    stacked on one device every hop together is the transpose, and over a
    process group one flat all-to-all.  Callers that ship several payloads
    stack them into ``x`` so they travel as one call.
    """
    group = as_group(group, x.shape[0])
    _count_call(x)
    return group.all_to_all(x)


def dispatch(
    payloads: Sequence[torch.Tensor],
    dest: torch.Tensor,
    capacity: int,
    fills: Sequence[int],
    count_mask: Optional[torch.Tensor] = None,
    group=None,
) -> tuple[list[torch.Tensor], Route]:
    """Send row ``j`` of local shard ``s`` to shard ``dest[s, j]`` (one
    exchange call) over ``group`` (``None``: the stacked group of
    ``dest.shape[0]`` shards).

    Returns received buffers ``(local, D * capacity[, W])``, row-major by
    source, padded with ``fills``, and the :class:`Route` to send answers
    back.  Every payload (key lanes and value columns as trailing dims)
    travels in this one call.
    """
    group = as_group(group, dest.shape[0])
    local, num_dest = dest.shape[0], group.size
    packed, route = pack_by_destination(
        payloads, dest, num_dest, capacity, fills, count_mask=count_mask
    )
    route = dataclasses.replace(route, group=group)
    _count_call(*packed)
    received = exchange_many(
        group, [buf.reshape(local, num_dest, capacity, *buf.shape[2:]) for buf in packed])
    received = [r.reshape(local, num_dest * capacity, *r.shape[3:]) for r in received]
    return received, route


def _unsort(sorted_rows: torch.Tensor, route: Route) -> torch.Tensor:
    out = torch.empty_like(sorted_rows)
    return out.scatter_(1, route.perm, sorted_rows)


def combine(answers: torch.Tensor, route: Route, fill) -> torch.Tensor:
    """Inverse of :func:`dispatch` for one answer per row (one exchange call).

    ``answers`` is laid out like the received buffers ``(local,
    D*capacity[, ...])``: one answer a slot, with any trailing dims (an MoE
    expert's output row, as :func:`pack_by_destination` carries them out);
    dropped rows get ``fill``.
    """
    d, cap = route.num_dest, route.capacity
    local, rest = answers.shape[0], tuple(answers.shape[2:])
    _count_call(answers)
    (back,) = exchange_many(route.group, [answers.reshape(local, d, cap, *rest)])
    back = back.reshape(local, d * cap, *rest)
    if not rest:
        ans_sorted = torch.where(route.keep, torch.gather(back, 1, route.slot), fill)
        return _unsort(ans_sorted, route)
    n = route.slot.shape[1]
    rows = take_rows(back.reshape(local, d * cap, -1), route.slot)  # (local, n, W)
    ans_sorted = torch.where(route.keep[..., None], rows, fill)
    out = torch.empty_like(ans_sorted)
    out.scatter_(1, route.perm[..., None].expand_as(out), ans_sorted)
    return out.reshape(local, n, *rest)


def combine_ragged(
    seg_values: torch.Tensor,
    slot_counts: torch.Tensor,
    route: Route,
    layer_counts: Optional[torch.Tensor] = None,
):
    """Inverse of :func:`dispatch` for variable-fanout answers (retrieval).

    ``seg_values`` is ``(local_owner, D_src, seg_capacity[, C])``: owner
    ``o``'s packed answer runs for source ``s`` (a row's C value columns
    together); ``slot_counts`` ``(local_owner, D_src*capacity)`` the
    per-slot run lengths.  Values and counts go home in **one** exchange
    call (stacked, transposes counted once; over a process group one
    all-to-all of both, as the reference packs them into one buffer).

    ``layer_counts`` ``(L, local_owner, D_src*capacity)``, the per-layer run
    lengths of a fused layered retrieval laid out like ``slot_counts``, rides
    the same call (the reference bitcasts the L planes into that buffer) and
    adds a fourth output: ``(local, N, L)`` each row's count split by layer
    (0 for dropped rows).

    Returns ``(counts, starts, values[, per_layer])`` in each querier's row
    order: ``(local, N)`` counts (0 for dropped rows), ``(local, N)`` starts
    into ``values`` ``(local, D*seg_capacity[, C])`` (row-major by owner).
    """
    d, cap = route.num_dest, route.capacity
    group = route.group
    local = seg_values.shape[0]
    seg_cap = seg_values.shape[2]
    counts_i32 = slot_counts.to(torch.int32).reshape(local, d, cap)
    sent = [seg_values, counts_i32]
    if layer_counts is not None:
        nl = layer_counts.shape[0]
        # (L, owner, src, cap) -> (owner, src, L, cap): each source's planes
        # in its block, so they ride the same all-to-all.
        sent.append(layer_counts.to(torch.int32).reshape(nl, local, d, cap).permute(1, 2, 0, 3))
    _count_call(*sent)
    back = group.all_to_all_many(sent)
    back_vals, back_counts = back[0], back[1]  # (local_src, D_owner, ...)
    # Owner o packed my block by the exclusive cumsum of my slots' counts;
    # recompute the identical offsets from the returned counts.
    block_off = torch.cumsum(back_counts, dim=2, dtype=torch.int32) - back_counts
    flat_counts = back_counts.reshape(local, d * cap)
    flat_off = block_off.reshape(local, d * cap)
    owner = torch.div(route.slot, cap, rounding_mode="floor")
    starts_packed = owner * seg_cap + torch.gather(flat_off, 1, route.slot)
    counts_sorted = torch.where(route.keep, torch.gather(flat_counts, 1, route.slot), 0)
    starts_sorted = torch.where(route.keep, starts_packed, 0)
    counts = _unsort(counts_sorted.to(torch.int32), route)
    starts = _unsort(starts_sorted.to(torch.int32), route)
    values = back_vals.reshape(local, d * seg_cap, *seg_values.shape[3:])
    if layer_counts is None:
        return counts, starts, values
    # (local_src, D_owner, L, cap) -> (local_src, L, D_owner * cap): each
    # querier's planes, addressed by the route's slots like the counts.
    back_planes = back[2].permute(0, 2, 1, 3).reshape(local, nl, d * cap)
    n = route.slot.shape[1]
    slot = route.slot.unsqueeze(1).expand(local, nl, n)
    per_sorted = torch.where(route.keep.unsqueeze(1), torch.gather(back_planes, 2, slot), 0)
    per_layer = torch.empty_like(per_sorted).scatter_(
        2, route.perm.unsqueeze(1).expand(local, nl, n), per_sorted)
    return counts, starts, values, per_layer.permute(0, 2, 1).contiguous()
