"""Phases 2–3 of Alg. 2 — capacity-padded exchange on stacked shards (port of
``repro.core.exchange``).

The D shards of a table live on one device with a leading shard axis, so
the all-to-all of a ``(D_src, D_dst * capacity, ...)`` buffer is a transpose
of its first two block axes, ``psum`` is a sum over the shard axis and
``my_rank`` is ``arange(D)``.  This is the single-card backend; a
``torch.distributed`` backend for several cards is a later slice.

Every all-to-all round counts one call in :data:`CALLS` under the calling
thread's current label (``"exchange"`` unless :func:`counting_as` says
otherwise), and in the thread's open ``counting.scoped`` blocks with the
bytes one shard sends: the port's routing-budget check in place of the
reference's jaxpr collective count.
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
_calls_lock = threading.Lock()
_local = threading.local()


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
    label = _labels()[-1]
    nbytes = sum(b.numel() * b.element_size() // max(1, b.shape[0]) for b in buffers)
    with _calls_lock:
        CALLS[label] += 1
    counting.record_round(label, nbytes)


@dataclasses.dataclass(frozen=True)
class Route:
    """Bookkeeping to reverse a dispatch, one row per source shard."""

    perm: torch.Tensor  # (D, N) int64 stable argsort by destination
    slot: torch.Tensor  # (D, N) int64 flat slot in the packed buffer
    keep: torch.Tensor  # (D, N) bool, False for capacity-dropped rows
    num_dropped: torch.Tensor  # (D,) int64 per-source overflow count
    num_dest: int
    capacity: int


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


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``(D_src, D_dst, ...)`` → ``(D_dst, D_src, ...)``: row ``r`` of the
    result holds the blocks every source sent to shard ``r``."""
    return x.transpose(0, 1).contiguous()


def all_to_all_hierarchical(x: torch.Tensor) -> torch.Tensor:
    """Dense all-to-all of ``(D_src, D_dst, ...)`` blocks (one exchange call).

    The reference runs one ``lax.all_to_all`` per mesh axis; with the shards
    stacked on one device every hop together is the transpose.  Callers that
    ship several payloads stack them into ``x`` so they travel as one call.
    """
    _count_call(x)
    return all_to_all(x)


def dispatch(
    payloads: Sequence[torch.Tensor],
    dest: torch.Tensor,
    capacity: int,
    fills: Sequence[int],
    count_mask: Optional[torch.Tensor] = None,
) -> tuple[list[torch.Tensor], Route]:
    """Send row ``j`` of shard ``s`` to shard ``dest[s, j]`` (one exchange call).

    Returns received buffers ``(D, D * capacity[, W])``, row-major by
    source, padded with ``fills``, and the :class:`Route` to send answers
    back.  Every payload (key lanes and value columns as trailing dims)
    travels in this one call.
    """
    num_dest = dest.shape[0]
    packed, route = pack_by_destination(
        payloads, dest, num_dest, capacity, fills, count_mask=count_mask
    )
    _count_call(*packed)
    received = [
        all_to_all(buf.reshape(num_dest, num_dest, capacity, *buf.shape[2:])).reshape(
            num_dest, num_dest * capacity, *buf.shape[2:]
        )
        for buf in packed
    ]
    return received, route


def _unsort(sorted_rows: torch.Tensor, route: Route) -> torch.Tensor:
    out = torch.empty_like(sorted_rows)
    return out.scatter_(1, route.perm, sorted_rows)


def combine(answers: torch.Tensor, route: Route, fill: int) -> torch.Tensor:
    """Inverse of :func:`dispatch` for one answer per row (one exchange call).

    ``answers`` is laid out like the received buffers ``(D, D*capacity)``;
    dropped rows get ``fill``.
    """
    d, cap = route.num_dest, route.capacity
    _count_call(answers)
    back = all_to_all(answers.reshape(d, d, cap)).reshape(d, d * cap)
    ans_sorted = torch.where(route.keep, torch.gather(back, 1, route.slot), fill)
    return _unsort(ans_sorted, route)


def combine_ragged(
    seg_values: torch.Tensor,
    slot_counts: torch.Tensor,
    route: Route,
    layer_counts: Optional[torch.Tensor] = None,
):
    """Inverse of :func:`dispatch` for variable-fanout answers (retrieval).

    ``seg_values`` is ``(D_owner, D_src, seg_capacity[, C])``: owner ``o``'s
    packed answer runs for source ``s`` (a row's C value columns together);
    ``slot_counts`` ``(D_owner, D_src*capacity)`` the per-slot run lengths.
    Values and counts go home as transposes that count as **one** exchange
    call (the reference packs both into one buffer, an interconnect
    optimisation with the same outputs).

    ``layer_counts`` ``(L, D_owner, D_src*capacity)``, the per-layer run
    lengths of a fused layered retrieval laid out like ``slot_counts``, rides
    the same call (the reference bitcasts the L planes into that buffer) and
    adds a fourth output: ``(D, N, L)`` each row's count split by layer (0
    for dropped rows).

    Returns ``(counts, starts, values[, per_layer])`` in each querier's row
    order: ``(D, N)`` counts (0 for dropped rows), ``(D, N)`` starts into
    ``values`` ``(D, D*seg_capacity[, C])`` (row-major by owner).
    """
    d, cap = route.num_dest, route.capacity
    seg_cap = seg_values.shape[2]
    counts_i32 = slot_counts.to(torch.int32).reshape(d, d, cap)
    planes = None
    if layer_counts is not None:
        nl = layer_counts.shape[0]
        planes = layer_counts.to(torch.int32).reshape(nl, d, d, cap)
        _count_call(seg_values, counts_i32, planes.transpose(0, 1))
    else:
        _count_call(seg_values, counts_i32)
    back_vals = all_to_all(seg_values)  # (D_src, D_owner, seg_cap[, C])
    back_counts = all_to_all(counts_i32)
    # Owner o packed my block by the exclusive cumsum of my slots' counts;
    # recompute the identical offsets from the returned counts.
    block_off = torch.cumsum(back_counts, dim=2, dtype=torch.int32) - back_counts
    flat_counts = back_counts.reshape(d, d * cap)
    flat_off = block_off.reshape(d, d * cap)
    owner = torch.div(route.slot, cap, rounding_mode="floor")
    starts_packed = owner * seg_cap + torch.gather(flat_off, 1, route.slot)
    counts_sorted = torch.where(route.keep, torch.gather(flat_counts, 1, route.slot), 0)
    starts_sorted = torch.where(route.keep, starts_packed, 0)
    counts = _unsort(counts_sorted.to(torch.int32), route)
    starts = _unsort(starts_sorted.to(torch.int32), route)
    values = back_vals.reshape(d, d * seg_cap, *seg_values.shape[3:])
    if planes is None:
        return counts, starts, values
    # (L, D_owner, D_src, cap) -> (D_src, L, D_owner * cap): each querier's
    # planes, addressed by the route's slots like the counts.
    back_planes = planes.permute(2, 0, 1, 3).reshape(d, nl, d * cap)
    n = route.slot.shape[1]
    slot = route.slot.unsqueeze(1).expand(d, nl, n)
    per_sorted = torch.where(route.keep.unsqueeze(1), torch.gather(back_planes, 2, slot), 0)
    per_layer = torch.empty_like(per_sorted).scatter_(
        2, route.perm.unsqueeze(1).expand(d, nl, n), per_sorted)
    return counts, starts, values, per_layer.permute(0, 2, 1).contiguous()
