"""Multi-shard HashGraph — Alg. 2 of the paper on stacked shards (port of
``repro.core.multi_hashgraph``).

Where the reference runs one program per device under ``shard_map``, the
port runs every shard at once: arrays carry a leading shard axis ``D``, the
all-to-all is the transpose in ``exchange``, ``psum`` a sum over that axis
and ``my_rank`` ``arange(D)``.  Hashing, histogram and the CSR gathers run
in the port's CUDA kernels on the card.

Build (:func:`build_sharded`) follows the paper's four phases: coarse-bin
histogram and balanced splits, counting sort by destination, the
capacity-padded exchange, and one CSR per shard over its hash range.
Query routes each key to its owner by the build splits, locates it there
and routes the count back.  Retrieve and join take the fused single-route
path: one dispatch, one owner-side batched CSR gather, one ragged return and
one querier-side CSR gather — two exchange calls.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import exchange, hashing, hashgraph, partition
from repro_torch.core.hashgraph import EMPTY_BITS, HashGraph
from repro_torch.kernels import ops
from repro_torch.utils import cdiv


@dataclasses.dataclass(frozen=True)
class DistributedHashGraph:
    """All D shards of the distributed table, stacked on one device.

    ``local`` holds one CSR per shard (leading axis D).  ``bucket_stride``
    coarsens the rebased-hash → local-bucket map exactly as in the reference.
    """

    local: HashGraph
    hash_splits: torch.Tensor  # (D+1,) int32
    num_dropped: torch.Tensor  # () int64, capacity overflow during build
    hash_range: int
    seed: int
    local_range_cap: int
    bucket_stride: int = 1


def default_capacity(n_local: int, num_devices: int, slack: float) -> int:
    """Per-destination slot size: balanced share × slack, 8-aligned."""
    base = cdiv(n_local, num_devices)
    cap = int(base * slack) + 8
    return cdiv(cap, 8) * 8


def _shard_lo(hash_splits: torch.Tensor) -> torch.Tensor:
    """Each shard's split base ``splits[rank]`` as a ``(D, 1)`` column."""
    return hash_splits[:-1].to(torch.int32).unsqueeze(1)


def _rebase_buckets(
    h: torch.Tensor,
    is_pad: torch.Tensor,
    lo: torch.Tensor,
    local_cap: int,
    stride: int,
) -> torch.Tensor:
    """Rebased hash → local bucket id, sentinel keys → trash bucket."""
    rebased = h - lo
    if stride != 1:
        rebased = torch.div(rebased, stride, rounding_mode="floor")
    rebased = torch.clamp(rebased, 0, local_cap - 1)
    return torch.where(is_pad, local_cap, rebased).to(torch.int32)


def _local_buckets(
    keys: torch.Tensor,
    lo: torch.Tensor,
    hash_range: int,
    local_cap: int,
    seed: int,
    stride: int = 1,
) -> torch.Tensor:
    h = hashing.hash_to_buckets(keys, hash_range, seed=seed)
    return _rebase_buckets(h, hashgraph.is_empty_key(keys), lo, local_cap, stride)


def build_sharded(
    keys: torch.Tensor,
    *,
    hash_range: int,
    values: Optional[torch.Tensor] = None,
    num_bins: Optional[int] = None,
    capacity_slack: float = 1.25,
    range_slack: float = 1.5,
    seed: int = hashing.DEFAULT_SEED,
) -> DistributedHashGraph:
    """Build the distributed HashGraph from ``keys`` ``(D, n_local)``.

    ``values`` ``(D, n_local)`` ride along through the exchange (default: the
    global row id ``rank * n_local + i``).  EMPTY sentinels are left out of
    the histogram and the overflow count, routed round-robin, and land in
    the owner's trash bucket.
    """
    d, n_local = keys.shape
    dev = keys.device
    if values is None:
        rank = torch.arange(d, dtype=torch.int32, device=dev).unsqueeze(1)
        values = rank * n_local + torch.arange(n_local, dtype=torch.int32, device=dev)
    is_pad = hashgraph.is_empty_key(keys)

    # ---- Phase 1: partitioning.  psum of the per-shard histograms is one
    # histogram over every shard's keys (integer counts commute).
    h = hashing.hash_to_buckets(keys, hash_range, seed=seed)
    bins_g = num_bins or partition.choose_num_bins(hash_range, d)
    ghist = partition.local_bin_histogram(h, bins_g, hash_range, valid=~is_pad)
    splits = partition.balanced_hash_splits(ghist, d, hash_range)

    # ---- Phase 2: reorganization.  Sentinels route round-robin (all EMPTY
    # rows hash alike; by hash they would funnel into one owner's slot).
    dest = partition.destination_of(h, splits)
    del h
    round_robin = (torch.arange(n_local, dtype=torch.int32, device=dev) % d).expand(d, -1)
    dest = torch.where(is_pad, round_robin, dest)

    # ---- Phase 3: movement.
    capacity = default_capacity(n_local, d, capacity_slack)
    (rkeys, rvalues), route = exchange.dispatch(
        (keys, values), dest, capacity, fills=(EMPTY_BITS, -1), count_mask=~is_pad
    )
    del dest, is_pad

    # ---- Phase 4: local HashGraph creation.
    local_cap = int(cdiv(hash_range, d) * range_slack)
    buckets = _local_buckets(rkeys, _shard_lo(splits), hash_range, local_cap, seed)
    local = hashgraph.build_from_buckets(rkeys, buckets, local_cap, rvalues, seed=seed)
    return DistributedHashGraph(
        local=local,
        hash_splits=splits,
        num_dropped=route.num_dropped.sum(),
        hash_range=hash_range,
        seed=seed,
        local_range_cap=local_cap,
    )


@dataclasses.dataclass(frozen=True)
class RoutedQueries:
    """One dispatch round of a query batch, seen from the owners."""

    rq: torch.Tensor  # (D, D*capacity) received keys, EMPTY-padded
    route: exchange.Route
    rh: torch.Tensor  # (D, D*capacity) owner-side hash values
    is_pad: torch.Tensor  # (D, D*capacity) bool
    lo: torch.Tensor  # (D, 1) each owner's split base
    capacity: int


def _route_queries_once(
    dhg: DistributedHashGraph, queries: torch.Tensor, capacity_slack: float
) -> RoutedQueries:
    """The one exchange round of the query path (paper §3.3 phase 1):
    hash the queries and dispatch them to their owners by the build splits."""
    d, n_local = queries.shape
    h = hashing.hash_to_buckets(queries, dhg.hash_range, seed=dhg.seed)
    dest = partition.destination_of(h, dhg.hash_splits)
    del h
    capacity = default_capacity(n_local, d, capacity_slack)
    (rq,), route = exchange.dispatch((queries,), dest, capacity, fills=(EMPTY_BITS,))
    rh = hashing.hash_to_buckets(rq, dhg.hash_range, seed=dhg.seed)
    return RoutedQueries(
        rq=rq,
        route=route,
        rh=rh,
        is_pad=hashgraph.is_empty_key(rq),
        lo=_shard_lo(dhg.hash_splits),
        capacity=capacity,
    )


def _route_queries(
    dhg: DistributedHashGraph, queries: torch.Tensor, capacity_slack: float
) -> tuple[RoutedQueries, torch.Tensor]:
    """:func:`_route_queries_once` plus this graph's own bucket rebase."""
    routed = _route_queries_once(dhg, queries, capacity_slack)
    rbuckets = _rebase_buckets(
        routed.rh, routed.is_pad, routed.lo, dhg.local_range_cap, dhg.bucket_stride
    )
    return routed, rbuckets


def _mask_counts(counts: torch.Tensor, rq: torch.Tensor) -> torch.Tensor:
    """Zero the counts of padding slots (a base-only state has no tombstones)."""
    return torch.where(hashgraph.is_empty_key(rq), 0, counts)


def query_sharded(
    dhg: DistributedHashGraph, queries: torch.Tensor, *, capacity_slack: float = 1.25
) -> torch.Tensor:
    """Multiplicity ``(D, n_local)`` int32 of each query key: route by the
    build splits, count against the owner's shard, route counts back."""
    routed, rbuckets = _route_queries(dhg, queries, capacity_slack)
    counts = hashgraph.query_count_sorted(dhg.local, routed.rq, rbuckets)
    counts = _mask_counts(counts, routed.rq)
    return exchange.combine(counts, routed.route, fill=0)


def join_size_sharded(
    dhg: DistributedHashGraph, queries: torch.Tensor, *, capacity_slack: float = 1.25
) -> torch.Tensor:
    """Global inner-join cardinality |build ⋈ queries| (int64 scalar)."""
    return query_sharded(dhg, queries, capacity_slack=capacity_slack).sum()


@dataclasses.dataclass(frozen=True)
class ShardRetrieval:
    """Per-shard CSR of retrieved values: query ``i`` of shard ``s`` has
    ``values[s, offsets[s, i] : offsets[s, i+1]]``.

    ``num_dropped`` is zero iff no static capacity truncated a result;
    when positive it is an overflow indicator, not an exact loss count.
    """

    offsets: torch.Tensor  # (D, n_local + 1) int32
    values: torch.Tensor  # (D, out_capacity) int32
    counts: torch.Tensor  # (D, n_local) int32
    num_dropped: torch.Tensor  # () int64


@dataclasses.dataclass(frozen=True)
class ShardJoin:
    """Per-shard join pairs ``(query_idx[s, j], values[s, j])`` for
    ``j < num_results[s]``; ``query_idx`` is the global query row id."""

    query_idx: torch.Tensor  # (D, out_capacity) int32, -1 beyond num_results
    values: torch.Tensor  # (D, out_capacity) int32
    num_results: torch.Tensor  # (D,) int32
    num_dropped: torch.Tensor  # () int64


def _layer_run_descriptors(
    layers: Sequence[DistributedHashGraph], routed: RoutedQueries
) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """Owner-side locate of the routed batch in every layer (no exchange).

    Returns ``(starts, counts, tables)``: ``(L, D, R)`` run descriptors
    (``R`` routed slots per owner) addressing each owner's concatenated
    layer value tables, and the per-layer ``(D, M_l)`` tables.
    """
    starts_l, counts_l, tables = [], [], []
    off = 0
    for layer in layers:
        rb = _rebase_buckets(
            routed.rh, routed.is_pad, routed.lo, layer.local_range_cap, layer.bucket_stride
        )
        s, c = hashgraph.query_locate(layer.local, routed.rq, rb)
        starts_l.append(s + off)
        counts_l.append(_mask_counts(c, routed.rq))
        tables.append(layer.local.values)
        off += layer.local.values.shape[1]
    return torch.stack(starts_l), torch.stack(counts_l), tuple(tables)


def _retrieve_parts_fused(
    layers: Sequence[DistributedHashGraph],
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    out_capacity: int,
    capacity_slack: float,
):
    """Single-route merged retrieval: two exchange calls.

    One dispatch routes the queries; each owner locates them and packs every
    source's runs into one segment with the batched CSR gather (kernel 4);
    one ragged return ships segments and per-slot totals home; each querier
    compacts its runs with the CSR gather (kernel 3).
    """
    d, n_local = queries.shape
    nlayers = len(layers)
    routed = _route_queries_once(layers[0], queries, capacity_slack)
    cap = routed.capacity
    starts_lr, counts_lr, tables = _layer_run_descriptors(layers, routed)

    # Owner side: the gather's source axis is the dispatching shard, its row
    # axis the slot-major/layer-minor interleaved runs.
    segs, owner_dropped = [], 0
    for o in range(d):
        seg, dropped = ops.csr_gather_layers(
            starts_lr[:, o].reshape(nlayers, d, cap),
            counts_lr[:, o].reshape(nlayers, d, cap),
            tuple(t[o] for t in tables),
            capacity=seg_capacity,
        )
        segs.append(seg)
        owner_dropped = owner_dropped + dropped

    # One ragged return: per-slot totals reconstruct, on the querier, the
    # interleaved offsets the owner packed with.
    slot_totals = counts_lr.sum(0)
    counts, starts, seg_flat = exchange.combine_ragged(
        torch.stack(segs), slot_totals, routed.route
    )
    offsets, slot_rows, values, out_dropped = [], [], [], 0
    for q in range(d):
        off, rows, vals, dropped = ops.csr_gather(
            starts[q], counts[q], seg_flat[q], capacity=out_capacity
        )
        offsets.append(off)
        slot_rows.append(rows)
        values.append(vals)
        out_dropped = out_dropped + dropped
    num_dropped = owner_dropped + routed.route.num_dropped.sum() + out_dropped
    return (
        torch.stack(offsets),
        torch.stack(slot_rows),
        torch.stack(values),
        counts,
        num_dropped,
    )


def retrieve_sharded(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    out_capacity: int,
    capacity_slack: float = 1.25,
) -> ShardRetrieval:
    """All stored values for every occurrence of every query key."""
    offsets, _, values, counts, num_dropped = _retrieve_parts_fused(
        (dhg,),
        queries,
        seg_capacity=seg_capacity,
        out_capacity=out_capacity,
        capacity_slack=capacity_slack,
    )
    return ShardRetrieval(offsets=offsets, values=values, counts=counts, num_dropped=num_dropped)


def inner_join_sharded(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    out_capacity: int,
    capacity_slack: float = 1.25,
) -> ShardJoin:
    """Materialized inner join ``build ⋈ queries`` as global-row match pairs."""
    d, n_local = queries.shape
    _, slot_rows, values, counts, num_dropped = _retrieve_parts_fused(
        (dhg,),
        queries,
        seg_capacity=seg_capacity,
        out_capacity=out_capacity,
        capacity_slack=capacity_slack,
    )
    rank = torch.arange(d, dtype=torch.int32, device=queries.device).unsqueeze(1)
    query_idx = torch.where(slot_rows >= 0, rank * n_local + slot_rows, -1)
    num_results = torch.clamp(counts.sum(1), max=out_capacity).to(torch.int32)
    return ShardJoin(
        query_idx=query_idx.to(torch.int32),
        values=values,
        num_results=num_results,
        num_dropped=num_dropped,
    )


def plan_caps_sharded(
    layers: Sequence[DistributedHashGraph],
    queries: torch.Tensor,
    *,
    capacity_slack: float = 1.25,
) -> tuple[int, int]:
    """One counts round sizing both retrieval capacities exactly.

    Returns ``(seg_capacity, out_capacity)``: the largest per-(owner, source)
    result total, and the largest per-querier total (the reference's ``pmax``
    and ``max(psum)``).  Its dispatch counts under the ``"plan_caps"`` label.
    """
    d = queries.shape[0]
    with exchange.counting_as("plan_caps"):
        routed = _route_queries_once(layers[0], queries, capacity_slack)
    _, counts_lr, _ = _layer_run_descriptors(layers, routed)
    # block_totals[o, s]: values owner o returns to source s.
    block_totals = counts_lr.to(torch.int64).reshape(len(layers), d, d, routed.capacity)
    block_totals = block_totals.sum(dim=(0, 3))
    seg = int(block_totals.max())
    out = int(block_totals.sum(0).max())
    return seg, out
