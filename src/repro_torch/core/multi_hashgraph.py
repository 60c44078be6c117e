"""Multi-shard HashGraph — Alg. 2 of the paper over a shard group (port of
``repro.core.multi_hashgraph``).

Where the reference runs one program per device under ``shard_map``, the
port runs a process's shards at once: arrays carry a leading axis of the
``local`` shards this process holds, and every cross-shard step goes
through the graph's shard group (``exchange.StackedGroup``: all D shards on
one device, the all-to-all a transpose; ``exchange.ProcessGroup``: one
shard per ``torch.distributed`` rank).  Hashing, histogram, the CSR gathers
and the linear bucket probe run in the port's CUDA kernels on the card, on
the local rows.

Keys are ``(local, N)`` int32 or ``(local, N, 2)`` int32 lanes and values
``(local, N)`` or ``(local, N, C)`` (``repro_torch.core.schema``); the lanes and columns
ride every exchange as trailing dims of one call.  A graph with the
fingerprint lane is probed with the routed batch's fingerprints, computed
once per routing round with its hashes (one kernel 1 launch) and shared by
every layer.

Build (:func:`build_sharded`) follows the paper's four phases: coarse-bin
histogram and balanced splits, counting sort by destination, the
capacity-padded exchange, and one CSR per shard over its hash range; a delta
of a versioned table freezes the base's splits and strides its bucket map.
Reads take a layer stack ``(base, delta_1, ...)`` and the sorted tombstone
index.  On a partition-coherent stack one routing round serves every layer:
a query is one dispatch and one combine, a retrieve or join one dispatch, one
owner-side gather launch over every layer's runs, one ragged return and one
querier-side gather launch — two exchange calls at any depth.  A
mixed-split stack routes each layer on its own splits (two calls per
layer).  :func:`fold_layers_local` merges a coherent prefix with no exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import exchange, hashing, hashgraph, partition
from repro_torch.core.hashgraph import EMPTY_BITS, HashGraph
from repro_torch.kernels import bucket_probe, ops
from repro_torch.utils import cdiv


@dataclasses.dataclass(frozen=True)
class DistributedHashGraph:
    """The shards of the distributed table this process holds.

    ``local`` holds one CSR per local shard (leading axis ``group.local``:
    every shard when stacked, one over a process group).  ``hash_splits``
    and ``num_dropped`` are global, the same in every process.
    ``bucket_stride`` coarsens the rebased-hash → local-bucket map exactly
    as in the reference.  ``group=None`` is the stacked group of the
    ``local`` shards.
    """

    local: HashGraph
    hash_splits: torch.Tensor  # (D+1,) int32
    num_dropped: torch.Tensor  # () int64, capacity overflow during build
    hash_range: int
    seed: int
    local_range_cap: int
    bucket_stride: int = 1
    group: object = None

    def __post_init__(self):
        if self.group is None:
            object.__setattr__(self, "group", exchange.StackedGroup(self.local.keys.shape[0]))


def default_capacity(n_local: int, num_devices: int, slack: float) -> int:
    """Per-destination slot size: balanced share × slack, 8-aligned."""
    base = cdiv(n_local, num_devices)
    cap = int(base * slack) + 8
    return cdiv(cap, 8) * 8


def _shard_lo(hash_splits: torch.Tensor, group) -> torch.Tensor:
    """Each local shard's split base ``splits[rank]`` as a ``(local, 1)``
    column."""
    return group.rows(hash_splits[:-1]).to(torch.int32).unsqueeze(1)


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


def _hash_routed(
    keys: torch.Tensor, hash_range: int, seed: int, fingerprint: bool
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Owner-side hash of received keys, with their fingerprints from the
    same read where ``fingerprint`` (one kernel 1 launch either way)."""
    lanes = hashgraph.shard_lanes(keys)
    if fingerprint:
        return hashing.hash_and_fingerprint(keys, hash_range, seed, lanes)
    return hashing.hash_to_buckets(keys, hash_range, seed, lanes), None


def _local_buckets(
    keys: torch.Tensor,
    lo: torch.Tensor,
    hash_range: int,
    local_cap: int,
    seed: int,
    stride: int = 1,
    fingerprint: bool = False,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Local bucket ids of ``(D, M[, L])`` keys (sentinels to the trash
    bucket) and, where ``fingerprint``, their fingerprints."""
    h, fp = _hash_routed(keys, hash_range, seed, fingerprint)
    is_pad = hashgraph.is_empty_key(keys, hashgraph.shard_lanes(keys))
    return _rebase_buckets(h, is_pad, lo, local_cap, stride), fp


def _wants_fingerprints(layers: Sequence["DistributedHashGraph"]) -> bool:
    """Does any layer carry the fingerprint lane (its probe needs the
    routed batch's fingerprints)?"""
    return any(layer.local.fingerprints is not None for layer in layers)


def build_sharded(
    keys: torch.Tensor,
    *,
    hash_range: int,
    values: Optional[torch.Tensor] = None,
    num_bins: Optional[int] = None,
    capacity_slack: float = 1.25,
    range_slack: float = 1.5,
    seed: int = hashing.DEFAULT_SEED,
    capacity: Optional[int] = None,
    hash_splits: Optional[torch.Tensor] = None,
    local_range_cap: Optional[int] = None,
    bucket_stride: int = 1,
    fingerprint: Optional[bool] = None,
    dest_offsets: Optional[torch.Tensor] = None,
    group=None,
) -> DistributedHashGraph:
    """Build the distributed HashGraph from ``keys`` ``(local, n_local[, L])``
    over ``group`` (``None``: the stacked group of ``keys.shape[0]`` shards).

    ``values`` ``(local, n_local[, C])`` ride along through the exchange
    (default: the global row id ``rank * n_local + i``).  EMPTY sentinels
    are left out of the histogram and the overflow count, routed
    round-robin, and land in the owner's trash bucket.  ``capacity`` overrides the per-destination
    slot size (compaction passes an allowance for its sentinel rows).

    ``hash_splits`` freezes the partitioning: phase 1 is skipped and the
    given splits route the exchange, so a delta stays partition-coherent
    with its base.  ``local_range_cap`` / ``bucket_stride`` size the local
    bucket space (a delta strides the base's bucket map down to O(batch)
    offsets).  ``fingerprint`` stores the probe fingerprint lane (``None``:
    exactly for multi-lane keys), computed owner-side from the received
    keys with their hashes.

    ``dest_offsets`` ``(local, n_local)`` (hot-key replication) send each row to
    ``(hash owner + offset) % D``, so one hot key's rows spread over R
    owners.  An off-owner row lands in the receiver's clamped edge bucket
    (``_rebase_buckets``), where the exact key compare still finds it;
    readers sum one query round per offset (``query_layers_sharded``).
    """
    group = exchange.as_group(group, keys.shape[0])
    d, n_local = group.size, keys.shape[1]
    dev = keys.device
    lanes = hashgraph.shard_lanes(keys)
    if fingerprint is None:
        fingerprint = lanes > 1
    if values is None:
        rank = group.ranks(dev).unsqueeze(1)
        values = rank * n_local + torch.arange(n_local, dtype=torch.int32, device=dev)
    is_pad = hashgraph.is_empty_key(keys, lanes)

    # ---- Phase 1: partitioning.  psum of the local rows' histogram is one
    # histogram over every shard's keys (integer counts commute).
    h = hashing.hash_to_buckets(keys, hash_range, seed, lanes)
    if hash_splits is None:
        bins_g = num_bins or partition.choose_num_bins(hash_range, d)
        ghist = group.psum(partition.local_bin_histogram(h, bins_g, hash_range, valid=~is_pad))
        splits = partition.balanced_hash_splits(ghist, d, hash_range)
    else:
        splits = hash_splits.to(torch.int32)  # frozen: no histogram round

    # ---- Phase 2: reorganization.  Sentinels route round-robin (all EMPTY
    # rows hash alike; by hash they would funnel into one owner's slot).
    dest = partition.destination_of(h, splits)
    del h
    if dest_offsets is not None:
        dest = (dest + dest_offsets.to(torch.int32)) % d
    round_robin = (torch.arange(n_local, dtype=torch.int32, device=dev) % d).expand(
        keys.shape[0], -1)
    dest = torch.where(is_pad, round_robin, dest)

    # ---- Phase 3: movement.
    if capacity is None:
        capacity = default_capacity(n_local, d, capacity_slack)
    (rkeys, rvalues), route = exchange.dispatch(
        (keys, values), dest, capacity, fills=(EMPTY_BITS, -1), count_mask=~is_pad, group=group
    )
    del dest, is_pad

    # ---- Phase 4: local HashGraph creation.
    if local_range_cap is None:
        local_cap = int(cdiv(hash_range, d) * range_slack)
    else:
        local_cap = int(local_range_cap)
    buckets, fp = _local_buckets(
        rkeys, _shard_lo(splits, group), hash_range, local_cap, seed, bucket_stride, fingerprint
    )
    local = hashgraph.build_from_buckets(
        rkeys, buckets, local_cap, rvalues, seed=seed, fingerprints=fp
    )
    return DistributedHashGraph(
        local=local,
        hash_splits=splits,
        num_dropped=group.psum(route.num_dropped.sum()),
        hash_range=hash_range,
        seed=seed,
        local_range_cap=local_cap,
        bucket_stride=bucket_stride,
        group=group,
    )


@dataclasses.dataclass(frozen=True)
class RoutedQueries:
    """One dispatch round of a query batch, seen from the owners."""

    rq: torch.Tensor  # (local, D*capacity[, L]) received keys, EMPTY-padded
    route: exchange.Route
    rh: torch.Tensor  # (local, D*capacity) owner-side hash values
    lo: torch.Tensor  # (local, 1) each local owner's split base
    capacity: int
    rfp: Optional[torch.Tensor] = None  # (local, D*capacity) fingerprints, or None

    @property
    def is_pad(self) -> torch.Tensor:
        """``(local, D*capacity)`` bool: the padding slots (the probe kernel
        finds them itself, so only the other paths compute this)."""
        return hashgraph.is_empty_key(self.rq, hashgraph.shard_lanes(self.rq))


def _route_queries_once(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    capacity_slack: float,
    fingerprint: bool = False,
    dest_offset: int = 0,
) -> RoutedQueries:
    """The one exchange round of the query path (paper §3.3 phase 1):
    hash the queries and dispatch them to their owners by the build splits.
    ``fingerprint`` also computes the routed keys' fingerprints, from the
    same read as their owner-side hashes.  ``dest_offset`` sends every query
    ``r`` shards past its owner: the read of replica ``r`` of hot-key rows
    (a key that was not replicated counts 0 there).

    EMPTY queries (a batch's padding) all hash to one owner and answer
    nothing; past a full slot they are dropped without being counted in
    ``num_dropped`` (the reference counts them, so a padded batch whose
    padding fills a shard overflows there).  Real keys precede a batch's
    padding in the stable dispatch order, so padding never displaces them.
    """
    group = dhg.group
    d, n_local = group.size, queries.shape[1]
    lanes = hashgraph.shard_lanes(queries)
    h = hashing.hash_to_buckets(queries, dhg.hash_range, dhg.seed, lanes)
    dest = partition.destination_of(h, dhg.hash_splits)
    del h
    if dest_offset:
        dest = (dest + dest_offset) % d
    capacity = default_capacity(n_local, d, capacity_slack)
    (rq,), route = exchange.dispatch((queries,), dest, capacity, fills=(EMPTY_BITS,),
                                     count_mask=~hashgraph.is_empty_key(queries, lanes),
                                     group=group)
    rh, rfp = _hash_routed(rq, dhg.hash_range, dhg.seed, fingerprint)
    return RoutedQueries(
        rq=rq,
        route=route,
        rh=rh,
        lo=_shard_lo(dhg.hash_splits, group),
        capacity=capacity,
        rfp=rfp,
    )


def _route_queries(
    dhg: DistributedHashGraph, queries: torch.Tensor, capacity_slack: float,
    dest_offset: int = 0,
) -> tuple[RoutedQueries, torch.Tensor]:
    """:func:`_route_queries_once` plus this graph's own bucket rebase."""
    routed = _route_queries_once(dhg, queries, capacity_slack, _wants_fingerprints((dhg,)),
                                 dest_offset)
    rbuckets = _rebase_buckets(
        routed.rh, routed.is_pad, routed.lo, dhg.local_range_cap, dhg.bucket_stride
    )
    return routed, rbuckets


def _tombstone_epochs(
    rq: torch.Tensor, tombstones: Optional[tuple[torch.Tensor, torch.Tensor]]
) -> Optional[torch.Tensor]:
    """Newest tombstone epoch per routed key, or None without tombstones.

    ``tombstones`` is the sorted ``Tombstones.index()`` pair; one bisection
    per key, computed once per routing round and shared by every layer.
    """
    if tombstones is None:
        return None
    ts_keys, ts_epochs = tombstones
    return hashgraph.match_epochs_sorted(rq, ts_keys, ts_epochs)


def _mask_counts(
    counts: torch.Tensor,
    rq: torch.Tensor,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    layer_epoch: int = 0,
    match_e: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Zero the counts of padding slots and of rows hidden by tombstones.

    A row of the layer with epoch ``layer_epoch`` is hidden iff its key has
    a tombstone of epoch ``>= layer_epoch``.  ``match_e`` is the per-key
    epoch when the caller resolved it once for the routed batch.
    """
    counts = torch.where(hashgraph.is_empty_key(rq, hashgraph.shard_lanes(rq)), 0, counts)
    if match_e is None:
        match_e = _tombstone_epochs(rq, tombstones)
    if match_e is not None:
        counts = torch.where(match_e >= layer_epoch, 0, counts)
    return counts


def _count_layer(
    layer: DistributedHashGraph,
    routed: RoutedQueries,
    match_e: Optional[torch.Tensor],
    epoch: int,
    total: torch.Tensor,
    accumulate: bool,
    paper_faithful_probe: bool,
    max_probe: int,
) -> torch.Tensor:
    """Owner-side multiplicity of each routed key in one layer, masked by
    padding and tombstones (``match_e`` against ``epoch``), written
    (``accumulate=False``) or added into ``total`` in place.

    The paper's linear bucket probe is one launch of kernel 5's layer entry,
    which rebases, looks up the windows, probes and masks by itself; the
    sorted path bisects each bucket."""
    if paper_faithful_probe:
        return bucket_probe.bucket_probe_layer(
            routed.rq, routed.rh, routed.lo, match_e, layer.local.offsets, layer.local.keys,
            table_size=layer.local_range_cap, stride=layer.bucket_stride, epoch=epoch,
            max_probe=max_probe, total=total, accumulate=accumulate,
        )
    rb = _rebase_buckets(
        routed.rh, routed.is_pad, routed.lo, layer.local_range_cap, layer.bucket_stride
    )
    counts = hashgraph.query_count_sorted(layer.local, routed.rq, rb, routed.rfp)
    counts = _mask_counts(counts, routed.rq, layer_epoch=epoch, match_e=match_e)
    return total.add_(counts) if accumulate else total.copy_(counts)


def query_sharded(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    capacity_slack: float = 1.25,
    paper_faithful_probe: bool = False,
    max_probe: int = 64,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    layer_epoch: int = 0,
    dest_offset: int = 0,
) -> torch.Tensor:
    """Multiplicity ``(local, n_local)`` int32 of each query key: route by the
    build splits, count against the owner's shard, route counts back.
    ``tombstones`` / ``layer_epoch`` mask rows deleted from this layer;
    ``dest_offset`` counts replica ``r`` of hot-key rows."""
    routed = _route_queries_once(
        dhg, queries, capacity_slack,
        not paper_faithful_probe and _wants_fingerprints((dhg,)), dest_offset,
    )
    counts = torch.empty(routed.rh.shape, dtype=torch.int32, device=queries.device)
    _count_layer(
        dhg, routed, _tombstone_epochs(routed.rq, tombstones), layer_epoch, counts,
        False, paper_faithful_probe, max_probe,
    )
    return exchange.combine(counts, routed.route, fill=0)


def contains_sharded(dhg: DistributedHashGraph, queries: torch.Tensor, **kw) -> torch.Tensor:
    """Membership of each query key, ``(local, n_local)`` bool: one layer's
    :func:`query_sharded` counts above 0."""
    return query_sharded(dhg, queries, **kw) > 0


def join_size_sharded(dhg: DistributedHashGraph, queries: torch.Tensor, **kw) -> torch.Tensor:
    """Global inner-join cardinality |build ⋈ queries| of one layer (the
    paper's intersection): the counts summed over the group, an int64
    scalar, the same in every process."""
    return dhg.group.psum(query_sharded(dhg, queries, **kw).sum())


def query_layers_sharded(
    layers: Sequence[DistributedHashGraph],
    queries: torch.Tensor,
    *,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    fused: Optional[bool] = None,
    capacity_slack: float = 1.25,
    paper_faithful_probe: bool = False,
    max_probe: int = 64,
    dest_offset: int = 0,
) -> torch.Tensor:
    """Merged multiplicity over a versioned stack ``(base, delta_1, ...)``.

    ``fused`` (valid only for a partition-coherent stack) routes once for
    every layer: one dispatch and one combine, two exchange calls at any
    depth; the layers' counts go into one running total in epoch order
    (with the probe, one kernel launch a layer).  ``fused=False`` routes
    each layer on its own splits, two calls per layer.  ``None`` fuses only
    the single-layer stack.  ``dest_offset`` routes every query that many
    shards past its owner (replica ``r`` of hot-key rows).
    """
    layers = tuple(layers)
    if fused is None:
        fused = len(layers) == 1
    kw = dict(
        capacity_slack=capacity_slack,
        paper_faithful_probe=paper_faithful_probe,
        max_probe=max_probe,
        dest_offset=dest_offset,
    )
    if not fused:
        total = None
        for epoch, layer in enumerate(layers):
            c = query_sharded(layer, queries, tombstones=tombstones, layer_epoch=epoch, **kw)
            total = c if total is None else total + c
        return total

    routed = _route_queries_once(
        layers[0], queries, capacity_slack,
        not paper_faithful_probe and _wants_fingerprints(layers), dest_offset,
    )
    match_e = _tombstone_epochs(routed.rq, tombstones)
    total = torch.empty(routed.rh.shape, dtype=torch.int32, device=queries.device)
    for epoch, layer in enumerate(layers):
        _count_layer(
            layer, routed, match_e, epoch, total, epoch > 0, paper_faithful_probe, max_probe
        )
    # One merged return trip carries the whole stack's counts.
    return exchange.combine(total, routed.route, fill=0)


def join_size_layers_sharded(
    layers: Sequence[DistributedHashGraph], queries: torch.Tensor, **kw
) -> torch.Tensor:
    """Global inner-join cardinality against a versioned stack (int64 scalar,
    the same in every process)."""
    return layers[0].group.psum(query_layers_sharded(layers, queries, **kw).sum())


@dataclasses.dataclass(frozen=True)
class ShardRetrieval:
    """Per-shard CSR of retrieved values: query ``i`` of shard ``s`` has
    ``values[s, offsets[s, i] : offsets[s, i+1]]``.

    ``num_dropped`` is zero iff no static capacity truncated a result;
    when positive it is an overflow indicator, not an exact loss count.
    ``layer_counts`` (``retrieve(..., per_layer_counts=True)``) splits each
    query's count by layer, base first: ``layer_counts[s, i].sum() ==
    counts[s, i]``.  On the fused path it rides the values' return call.
    """

    offsets: torch.Tensor  # (local, n_local + 1) int32
    values: torch.Tensor  # (local, out_capacity[, C]) int32
    counts: torch.Tensor  # (local, n_local) int32
    num_dropped: torch.Tensor  # () int64, over every shard
    layer_counts: Optional[torch.Tensor] = None  # (local, n_local, L) int32


@dataclasses.dataclass(frozen=True)
class ShardJoin:
    """Per-shard join pairs ``(query_idx[s, j], values[s, j])`` for
    ``j < num_results[s]``; ``query_idx`` is the global query row id."""

    query_idx: torch.Tensor  # (local, out_capacity) int32, -1 beyond num_results
    values: torch.Tensor  # (local, out_capacity[, C]) int32
    num_results: torch.Tensor  # (local,) int32
    num_dropped: torch.Tensor  # () int64, over every shard


def _layer_run_descriptors(
    layers: Sequence[DistributedHashGraph],
    routed: RoutedQueries,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """Owner-side locate of the routed batch in every layer (no exchange).

    Returns ``(starts, counts, tables)``: ``(L, local, R)`` run descriptors
    (``R`` routed slots per owner), each start indexing its own layer's
    values table, and the per-layer ``(local, M_l[, C])`` tables.  Tombstone
    epochs are resolved once for the batch and mask every layer (and the
    fingerprints, where the routing computed them, serve every layer).
    """
    match_e = _tombstone_epochs(routed.rq, tombstones)
    starts_l, counts_l, tables = [], [], []
    for epoch, layer in enumerate(layers):
        rb = _rebase_buckets(
            routed.rh, routed.is_pad, routed.lo, layer.local_range_cap, layer.bucket_stride
        )
        s, c = hashgraph.query_locate(layer.local, routed.rq, rb, routed.rfp)
        starts_l.append(s)
        counts_l.append(_mask_counts(c, routed.rq, tombstones, epoch, match_e))
        tables.append(layer.local.values)
    return torch.stack(starts_l), torch.stack(counts_l), tuple(tables)


def _owner_gather(starts, counts, tables, seg_capacity, d, cap):
    """Every local owner packs every source's runs of every layer
    (slot-major, epoch order) into one segment per (owner, source): one
    launch of ``csr_gather_owners``.  ``starts``/``counts`` are ``(L, local,
    d*cap)``.  Returns ``(segments (local, d, seg_capacity[, C]), slot totals
    (local, d*cap), num_dropped)``, the drops of the local owners."""
    nl, local = counts.shape[:2]
    seg, dropped, slot_counts = ops.csr_gather_owners(
        starts.reshape(nl, local, d, cap), counts.reshape(nl, local, d, cap), tables,
        capacity=seg_capacity,
    )
    return seg, slot_counts.reshape(local, d * cap), dropped


def _retrieve_parts_fused(
    layers: Sequence[DistributedHashGraph],
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    out_capacity: int,
    capacity_slack: float,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    per_layer: bool = False,
):
    """Single-route merged retrieval over a coherent stack: two exchange calls.

    One dispatch routes the queries; each owner locates them in every layer
    and packs every source's runs (slot-major, epoch order) into one segment
    (one owner-side gather launch for all owners and layers); one ragged
    return ships segments and per-slot totals home (with ``per_layer`` also
    the L per-layer count planes, in the same call); each querier compacts
    its runs (one querier-side gather launch for all queriers).
    ``num_dropped`` is the local rows' (the caller sums it over the group).
    """
    d = layers[0].group.size
    routed = _route_queries_once(layers[0], queries, capacity_slack, _wants_fingerprints(layers))
    starts_lr, counts_lr, tables = _layer_run_descriptors(layers, routed, tombstones)
    seg, slot_counts, owner_dropped = _owner_gather(
        starts_lr, counts_lr, tables, seg_capacity, d, routed.capacity
    )
    del starts_lr
    # One ragged return: per-slot totals reconstruct, on the querier, the
    # interleaved offsets the owner packed with.
    returned = exchange.combine_ragged(
        seg, slot_counts, routed.route, layer_counts=counts_lr if per_layer else None
    )
    del counts_lr
    counts, starts, seg_flat = returned[:3]
    offsets, slot_rows, values, out_dropped = ops.csr_gather_queriers(
        starts, counts, seg_flat, capacity=out_capacity
    )
    num_dropped = owner_dropped + routed.route.num_dropped.sum() + out_dropped
    layer_counts = returned[3] if per_layer else None
    return offsets, slot_rows, values, counts, num_dropped, layer_counts


def _retrieve_runs(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    capacity_slack: float,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]],
    layer_epoch: int,
):
    """One layer's own routing, owner-side gather (one launch) and return
    trip (two exchange calls).  Returns ``(counts, starts, seg_flat,
    dropped)`` in the querier's row order: row ``i``'s values are
    ``seg_flat[s, starts[s, i] : starts[s, i] + counts[s, i]]``."""
    d = dhg.group.size
    routed, rbuckets = _route_queries(dhg, queries, capacity_slack)
    run_starts, run_counts = hashgraph.query_locate(dhg.local, routed.rq, rbuckets, routed.rfp)
    run_counts = _mask_counts(run_counts, routed.rq, tombstones, layer_epoch)
    seg, slot_counts, owner_dropped = _owner_gather(
        run_starts[None], run_counts[None], (dhg.local.values,), seg_capacity, d,
        routed.capacity,
    )
    counts, starts, seg_flat = exchange.combine_ragged(seg, slot_counts, routed.route)
    return counts, starts, seg_flat, owner_dropped + routed.route.num_dropped.sum()


def _retrieve_parts(
    layers: Sequence[DistributedHashGraph],
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    out_capacity: int,
    capacity_slack: float = 1.25,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    fused: Optional[bool] = None,
    per_layer: bool = False,
):
    """Merged retrieval over a layer stack: ``(offsets, query_rows, values,
    counts, num_dropped, layer_counts)`` per local querier shard
    (``layer_counts`` ``(local, n_local, L)`` with ``per_layer``, else None;
    ``num_dropped`` summed over the group: one ``psum``).

    ``fused`` (coherent stacks only) takes :func:`_retrieve_parts_fused`.
    Otherwise each layer runs :func:`_retrieve_runs` on its own splits, and
    one querier-side gather compacts every layer's returned runs: the
    per-layer run descriptors are interleaved query-major, so the gather
    yields the merged values directly and every L-th offset is a query's.
    ``query_rows`` is each output slot's local query row (-1 unused).
    """
    layers = tuple(layers)
    nlayers = len(layers)
    if fused is None:
        fused = nlayers == 1
    group = layers[0].group
    if fused:
        parts = _retrieve_parts_fused(
            layers,
            queries,
            seg_capacity=seg_capacity,
            out_capacity=out_capacity,
            capacity_slack=capacity_slack,
            tombstones=tombstones,
            per_layer=per_layer,
        )
        return parts[:4] + (group.psum(parts[4]),) + parts[5:]
    d, n_local = queries.shape[:2]
    counts_l, starts_l, segs_l, dropped = [], [], [], 0
    for epoch, layer in enumerate(layers):
        counts, starts, seg_flat, drop = _retrieve_runs(
            layer,
            queries,
            seg_capacity=seg_capacity,
            capacity_slack=capacity_slack,
            tombstones=tombstones,
            layer_epoch=epoch,
        )
        counts_l.append(counts)
        starts_l.append(starts + epoch * seg_flat.shape[1])
        segs_l.append(seg_flat)
        dropped = dropped + drop
    seg_all = torch.cat(segs_l, dim=1)
    counts_il = torch.stack(counts_l, dim=2).reshape(d, n_local * nlayers)
    starts_il = torch.stack(starts_l, dim=2).reshape(d, n_local * nlayers)
    offsets_il, slot_rows, values, out_dropped = ops.csr_gather_queriers(
        starts_il, counts_il, seg_all, capacity=out_capacity
    )
    offsets = offsets_il[:, ::nlayers].contiguous()
    counts = counts_il.reshape(d, n_local, nlayers).sum(2).to(torch.int32)
    query_rows = torch.where(
        slot_rows >= 0, torch.div(slot_rows, nlayers, rounding_mode="floor"), -1
    ).to(torch.int32)
    layer_counts = torch.stack(counts_l, dim=2).to(torch.int32) if per_layer else None
    return offsets, query_rows, values, counts, group.psum(dropped + out_dropped), layer_counts


def retrieve_layers_sharded(
    layers: Sequence[DistributedHashGraph],
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    out_capacity: int,
    capacity_slack: float = 1.25,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    fused: Optional[bool] = None,
    per_layer_counts: bool = False,
) -> ShardRetrieval:
    """All live values for every occurrence of every query key over a
    versioned stack; each query's values are its layers' runs in epoch order.
    ``per_layer_counts`` fills ``layer_counts`` (on the fused path in the
    same return call as the values: still two exchange calls)."""
    offsets, _, values, counts, num_dropped, layer_counts = _retrieve_parts(
        layers,
        queries,
        seg_capacity=seg_capacity,
        out_capacity=out_capacity,
        capacity_slack=capacity_slack,
        tombstones=tombstones,
        fused=fused,
        per_layer=per_layer_counts,
    )
    return ShardRetrieval(offsets=offsets, values=values, counts=counts, num_dropped=num_dropped,
                          layer_counts=layer_counts)


def retrieve_sharded(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    out_capacity: int,
    capacity_slack: float = 1.25,
) -> ShardRetrieval:
    """All stored values of every query key in one layer: the one-layer
    stack of :func:`retrieve_layers_sharded`."""
    return retrieve_layers_sharded((dhg,), queries, seg_capacity=seg_capacity,
                                   out_capacity=out_capacity, capacity_slack=capacity_slack)


def inner_join_layers_sharded(
    layers: Sequence[DistributedHashGraph],
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    out_capacity: int,
    capacity_slack: float = 1.25,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    fused: Optional[bool] = None,
) -> ShardJoin:
    """Materialized inner join against a versioned stack, as global-row pairs."""
    n_local = queries.shape[1]
    _, query_rows, values, counts, num_dropped, _ = _retrieve_parts(
        layers,
        queries,
        seg_capacity=seg_capacity,
        out_capacity=out_capacity,
        capacity_slack=capacity_slack,
        tombstones=tombstones,
        fused=fused,
    )
    rank = layers[0].group.ranks(queries.device).unsqueeze(1)
    query_idx = torch.where(query_rows >= 0, rank * n_local + query_rows, -1)
    num_results = torch.clamp(counts.sum(1), max=out_capacity).to(torch.int32)
    return ShardJoin(
        query_idx=query_idx.to(torch.int32),
        values=values,
        num_results=num_results,
        num_dropped=num_dropped,
    )


def inner_join_sharded(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    seg_capacity: int,
    out_capacity: int,
    capacity_slack: float = 1.25,
) -> ShardJoin:
    """Materialized inner join ``build ⋈ queries`` of one layer as
    global-row pairs: the one-layer stack of :func:`inner_join_layers_sharded`."""
    return inner_join_layers_sharded((dhg,), queries, seg_capacity=seg_capacity,
                                     out_capacity=out_capacity, capacity_slack=capacity_slack)


def _plan_block_totals(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    capacity_slack: float,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]],
    layer_epoch: int,
) -> torch.Tensor:
    """``(local_owner, D_src)`` values one layer's local owners return to
    each source, routed exactly like :func:`_retrieve_runs` (one dispatch)."""
    d = dhg.group.size
    routed, rbuckets = _route_queries(dhg, queries, capacity_slack)
    _, run_counts = hashgraph.query_locate(dhg.local, routed.rq, rbuckets, routed.rfp)
    run_counts = _mask_counts(run_counts, routed.rq, tombstones, layer_epoch)
    return run_counts.to(torch.int64).reshape(-1, d, routed.capacity).sum(2)


def plan_seg_capacity_sharded(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    capacity_slack: float = 1.25,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    layer_epoch: int = 0,
) -> int:
    """The exact ``seg_capacity`` one layer's retrieval needs: the largest
    per-(owner, source) total over the group (the reference's ``pmax``).
    One counts round, counted under ``"plan_caps"``."""
    with exchange.counting_as("plan_caps"):
        totals = _plan_block_totals(dhg, queries, capacity_slack=capacity_slack,
                                    tombstones=tombstones, layer_epoch=layer_epoch)
    return int(dhg.group.pmax(totals.max()))


def plan_out_capacity_sharded(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    capacity_slack: float = 1.25,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    layer_epoch: int = 0,
) -> int:
    """The exact ``out_capacity`` one layer's retrieval needs: the largest
    per-querier total, the owners' per-source totals summed over the group
    (the reference's ``max(psum)``).  One counts round, counted under
    ``"plan_caps"``."""
    with exchange.counting_as("plan_caps"):
        totals = _plan_block_totals(dhg, queries, capacity_slack=capacity_slack,
                                    tombstones=tombstones, layer_epoch=layer_epoch)
    return int(dhg.group.psum(totals.sum(0)).max())


def plan_caps_sharded(
    layers: Sequence[DistributedHashGraph],
    queries: torch.Tensor,
    *,
    capacity_slack: float = 1.25,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    fused: Optional[bool] = None,
) -> tuple[int, int]:
    """One counts round sizing both retrieval capacities exactly.

    Returns ``(seg_capacity, out_capacity)``: the largest per-(owner, source)
    segment and the largest per-querier total (the reference's ``pmax`` and
    ``max(psum)``, over the group before they reach the host, so every
    process sizes the same buffers).  ``fused`` must match the path being
    planned: the fused path packs every layer into one segment (one routing
    round), the per-layer path one segment per layer (one round per layer).
    Its dispatches count under the ``"plan_caps"`` label.
    """
    layers = tuple(layers)
    group = layers[0].group
    d = group.size
    if fused is None:
        fused = len(layers) == 1
    with exchange.counting_as("plan_caps"):
        if fused:
            routed = _route_queries_once(
                layers[0], queries, capacity_slack, _wants_fingerprints(layers)
            )
            _, counts_lr, _ = _layer_run_descriptors(layers, routed, tombstones)
            # block_totals[o, s]: values local owner o returns to source s.
            block_totals = counts_lr.to(torch.int64).reshape(len(layers), -1, d, routed.capacity)
            block_totals = block_totals.sum(dim=(0, 3))
            seg_local = block_totals.max()
        else:
            seg_local, block_totals = None, 0
            for epoch, layer in enumerate(layers):
                layer_totals = _plan_block_totals(
                    layer,
                    queries,
                    capacity_slack=capacity_slack,
                    tombstones=tombstones,
                    layer_epoch=epoch,
                )
                top = layer_totals.max()
                seg_local = top if seg_local is None else torch.maximum(seg_local, top)
                block_totals = block_totals + layer_totals
    return int(group.pmax(seg_local)), int(group.psum(block_totals.sum(0)).max())


def build_query_hashgraph_sharded(
    dhg: DistributedHashGraph,
    queries: torch.Tensor,
    *,
    capacity_slack: float = 1.25,
) -> HashGraph:
    """The paper's query phase 1: a second HashGraph built from the query
    set, routed by the build's splits and bucketed by its map (one dispatch;
    kernel 1 hashes before and after it, kernel 2 does not run).  Each local
    owner's CSR holds the queries it received, values their slot in the
    routed batch, sorted within each bucket, with the fingerprint lane
    where ``dhg`` has it."""
    routed, rbuckets = _route_queries(dhg, queries, capacity_slack)
    local, m = routed.rq.shape[:2]
    slots = torch.arange(m, dtype=torch.int32, device=queries.device).expand(local, m)
    return hashgraph.build_from_buckets(
        routed.rq, rbuckets, dhg.local_range_cap, slots.contiguous(), seed=dhg.seed,
        fingerprints=routed.rfp if dhg.local.fingerprints is not None else None,
    )


def fold_layers_local(
    layers: Sequence[DistributedHashGraph],
    *,
    tombstones: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> DistributedHashGraph:
    """Merge a partition-coherent layer prefix into one graph, with no exchange.

    Every delta of a coherent stack was built on the base's splits, so each
    shard already owns its hash range's rows in every layer: mask tombstoned
    rows to EMPTY (a tombstone of epoch ``e`` hides layer ``i`` iff
    ``e >= i``), concatenate each shard's rows, re-bucket through the base's
    map and build one fresh CSR per shard.  The caller remaps the surviving
    tombstones (``repro_torch.core.maintenance``).  Invalid for mixed-split
    stacks.
    """
    layers = tuple(layers)
    base = layers[0]
    keys_parts, vals_parts = [], []
    dropped = base.num_dropped
    lanes = base.local.key_lanes
    for epoch, layer in enumerate(layers):
        k = layer.local.keys
        dead = hashgraph.is_empty_key(k, lanes)
        if tombstones is not None and tombstones[0].shape[0]:
            dead = dead | (
                hashgraph.match_epochs_sorted(k, tombstones[0], tombstones[1]) >= epoch
            )
        keys_parts.append(torch.where(dead.unsqueeze(-1) if lanes > 1 else dead, EMPTY_BITS, k))
        vals_parts.append(layer.local.values)
        if epoch:
            dropped = dropped + layer.num_dropped
    keys_cat = torch.cat(keys_parts, dim=1)
    vals_cat = torch.cat(vals_parts, dim=1)
    del keys_parts, vals_parts
    buckets, fp = _local_buckets(
        keys_cat,
        _shard_lo(base.hash_splits, base.group),
        base.hash_range,
        base.local_range_cap,
        base.seed,
        base.bucket_stride,
        fingerprint=base.local.fingerprints is not None,
    )
    local = hashgraph.build_from_buckets(
        keys_cat, buckets, base.local_range_cap, vals_cat, seed=base.seed, fingerprints=fp
    )
    return dataclasses.replace(base, local=local, num_dropped=dropped)
