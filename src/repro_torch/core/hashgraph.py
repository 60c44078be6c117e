"""CSR HashGraph on stacked shards (port of ``repro.core.hashgraph``).

Each shard's table is the CSR of (bucket × key): bucket ``v`` of shard ``s``
holds ``keys[s, offsets[s, v] : offsets[s, v+1]]``; bucket ``V`` is the trash
bucket for padding.  All arrays carry a leading shard axis ``D``; keys are
``(D, M)`` int32 or ``(D, M, 2)`` int32 lanes and values ``(D, M)`` or
``(D, M, C)`` (``repro_torch.core.schema`` states the layout).

The reference's stable ``jax.lax.sort`` over (bucket, [fingerprint,] key)
with values riding along becomes, for 1-lane keys without a fingerprint, one
stable ``torch.sort`` of the int64 ``(bucket << 32) | key`` per shard row;
(bucket, fp, key-hi, key-lo) is 127 bits, so wider rows take two stable
sorts: by the key's order view (:func:`key_order`), then by ``(bucket << 32)
| fp``, which keeps equal keys in input order.  Comparisons run on the order
view: the int32 bits with the sign flipped (uint32 order) or the int64 view
of the two lanes with the sign flipped (the reference's packed order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import hashing
from repro_torch.utils import take_rows

# Sentinel key marking capacity padding: all ones in every lane (0xFFFFFFFF
# as an int32 bit pattern, -1 in the int64 view of two lanes).
EMPTY_KEY = 0xFFFFFFFF
EMPTY_BITS = -1
_SIGN = -(2**31)
_SIGN64 = -(2**63)
_MASK = 0xFFFFFFFF


def shard_lanes(keys: torch.Tensor) -> int:
    """Key lanes of a shard-stacked ``(D, N)`` or ``(D, N, L)`` key array."""
    return 1 if keys.ndim == 2 else int(keys.shape[-1])


def key_words(keys: torch.Tensor, lanes: int) -> torch.Tensor:
    """One word per key: the int32 bits (1 lane) or the int64 view of the
    two lanes ``(..., 2)`` → ``(...)`` (the uint64 bit pattern)."""
    if lanes == 1:
        return keys
    if lanes != 2:
        raise ValueError(f"keys of {lanes} lanes are not supported (1 or 2)")
    return keys.contiguous().view(torch.int64)[..., 0]


def words_to_keys(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`key_words`: int64 words → ``(..., 2)`` int32 lanes."""
    if words.dtype == torch.int32:
        return words
    return words.contiguous().unsqueeze(-1).view(torch.int32)


def key_order(keys: torch.Tensor, lanes: int) -> torch.Tensor:
    """Keys mapped so that signed order is the reference's unsigned order
    (lane 1 most significant): :func:`key_words` with the sign bit flipped."""
    return key_words(keys, lanes) ^ (_SIGN if lanes == 1 else _SIGN64)


def is_empty_key(keys: torch.Tensor, lanes: int = 1) -> torch.Tensor:
    """Padding-sentinel mask: every lane EMPTY."""
    empty = keys == EMPTY_BITS
    return empty.all(-1) if lanes > 1 else empty


@dataclasses.dataclass(frozen=True)
class HashGraph:
    """Stacked CSR hash tables, one per shard: ``offsets`` ``(D, V+2)``.

    With ``fingerprints`` the rows of a bucket are ordered by (fingerprint,
    key) instead of (key): the sorted probe bisects the one-lane
    fingerprints first and the key lanes only inside the fingerprint's run.
    ``sorted_within_bucket=False`` (the single-card :func:`build` option)
    keeps a bucket's rows in input order: only the linear probe reads it.
    """

    offsets: torch.Tensor  # (D, V+2) int32, monotone per row
    keys: torch.Tensor  # (D, M) int32 or (D, M, L) int32 lanes, grouped by bucket
    values: torch.Tensor  # (D, M) or (D, M, C) int32 payload
    table_size: int  # V
    seed: int
    fingerprints: Optional[torch.Tensor] = None  # (D, M) int32 uint32 bits, or None
    sorted_within_bucket: bool = True

    @property
    def capacity(self) -> int:
        """Rows of one shard's CSR."""
        return int(self.keys.shape[1])

    @property
    def key_lanes(self) -> int:
        return shard_lanes(self.keys)

    @property
    def value_cols(self) -> int:
        return 1 if self.values.ndim == 2 else int(self.values.shape[-1])

    @property
    def num_valid(self) -> torch.Tensor:
        """Non-padding rows (each shard's trash-bucket start), summed over
        the shards: a () int64 tensor."""
        return self.offsets[:, self.table_size].sum()

    def bucket_of(self, queries: torch.Tensor) -> torch.Tensor:
        """``hash(q) % table_size`` of keys of this graph's lane count."""
        return hashing.hash_to_buckets(queries, self.table_size, self.seed, self.key_lanes)


def build_from_buckets(
    keys: torch.Tensor,
    buckets: torch.Tensor,
    table_size: int,
    values: torch.Tensor,
    *,
    seed: int = hashing.DEFAULT_SEED,
    fingerprints: Optional[torch.Tensor] = None,
    sort_within_bucket: bool = True,
) -> HashGraph:
    """Build one CSR per shard row from precomputed bucket ids.

    ``buckets`` may hold ``table_size`` to send padding to the trash bucket.
    Rows sort by (bucket, [fingerprint,] key in the reference's packed
    order), stably, so equal keys keep their input order, as the
    reference's stable ``lax.sort`` does.  ``fingerprints`` ``(D, M)`` (the
    keys' ``hashing.fingerprint32``) turn the fingerprint lane on.
    ``sort_within_bucket=False`` sorts stably by bucket alone (a bucket's
    rows in input order, no fingerprint lane), as the reference does.
    """
    d = keys.shape[0]
    lanes = shard_lanes(keys)
    if not sort_within_bucket:
        fingerprints = None
    # sort_key >> 32 is the bucket where sort_key packs (bucket, key or fp).
    packed = sort_within_bucket and (lanes == 1 or fingerprints is not None)
    if not sort_within_bucket:
        sort_key, idx = torch.sort(buckets.to(torch.int64), dim=1, stable=True)
    elif lanes == 1 and fingerprints is None:
        sort_key = (buckets.to(torch.int64) << 32) | (keys.to(torch.int64) & _MASK)
        sort_key, idx = torch.sort(sort_key, dim=1, stable=True)
    else:
        # Two stable sorts: by the key, then by (bucket, [fp]).
        _, idx = torch.sort(key_order(keys, lanes), dim=1, stable=True)
        outer = buckets.to(torch.int64)
        if fingerprints is not None:
            outer = (outer << 32) | (fingerprints.to(torch.int64) & _MASK)
        sort_key, idx2 = torch.sort(torch.gather(outer, 1, idx), dim=1, stable=True)
        del outer
        idx = torch.gather(idx, 1, idx2)
        del idx2
    sorted_keys = words_to_keys(torch.gather(key_words(keys, lanes), 1, idx))
    sorted_values = take_rows(values, idx)
    sorted_fp = None if fingerprints is None else torch.gather(fingerprints, 1, idx)
    del idx
    sorted_buckets = sort_key >> 32 if packed else sort_key
    del sort_key
    ids = torch.arange(table_size + 2, dtype=torch.int64, device=keys.device)
    # offsets[v] = first row whose bucket id >= v ;  offsets[V+1] = M.
    offsets = torch.searchsorted(
        sorted_buckets, ids.expand(d, -1).contiguous(), side="left", out_int32=True
    )
    return HashGraph(
        offsets=offsets,
        keys=sorted_keys,
        values=sorted_values,
        table_size=table_size,
        seed=seed,
        fingerprints=sorted_fp,
        sorted_within_bucket=sort_within_bucket,
    )


def build(
    keys: torch.Tensor,
    table_size: int,
    values: Optional[torch.Tensor] = None,
    *,
    seed: int = hashing.DEFAULT_SEED,
    sort_within_bucket: bool = True,
    fingerprint: Optional[bool] = None,
) -> HashGraph:
    """Hash ``keys`` and build one CSR (Alg. 1): the single-card table.

    ``keys`` are ``(N,)`` int32 uint32 bits or ``(N, L)`` int32 lanes on
    the device the graph is to live on; ``values`` ``(N,)`` or ``(N, C)``
    int32 (default: row ids).  The graph is the stacked form with one
    shard (``offsets`` ``(1, V+2)``).  The hash runs in kernel 1 on the
    card, with the fingerprints from the same read where the lane is on
    (``fingerprint=None``: exactly for multi-lane keys; never without
    ``sort_within_bucket``).
    """
    lanes = 1 if keys.ndim == 1 else int(keys.shape[-1])
    if values is None:
        values = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    if fingerprint is None:
        fingerprint = lanes > 1
    fingerprint = bool(fingerprint) and sort_within_bucket
    if fingerprint:
        buckets, fp = hashing.hash_and_fingerprint(keys, table_size, seed, lanes)
        fp = fp.unsqueeze(0)
    else:
        buckets, fp = hashing.hash_to_buckets(keys, table_size, seed, lanes), None
    return build_from_buckets(
        keys.unsqueeze(0), buckets.unsqueeze(0), table_size, values.unsqueeze(0), seed=seed,
        fingerprints=fp, sort_within_bucket=sort_within_bucket,
    )


def _stacked(hg: HashGraph, queries: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``queries`` in the graph's stacked ``(D, n[, L])`` form, and whether
    they came so: unstacked ``(n,)`` / ``(n, L)`` queries of a one-shard
    graph gain the shard axis (results drop it again)."""
    if queries.ndim == hg.keys.ndim:
        return queries, True
    if hg.keys.shape[0] != 1:
        raise ValueError(
            f"unstacked queries need a one-shard graph, got {hg.keys.shape[0]} shards"
        )
    return queries.unsqueeze(0), False


def _unstack(x: torch.Tensor, stacked: bool) -> torch.Tensor:
    return x if stacked else x[0]


def _window_trips(lo: torch.Tensor, hi: torch.Tensor) -> int:
    """Bisection steps that settle every window ``[lo, hi)``: the bit length
    of the widest (one device read)."""
    return int((hi - lo).max()).bit_length() if lo.numel() else 0


def _segment_searchsorted(
    sorted_keys: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    q: torch.Tensor,
    side: str,
    trips: Optional[int] = None,
) -> torch.Tensor:
    """Per-row binary search of ``q[s, i]`` within ``sorted_keys[s, lo:hi]``.

    ``sorted_keys`` and ``q`` are order views (:func:`key_order`, or a
    fingerprint lane with its sign flipped), int32 or int64.
    The reference runs a fixed ``bit_length(M)`` trips; each trip at least
    halves every window and lanes with ``lo == hi`` never move, so
    ``trips`` = the widest window's bit length (:func:`_window_trips`, the
    default; buckets hold a few keys) gives the same result with one device
    read for the whole search instead of one a trip.
    """
    m = sorted_keys.shape[1]
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    if trips is None:
        trips = _window_trips(lo, hi)
    for _ in range(min(trips, max(1, int(m).bit_length()))):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = torch.gather(sorted_keys, 1, torch.clamp(mid, 0, m - 1))
        go_right = (v < q) if side == "left" else (v <= q)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def bucket_windows(
    offsets: torch.Tensor, table_size: int, buckets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(starts, ends)`` int32 of each routed query's bucket in a ``(D, V+2)``
    CSR ``offsets``, with an empty window at the trash bucket ``V``
    (exchange padding)."""
    b = buckets.to(torch.int64)
    starts = torch.gather(offsets, 1, b)
    ends = torch.where(b == table_size, starts, torch.gather(offsets, 1, b + 1))
    return starts, ends


def query_locate(
    hg: HashGraph,
    queries: torch.Tensor,
    buckets: Optional[torch.Tensor] = None,
    qfp: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each routed query's match run per shard: ``(starts, counts)`` int32.

    All occurrences of a key are contiguous in a bucket-sorted shard, so the
    matches of ``queries[s, i]`` are ``keys[s, starts : starts + counts]``.
    ``buckets`` are the local bucket ids the caller routed the queries to
    (``None``: ``hg.bucket_of``, the single-card table's; unstacked queries
    of a one-shard graph give unstacked results).
    With a fingerprint lane the window is bisected on the fingerprints
    first and on the keys only inside the fingerprint's run; ``qfp`` are
    the queries' fingerprints when the caller computed them once for every
    layer (ignored by a graph without the lane).

    A query routed to the trash bucket ``V`` is exchange padding: its window
    is empty, so it counts 0 without a search.  (The reference bisects the
    trash bucket, which holds every padding row of the build, and its
    callers then mask those counts to 0; the masked results are the same.)
    """
    if not hg.sorted_within_bucket:
        raise ValueError("query_locate needs a bucket-sorted HashGraph")
    queries, stacked = _stacked(hg, queries)
    if buckets is None:
        buckets = hg.bucket_of(queries)
    elif not stacked:
        buckets = buckets.unsqueeze(0)
    if qfp is not None and not stacked:
        qfp = qfp.unsqueeze(0)
    lanes = hg.key_lanes
    starts, ends = bucket_windows(hg.offsets, hg.table_size, buckets)
    if hg.fingerprints is not None:
        if qfp is None:
            qfp = hashing.fingerprint32(queries, lanes)
        fp_u, qfp_u = hg.fingerprints ^ _SIGN, qfp ^ _SIGN
        trips = _window_trips(starts, ends)
        fl = _segment_searchsorted(fp_u, starts, ends, qfp_u, side="left", trips=trips)
        fr = _segment_searchsorted(fp_u, starts, ends, qfp_u, side="right", trips=trips)
        del fp_u, qfp_u
        starts, ends = fl, fr
    keys_u = key_order(hg.keys, lanes)
    q_u = key_order(queries, lanes)
    trips = _window_trips(starts, ends)
    left = _segment_searchsorted(keys_u, starts, ends, q_u, side="left", trips=trips)
    right = _segment_searchsorted(keys_u, starts, ends, q_u, side="right", trips=trips)
    return (_unstack(left.to(torch.int32), stacked),
            _unstack((right - left).to(torch.int32), stacked))


def query_count_sorted(
    hg: HashGraph,
    queries: torch.Tensor,
    buckets: Optional[torch.Tensor] = None,
    qfp: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact multiplicity of each query key by per-bucket bisection
    (``buckets=None``: the single-card table's own buckets)."""
    return query_locate(hg, queries, buckets, qfp)[1]


def query_count_probe(
    hg: HashGraph,
    queries: torch.Tensor,
    max_probe: int = 64,
    buckets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paper-faithful query: linear scan of the query's bucket (kernel 5).

    ``max_probe`` caps the scanned bucket length; longer buckets under-count,
    as in the reference.  ``buckets`` default to ``hash(q) % table_size``.
    As in :func:`query_locate`, a query routed to the trash bucket gets an
    empty window (the reference scans it and its callers mask the count).
    """
    queries, stacked = _stacked(hg, queries)
    if buckets is None:
        buckets = hg.bucket_of(queries)
    elif not stacked:
        buckets = buckets.unsqueeze(0)
    starts, ends = bucket_windows(hg.offsets, hg.table_size, buckets)
    from repro_torch.kernels import ops

    return _unstack(ops.bucket_probe(hg.keys, starts, ends, queries, max_probe=max_probe), stacked)


# ---------------------------------------------------------------------------
# The single-card API (the reference's Alg. 1 table): one-shard graphs from
# :func:`build`, unstacked ``(N,)`` / ``(N, L)`` queries.
# ---------------------------------------------------------------------------


def _one_shard(hg: HashGraph, what: str) -> None:
    if hg.keys.shape[0] != 1:
        raise ValueError(f"{what} takes a one-shard graph, got {hg.keys.shape[0]} shards")


def retrieve(
    hg: HashGraph,
    queries: torch.Tensor,
    *,
    capacity: int,
    buckets: Optional[torch.Tensor] = None,
    fill: int = -1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Values under every occurrence of every query key, CSR-shaped:
    ``(offsets, values, num_dropped)``, query ``i``'s values at
    ``values[offsets[i]:offsets[i+1]]`` in the table's bucket order.

    ``capacity`` is the static output size; overflow is reported in
    ``num_dropped``.  The gather is kernel 3 on the card
    (``ops.csr_gather``; its plain twin on the CPU).
    """
    from repro_torch.kernels import ops

    _one_shard(hg, "retrieve")
    starts, counts = query_locate(hg, queries, buckets)
    offsets, _, values, num_dropped = ops.csr_gather(
        starts, counts, hg.values[0], capacity=capacity, fill=fill
    )
    return offsets, values, num_dropped


def inner_join(
    hg: HashGraph,
    queries: torch.Tensor,
    *,
    capacity: int,
    buckets: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every ``(query_idx, build_value)`` match pair: ``(query_idx, values,
    num_results, num_dropped)``, the arrays ``(capacity,)`` with -1 / fill
    beyond ``num_results`` (kernel 3 on the card)."""
    from repro_torch.kernels import ops

    _one_shard(hg, "inner_join")
    starts, counts = query_locate(hg, queries, buckets)
    _, query_idx, values, num_dropped = ops.csr_gather(
        starts, counts, hg.values[0], capacity=capacity
    )
    num_results = torch.clamp(counts.sum(), max=capacity).to(torch.int32)
    return query_idx, values, num_results, num_dropped


def lookup_first(
    hg: HashGraph, queries: torch.Tensor, buckets: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Value row of the first matching key per query, -1 (every column) on
    a miss: ``(Nq,)`` or ``(Nq, C)`` int32."""
    queries, stacked = _stacked(hg, queries)
    if buckets is not None and not stacked:
        buckets = buckets.unsqueeze(0)
    # A key's run starts at its left bisection point; it matched iff the run
    # is not empty (the reference's ``keys[left] == q``).
    starts, counts = query_locate(hg, queries, buckets)
    vals = take_rows(hg.values, torch.clamp(starts, 0, max(hg.capacity - 1, 0)).to(torch.int64))
    found = counts > 0 if hg.values.ndim == 2 else (counts > 0).unsqueeze(-1)
    return _unstack(torch.where(found, vals, -1), stacked)


def contains(hg: HashGraph, queries: torch.Tensor) -> torch.Tensor:
    """Membership of each query key."""
    return query_count_sorted(hg, queries) > 0


def intersect_join_size(hg_build: HashGraph, hg_query: HashGraph) -> torch.Tensor:
    """Inner-join cardinality of two one-shard graphs (the paper's query
    phase, §3.3): each valid key of ``hg_query`` counted in ``hg_build``
    (trash-bucket rows contribute 0).  An int64 scalar tensor."""
    _one_shard(hg_query, "intersect_join_size")
    keys = hg_query.keys[0]
    valid = torch.arange(keys.shape[0], device=keys.device) < hg_query.num_valid
    counts = query_count_sorted(hg_build, keys)
    return torch.where(valid, counts, 0).to(torch.int64).sum()


# ---------------------------------------------------------------------------
# Tombstone lookup.  A buffer's unused slots hold EMPTY (the largest key in
# unsigned order) with epoch -1, so they sort last and match no layer.
# ---------------------------------------------------------------------------


def _ts_lanes(ts_keys: torch.Tensor) -> int:
    return 1 if ts_keys.ndim == 1 else int(ts_keys.shape[-1])


def match_epochs(
    keys: torch.Tensor, ts_keys: torch.Tensor, ts_epochs: torch.Tensor
) -> torch.Tensor:
    """Newest tombstone epoch matching each key; -1 where none match.

    ``ts_keys`` is ``(T,)`` or ``(T, L)`` and sets the lane count; ``keys``
    are ``(...)`` or ``(..., L)``.  Broadcast compare, ``O(M * T)``: the
    oracle of :func:`match_epochs_sorted`.
    """
    lanes = _ts_lanes(ts_keys)
    kw = key_words(keys, lanes)
    if ts_keys.shape[0] == 0:
        return torch.full(kw.shape, -1, dtype=torch.int32, device=keys.device)
    eq = kw.unsqueeze(-1) == key_words(ts_keys, lanes)
    stamped = torch.where(eq, ts_epochs.to(torch.int32), -1)
    return stamped.max(dim=-1).values.to(torch.int32)


def sort_tombstones(
    ts_keys: torch.Tensor, ts_epochs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort a tombstone buffer by (key in packed order, epoch).

    The last entry of a key's run carries its newest epoch.  1 lane: one
    sort of the int64 ``(unsigned key << 32) + (epoch + 2^31)``; 2 lanes: a
    sort by epoch, then a stable sort by the key's order view.  Equal pairs
    are equal elements, so the order among them does not matter.
    """
    if ts_keys.shape[0] == 0:
        return ts_keys, ts_epochs
    lanes = _ts_lanes(ts_keys)
    if lanes == 1:
        epochs = ts_epochs.to(torch.int64) - _SIGN
        sort_key = (key_order(ts_keys, 1).to(torch.int64) << 32) | epochs
        _, idx = torch.sort(sort_key)
    else:
        _, by_epoch = torch.sort(ts_epochs, stable=True)
        _, idx = torch.sort(key_order(ts_keys, lanes)[by_epoch], stable=True)
        idx = by_epoch[idx]
    return ts_keys[idx], ts_epochs[idx].to(torch.int32)


def match_epochs_sorted(
    keys: torch.Tensor, ts_keys: torch.Tensor, ts_epochs: torch.Tensor
) -> torch.Tensor:
    """Newest tombstone epoch matching each key (-1: none), by bisection of
    the :func:`sort_tombstones` index; ``keys`` of any shape (with the
    trailing lane dim for 2-lane keys)."""
    lanes = _ts_lanes(ts_keys)
    kw = key_words(keys, lanes)
    t = ts_keys.shape[0]
    if t == 0:
        return torch.full(kw.shape, -1, dtype=torch.int32, device=keys.device)
    sign = _SIGN if lanes == 1 else _SIGN64
    q = (kw ^ sign).reshape(-1)
    ts_w = key_words(ts_keys, lanes)
    right = torch.searchsorted(ts_w ^ sign, q, right=True)
    idx = torch.clamp(right - 1, 0, t - 1)
    hit = (right > 0) & (ts_w[idx] == kw.reshape(-1))
    out = torch.where(hit, ts_epochs[idx].to(torch.int32), -1)
    return out.reshape(kw.shape)


def csr_gather(
    starts: torch.Tensor,
    counts: torch.Tensor,
    table: torch.Tensor,
    capacity: int,
    *,
    fill: int = -1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain CSR compaction of match runs, batched over leading dims.

    Row ``i`` of each batch entry owns ``table[starts[i] : starts[i]+counts[i]]``;
    the runs are concatenated into a ``capacity``-slot buffer.  ``starts`` and
    ``counts`` are ``(..., N)`` sharing one ``(M,)`` or ``(M, C)`` ``table``
    (a row's C columns move together).  Returns ``(offsets, row_idx,
    gathered, num_dropped)``: offsets ``(..., N+1)`` clamped to
    ``capacity``, ``(..., capacity)`` row ids (-1 unused), values ``(...,
    capacity[, C])`` (``fill`` unused), and the per-entry overflow ``(...)``.

    This is the plain twin of the CSR gather kernels
    (``repro_torch.kernels.csr_gather``); ``repro_torch.kernels.ops.csr_gather``
    is the entry point the table's path calls.
    """
    counts = counts.to(torch.int32)
    n_rows = counts.shape[-1]
    lead = counts.shape[:-1]
    dev = counts.device
    zero = torch.zeros(lead + (1,), dtype=torch.int32, device=dev)
    offsets = torch.cat([zero, torch.cumsum(counts, -1, dtype=torch.int32)], -1)
    total = offsets[..., -1:]
    slot = torch.arange(capacity, dtype=torch.int32, device=dev).expand(lead + (capacity,))
    row = torch.searchsorted(offsets, slot.contiguous(), right=True) - 1
    row = torch.clamp(row, 0, max(n_rows - 1, 0))
    valid = slot < total
    if n_rows == 0 or table.numel() == 0:
        gathered = torch.full(slot.shape + table.shape[1:], fill, dtype=table.dtype, device=dev)
        row_idx = torch.full(slot.shape, -1, dtype=torch.int32, device=dev)
    else:
        src = torch.gather(starts.to(torch.int64), -1, row) + (
            slot - torch.gather(offsets, -1, row)
        )
        src = torch.clamp(src, 0, table.shape[0] - 1)
        gathered = torch.where(valid if table.ndim == 1 else valid.unsqueeze(-1), table[src], fill)
        row_idx = torch.where(valid, row.to(torch.int32), -1)
    num_dropped = torch.clamp(total[..., 0] - capacity, min=0).to(torch.int32)
    return torch.clamp(offsets, max=capacity), row_idx, gathered, num_dropped
