"""CSR HashGraph on stacked shards (port of ``repro.core.hashgraph``).

Each shard's table is the CSR of (bucket × key): bucket ``v`` of shard ``s``
holds ``keys[s, offsets[s, v] : offsets[s, v+1]]``; bucket ``V`` is the trash
bucket for padding.  All arrays carry a leading shard axis ``D``.

The reference's ``jax.lax.sort`` over (bucket, key) with values riding along
becomes one stable ``torch.sort`` of the int64 key ``(bucket << 32) | key``
per shard row (bucket ids are ``<= local_cap < 2^31``, so the key fits), and
the values are gathered with the returned indices.  Keys are int32 tensors
holding uint32 bit patterns; comparisons flip the sign bit, which orders the
patterns as unsigned integers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import hashing

# Sentinel key marking capacity padding: 0xFFFFFFFF as an int32 bit pattern.
EMPTY_KEY = 0xFFFFFFFF
EMPTY_BITS = -1
_SIGN = -(2**31)


def is_empty_key(keys: torch.Tensor) -> torch.Tensor:
    """Padding-sentinel mask."""
    return keys == EMPTY_BITS


def _unsigned_order(keys: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns mapped so that signed order is uint32 order."""
    return keys ^ _SIGN


@dataclasses.dataclass(frozen=True)
class HashGraph:
    """Stacked CSR hash tables, one per shard: ``offsets`` ``(D, V+2)``."""

    offsets: torch.Tensor  # (D, V+2) int32, monotone per row
    keys: torch.Tensor  # (D, M) int32 (uint32 bits), grouped by bucket
    values: torch.Tensor  # (D, M) int32 payload
    table_size: int  # V
    seed: int


def build_from_buckets(
    keys: torch.Tensor,
    buckets: torch.Tensor,
    table_size: int,
    values: torch.Tensor,
    *,
    seed: int = hashing.DEFAULT_SEED,
) -> HashGraph:
    """Build one CSR per shard row from precomputed bucket ids.

    ``buckets`` may hold ``table_size`` to send padding to the trash bucket.
    Rows sort by (bucket, key as uint32), stably, so equal keys keep their
    input order, as the reference's stable ``lax.sort`` does.
    """
    d = keys.shape[0]
    sort_key = (buckets.to(torch.int64) << 32) | (keys.to(torch.int64) & 0xFFFFFFFF)
    sort_key, idx = torch.sort(sort_key, dim=1, stable=True)
    sorted_keys = torch.gather(keys, 1, idx)
    sorted_values = torch.gather(values, 1, idx)
    del idx
    sorted_buckets = sort_key >> 32
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
    )


def _segment_searchsorted(
    sorted_keys: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    q: torch.Tensor,
    side: str,
) -> torch.Tensor:
    """Per-row binary search of ``q[s, i]`` within ``sorted_keys[s, lo:hi]``.

    ``sorted_keys`` and ``q`` are in unsigned order (:func:`_unsigned_order`).
    The reference runs a fixed ``bit_length(M)`` trips; lanes with
    ``lo == hi`` never move, so stopping once every lane has converged gives
    the same result (buckets hold a few keys, so a handful of trips do).
    """
    m = sorted_keys.shape[1]
    iters = max(1, int(m).bit_length())
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    for _ in range(iters):
        active = lo < hi
        if not bool(active.any()):
            break
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
    hg: HashGraph, queries: torch.Tensor, buckets: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each routed query's match run per shard: ``(starts, counts)`` int32.

    All occurrences of a key are contiguous in a bucket-sorted shard, so the
    matches of ``queries[s, i]`` are ``keys[s, starts : starts + counts]``.
    ``buckets`` are the local bucket ids the caller routed the queries to.

    A query routed to the trash bucket ``V`` is exchange padding: its window
    is empty, so it counts 0 without a search.  (The reference bisects the
    trash bucket, which holds every padding row of the build, and its
    callers then mask those counts to 0; the masked results are the same.)
    """
    starts, ends = bucket_windows(hg.offsets, hg.table_size, buckets)
    keys_u = _unsigned_order(hg.keys)
    q_u = _unsigned_order(queries)
    left = _segment_searchsorted(keys_u, starts, ends, q_u, side="left")
    right = _segment_searchsorted(keys_u, starts, ends, q_u, side="right")
    return left.to(torch.int32), (right - left).to(torch.int32)


def query_count_sorted(
    hg: HashGraph, queries: torch.Tensor, buckets: torch.Tensor
) -> torch.Tensor:
    """Exact multiplicity of each routed query key by per-bucket bisection."""
    return query_locate(hg, queries, buckets)[1]


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
    if buckets is None:
        buckets = hashing.hash_to_buckets(queries, hg.table_size, seed=hg.seed)
    starts, ends = bucket_windows(hg.offsets, hg.table_size, buckets)
    from repro_torch.kernels import ops

    return ops.bucket_probe(hg.keys, starts, ends, queries, max_probe=max_probe)


# ---------------------------------------------------------------------------
# Tombstone lookup.  A buffer's unused slots hold EMPTY (the largest key in
# unsigned order) with epoch -1, so they sort last and match no layer.
# ---------------------------------------------------------------------------


def match_epochs(
    keys: torch.Tensor, ts_keys: torch.Tensor, ts_epochs: torch.Tensor
) -> torch.Tensor:
    """Newest tombstone epoch matching each key; -1 where none match.

    Broadcast compare, ``O(M * T)``: the oracle of :func:`match_epochs_sorted`.
    """
    if ts_keys.shape[0] == 0:
        return torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    eq = keys.unsqueeze(-1) == ts_keys
    stamped = torch.where(eq, ts_epochs.to(torch.int32), -1)
    return stamped.max(dim=-1).values.to(torch.int32)


def sort_tombstones(
    ts_keys: torch.Tensor, ts_epochs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort a tombstone buffer by (key as uint32, epoch).

    The last entry of a key's run carries its newest epoch.  One sort of the
    int64 ``(unsigned key << 32) + (epoch + 2^31)``: equal pairs are equal
    elements, so stability does not matter.
    """
    if ts_keys.shape[0] == 0:
        return ts_keys, ts_epochs
    epochs = ts_epochs.to(torch.int64) - _SIGN
    sort_key = (_unsigned_order(ts_keys).to(torch.int64) << 32) | epochs
    sort_key, idx = torch.sort(sort_key)
    return ts_keys[idx], ts_epochs[idx].to(torch.int32)


def match_epochs_sorted(
    keys: torch.Tensor, ts_keys: torch.Tensor, ts_epochs: torch.Tensor
) -> torch.Tensor:
    """Newest tombstone epoch matching each key (-1: none), by bisection of
    the :func:`sort_tombstones` index; ``keys`` of any shape."""
    t = ts_keys.shape[0]
    if t == 0:
        return torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    q = _unsigned_order(keys).reshape(-1)
    right = torch.searchsorted(_unsigned_order(ts_keys), q, right=True)
    idx = torch.clamp(right - 1, 0, t - 1)
    hit = (right > 0) & (ts_keys[idx] == keys.reshape(-1))
    out = torch.where(hit, ts_epochs[idx].to(torch.int32), -1)
    return out.reshape(keys.shape)


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
    ``counts`` are ``(..., N)`` sharing one 1-D ``table``.  Returns
    ``(offsets, row_idx, gathered, num_dropped)``: offsets ``(..., N+1)``
    clamped to ``capacity``, ``(..., capacity)`` row ids (-1 unused) and
    values (``fill`` unused), and the per-entry overflow ``(...)``.

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
        gathered = torch.full(slot.shape, fill, dtype=table.dtype, device=dev)
        row_idx = torch.full(slot.shape, -1, dtype=torch.int32, device=dev)
    else:
        src = torch.gather(starts.to(torch.int64), -1, row) + (
            slot - torch.gather(offsets, -1, row)
        )
        src = torch.clamp(src, 0, table.shape[0] - 1)
        gathered = torch.where(valid, table[src], fill)
        row_idx = torch.where(valid, row.to(torch.int32), -1)
    num_dropped = torch.clamp(total[..., 0] - capacity, min=0).to(torch.int32)
    return torch.clamp(offsets, max=capacity), row_idx, gathered, num_dropped
