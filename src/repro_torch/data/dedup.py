"""Exact sequence dedup through the paper's hash table (port of
``repro.data.dedup``).

Every training row is fingerprinted with the streaming murmur3 and the
fingerprints go into a HashGraph:

* one card: :func:`dedup_mask` builds the single-card table
  (``hashgraph.build``) and keeps a row iff the smallest row id among equal
  fingerprints is its own;
* distributed: :func:`dedup_mask_distributed` builds a
  ``DistributedHashTable`` over the fingerprints (Alg. 2), counts them and
  reads the smallest row id owner-side in one more routed round; over a
  process group each rank passes its block of rows and gets its block of
  the mask.

32-bit fingerprints collide at about N²/2³³ pairs; both masks, and the
reference's, dedup by fingerprint.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import exchange, hashgraph, hashing, multi_hashgraph, partition
from repro_torch.core.hashgraph import EMPTY_BITS, HashGraph

# Rows of a key's run scanned for its smallest value (the reference's static
# window: a run in a dedup table is one row's duplicates in a batch).
MAX_RUN = 64
INT32_MAX = 2**31 - 1


def sequence_fingerprints(tokens: torch.Tensor, seed: int = hashing.DEFAULT_SEED) -> torch.Tensor:
    """murmur3 stream hash of each row: ``(B, S)`` int32 tokens → ``(B,)``
    int32 (the uint32 fingerprint's bits), on the tokens' device."""
    h = hashing.murmur3_stream(tokens, seed)
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def dedup_mask(tokens: torch.Tensor, seed: int = hashing.DEFAULT_SEED) -> torch.Tensor:
    """``(B,)`` bool, True for the rows to keep (each content's first row),
    through the single-card HashGraph with row ids as values."""
    fp = sequence_fingerprints(tokens, seed=seed)
    n = fp.shape[0]
    hg = hashgraph.build(fp, table_size=max(8, n), seed=seed)
    first = _min_value_per_key(hg, fp)
    return first == torch.arange(n, dtype=torch.int32, device=fp.device)


def _narrow_by_fingerprint(hg: HashGraph, starts, ends, q):
    """Confine bucket windows to each query's fingerprint run (a graph with
    the fingerprint lane orders a bucket by (fingerprint, key)); a no-op
    without the lane (dedup's 1-lane fingerprint keys carry none)."""
    if hg.fingerprints is None:
        return starts, ends
    sign = -(2**31)
    fp_u = hg.fingerprints ^ sign
    qfp_u = hashing.fingerprint32(q, hg.key_lanes) ^ sign
    fl = hashgraph._segment_searchsorted(fp_u, starts, ends, qfp_u, side="left")
    fr = hashgraph._segment_searchsorted(fp_u, fl, ends, qfp_u, side="right")
    return fl, fr


def _min_in_runs(hg: HashGraph, q: torch.Tensor, starts, ends) -> torch.Tensor:
    """Smallest value among the rows equal to each ``(D, R)`` query inside
    its ``[starts, ends)`` window; INT32_MAX where none.  The run's first
    ``MAX_RUN`` rows are scanned (values are not sorted within a run)."""
    starts, ends = _narrow_by_fingerprint(hg, starts, ends, q)
    lanes = hg.key_lanes
    keys_u = hashgraph.key_order(hg.keys, lanes)
    q_u = hashgraph.key_order(q, lanes)
    trips = hashgraph._window_trips(starts, ends)
    left = hashgraph._segment_searchsorted(keys_u, starts, ends, q_u, side="left", trips=trips)
    right = hashgraph._segment_searchsorted(keys_u, starts, ends, q_u, side="right", trips=trips)
    del keys_u, q_u
    d, r = left.shape
    m = hg.keys.shape[1]
    max_run = min(MAX_RUN, m)
    idx = left.unsqueeze(-1) + torch.arange(max_run, device=left.device)
    in_run = idx < right.unsqueeze(-1)
    vals = torch.gather(hg.values, 1, torch.clamp(idx, 0, m - 1).reshape(d, -1))
    vals = torch.where(in_run, vals.reshape(d, r, max_run), INT32_MAX)
    return vals.min(dim=-1).values


def _min_value_per_key(hg: HashGraph, queries: torch.Tensor) -> torch.Tensor:
    """Smallest stored value among the table keys equal to each query, in
    a one-shard graph's own buckets."""
    q, stacked = hashgraph._stacked(hg, queries)
    b = hg.bucket_of(q).to(torch.int64)
    starts = torch.gather(hg.offsets, 1, b)
    ends = torch.gather(hg.offsets, 1, b + 1)
    return hashgraph._unstack(_min_in_runs(hg, q, starts, ends), stacked)


def dedup_mask_distributed(table, tokens: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
    """Exact dedup of a ``(B, S)`` token batch through ``table`` (a
    ``DistributedHashTable``; ``B`` divisible by its shard count, or over a
    process group this rank's block of ``B / D`` rows).

    Builds the distributed graph of the row fingerprints with global row
    ids as values, counts each fingerprint and reads its smallest row id
    owner-side.  Returns the ``(B,)`` keep-mask (a rank's block) on the
    table's device: a row is kept when its content occurs once or it is
    the first.
    """
    fp = sequence_fingerprints(tokens, seed=seed or table.seed).to(table.device)
    n = fp.shape[0]
    first = table.group.rank * n
    rows = torch.arange(first, first + n, dtype=torch.int32, device=table.device)
    state = table.build(fp, values=rows)
    counts = table.query(state, fp)
    firsts = _min_value_sharded(state, table._pack_queries(fp)).reshape(-1)
    return (counts <= 1) | (firsts == rows)


def _min_value_sharded(dhg, queries: torch.Tensor) -> torch.Tensor:
    """Route ``(local, n_local)`` queries to their owners by the build
    splits, take the smallest matching value owner-side, route it back (one
    dispatch and one combine over the graph's group; INT32_MAX where nothing
    matched or a query overflowed the reference's 1.25 slack)."""
    group = dhg.group
    d, n_local = group.size, queries.shape[1]
    h = hashing.hash_to_buckets(queries, dhg.hash_range, dhg.seed)
    dest = partition.destination_of(h, dhg.hash_splits)
    del h
    capacity = multi_hashgraph.default_capacity(n_local, d, 1.25)
    (rq,), route = exchange.dispatch((queries,), dest, capacity, fills=(EMPTY_BITS,),
                                     group=group)
    rbuckets, _ = multi_hashgraph._local_buckets(
        rq, multi_hashgraph._shard_lo(dhg.hash_splits, group), dhg.hash_range,
        dhg.local_range_cap, dhg.seed,
    )
    hg = dhg.local
    b = rbuckets.to(torch.int64)
    # As in the reference, padding slots read the trash bucket's window;
    # their answers never go home.
    starts = torch.gather(hg.offsets, 1, b)
    ends = torch.gather(hg.offsets, 1, b + 1)
    ans = _min_in_runs(hg, rq, starts, ends)
    return exchange.combine(ans, route, fill=INT32_MAX)
