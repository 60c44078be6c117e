"""Kernel 5 wrappers: the paper's linear bucket probe (``csrc/bucket_probe.cu``).

Replaces the Pallas ``bucket_probe_2d`` (``repro/kernels/bucket_probe.py``):
for each query slot, the number of ``j < max_probe`` with
``starts + j < ends`` and ``table[starts + j] == q``.  Two entries launch
the same device routine:

- :func:`bucket_probe` keeps the Pallas function's interface (windows
  given as ``starts`` and ``ends``);
- :func:`bucket_probe_layer`, the table's query path, probes one layer of a
  versioned stack for a routed batch: it finds each slot's window from its
  hash, masks padding and tombstoned keys and adds the count into a running
  total in place, in one launch.

Keys have 1 lane (int32 bits) or 2 (``(..., 2)`` int32 lanes of a uint64
key, compared as one 8-byte word); ``max_probe`` counts rows either way.

Both take ``block_rows`` (None: ``common.resolve_block_rows("bucket_probe",
...)``, ``n`` the slots, ``width`` the lanes): a CTA's tile, 4 or 8 rows of
128 slots.  On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs its plain twin (:func:`bucket_probe_plain`,
:func:`bucket_probe_layer_plain`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import hashgraph
from repro_torch.core.hashgraph import key_words
from repro_torch.kernels import build, common

NAME = "bucket_probe"
LAYER_NAME = "bucket_probe_layer"


def _lanes(q: torch.Tensor, slots: torch.Tensor) -> int:
    """Lanes of keys ``q`` laid out over the ``slots`` shape."""
    return 1 if q.ndim == slots.ndim else int(q.shape[-1])


def bucket_probe_plain(
    starts: torch.Tensor,
    ends: torch.Tensor,
    q: torch.Tensor,
    table: torch.Tensor,
    max_probe: int,
) -> torch.Tensor:
    """The kernel's plain twin: ``(..., N)`` slots over a ``(..., M)`` table
    (``(..., N, 2)`` and ``(..., M, 2)`` for 2-lane keys, every lane
    compared).

    Walks the windows one probe step at a time (the reference materialises
    ``(N, max_probe)``, which does not fit at 2^27 slots) and stops after the
    longest window; the steps it skips match nothing.  Indices are clipped
    into the table as the reference clips them.
    """
    lanes = _lanes(q, starts)
    q, table = key_words(q, lanes), key_words(table, lanes)
    m = table.shape[-1]
    acc = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    if q.numel() == 0 or m == 0:
        return acc
    lo = starts.to(torch.int64)
    hi = ends.to(torch.int64)
    trips = min(int(max_probe), int((hi - lo).max()))
    for j in range(max(trips, 0)):
        idx = lo + j
        vals = torch.gather(table, -1, torch.clamp(idx, 0, m - 1))
        acc += ((idx < hi) & (vals == q)).to(torch.int32)
    return acc


def _check(starts, ends, q, table) -> int:
    for label, t in (("starts", starts), ("ends", ends), ("q", q), ("table", table)):
        if t.dtype != torch.int32:
            raise TypeError(f"{NAME}: {label} must be int32, got {t.dtype}")
    lanes = _lanes(q, starts)
    if starts.shape != ends.shape or starts.ndim not in (1, 2) or lanes not in (1, 2) or (
        q.shape[: starts.ndim] != starts.shape
    ):
        raise ValueError(
            f"{NAME}: starts {tuple(starts.shape)}, ends {tuple(ends.shape)} and q "
            f"{tuple(q.shape)} must share one (N,) or (S, N) shape (q with 2 lanes: (..., 2))"
        )
    if table.ndim != q.ndim or table.shape[: starts.ndim - 1] != starts.shape[:-1] or (
        lanes == 2 and table.shape[-1] != 2
    ):
        raise ValueError(
            f"{NAME}: table {tuple(table.shape)} does not match q {tuple(q.shape)}"
        )
    return lanes


def bucket_probe(
    starts: torch.Tensor,
    ends: torch.Tensor,
    q: torch.Tensor,
    table: torch.Tensor,
    max_probe: int = 64,
    *,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """int32 match counts of ``q`` in its window ``table[starts:ends]``,
    capped at ``max_probe`` rows; ``(S, N)`` slots take a ``(S, M)`` table
    (one launch for S shards), ``(N,)`` slots a ``(M,)`` table; 2-lane keys
    add a trailing dim of 2 to ``q`` and ``table``."""
    lanes = _check(starts, ends, q, table)
    if not 0 <= max_probe < 2**31:
        raise ValueError(f"{NAME}: max_probe must be in [0, 2^31), got {max_probe}")
    if not build.on_card(NAME, q):
        return bucket_probe_plain(starts, ends, q, table, max_probe)
    starts, ends = starts.contiguous(), ends.contiguous()
    q, table = key_words(q, lanes).contiguous(), key_words(table, lanes).contiguous()
    out = torch.empty(q.shape, dtype=torch.int32, device=q.device)
    num_shards = 1 if q.ndim == 1 else q.shape[0]
    n, table_len = q.shape[-1], table.shape[-1]
    if out.numel() == 0:
        return out
    if table_len == 0:  # no window can hold a word
        return out.zero_()
    build.require_cuda(NAME, starts, ends, q, table, out)
    threads = common.launch_threads(NAME, block_rows, n=out.numel(), width=lanes)
    build.launch(
        NAME, starts.data_ptr(), ends.data_ptr(), q.data_ptr(), table.data_ptr(),
        n, table_len, num_shards, int(max_probe), lanes, threads, out.data_ptr(),
        build.stream_of(q),
    )
    return out


def bucket_probe_layer_plain(
    rq: torch.Tensor,
    rh: torch.Tensor,
    lo: torch.Tensor,
    match_e: Optional[torch.Tensor],
    offsets: torch.Tensor,
    keys: torch.Tensor,
    *,
    table_size: int,
    stride: int,
    epoch: int,
    max_probe: int,
    total: torch.Tensor,
    accumulate: bool,
) -> torch.Tensor:
    """The layer kernel's plain twin, composed of the table's plain steps:
    rebase the hashes to local buckets, look up the bucket windows, probe
    them (:func:`bucket_probe_plain`), mask padding and tombstoned keys, and
    write or add the counts into ``total``."""
    from repro_torch.core import multi_hashgraph as mh

    buckets = mh._rebase_buckets(
        rh, hashgraph.is_empty_key(rq, hashgraph.shard_lanes(rq)), lo.reshape(-1, 1),
        table_size, stride,
    )
    starts, ends = hashgraph.bucket_windows(offsets, table_size, buckets)
    counts = bucket_probe_plain(
        starts.to(torch.int32), ends.to(torch.int32), rq, keys, max_probe
    )
    counts = mh._mask_counts(counts, rq, layer_epoch=epoch, match_e=match_e)
    return total.add_(counts) if accumulate else total.copy_(counts)


def _check_layer(rq, rh, lo, match_e, offsets, keys, total, table_size, stride, max_probe):
    named = (("rq", rq), ("rh", rh), ("lo", lo), ("offsets", offsets), ("keys", keys),
             ("total", total), ("match_e", match_e))
    for label, t in named:
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"{LAYER_NAME}: {label} must be int32, got {t.dtype}")
    if rq.ndim not in (2, 3) or (rq.ndim == 3 and rq.shape[-1] != 2):
        raise ValueError(f"{LAYER_NAME}: rq must be (S, N) or (S, N, 2), got {tuple(rq.shape)}")
    d = rq.shape[0]
    for label, t in (("rh", rh), ("total", total), ("match_e", match_e)):
        if t is not None and t.shape != rq.shape[:2]:
            raise ValueError(
                f"{LAYER_NAME}: {label} {tuple(t.shape)} does not match rq {tuple(rq.shape)}"
            )
    if lo.numel() != d:
        raise ValueError(f"{LAYER_NAME}: lo holds {lo.numel()} split bases for {d} shards")
    if table_size < 1 or offsets.shape != (d, table_size + 2):
        raise ValueError(
            f"{LAYER_NAME}: offsets {tuple(offsets.shape)} is not ({d}, table_size + 2) "
            f"for table_size {table_size}"
        )
    if keys.ndim != rq.ndim or keys.shape[0] != d or keys.shape[2:] != rq.shape[2:]:
        raise ValueError(f"{LAYER_NAME}: keys {tuple(keys.shape)} is not ({d}, M) with rq's lanes")
    if stride < 1:
        raise ValueError(f"{LAYER_NAME}: stride must be >= 1, got {stride}")
    if not 0 <= max_probe < 2**31:
        raise ValueError(f"{LAYER_NAME}: max_probe must be in [0, 2^31), got {max_probe}")


def bucket_probe_layer(
    rq: torch.Tensor,
    rh: torch.Tensor,
    lo: torch.Tensor,
    match_e: Optional[torch.Tensor],
    offsets: torch.Tensor,
    keys: torch.Tensor,
    *,
    table_size: int,
    stride: int,
    epoch: int,
    max_probe: int,
    total: torch.Tensor,
    accumulate: bool,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """One layer's masked probe counts of a routed batch, into ``total``.

    ``rq`` ``(S, N)`` routed keys (EMPTY pads; ``(S, N, 2)`` for 2-lane
    keys), ``rh`` their hashes, ``lo`` the S shards' split bases,
    ``match_e`` ``(S, N)`` each key's newest tombstone epoch or None,
    ``offsets`` ``(S, V + 2)`` and ``keys`` ``(S, M[, 2])`` the layer's CSR
    (``V = table_size``) with bucket ``stride``.
    A slot counts its key's matches among the first ``max_probe`` rows of
    bucket ``clamp((rh - lo) // stride, 0, V - 1)``, and 0 where it is
    padding or ``match_e >= epoch``.  ``total`` ``(S, N)`` is overwritten
    (``accumulate=False``) or added to, in place, and returned.
    """
    _check_layer(rq, rh, lo, match_e, offsets, keys, total, table_size, stride, max_probe)
    kw = dict(table_size=table_size, stride=stride, epoch=epoch, max_probe=max_probe,
              total=total, accumulate=accumulate)
    if not build.on_card(LAYER_NAME, rq):
        return bucket_probe_layer_plain(rq, rh, lo, match_e, offsets, keys, **kw)
    d, n = rq.shape[:2]
    lanes = hashgraph.shard_lanes(rq)
    if d > 65535:
        raise ValueError(f"{LAYER_NAME}: at most 65535 shards a launch, got {d}")
    operands = [t.contiguous() for t in (key_words(rq, lanes), rh, lo, offsets,
                                         key_words(keys, lanes))]
    if match_e is not None:
        operands.append(match_e.contiguous())
    build.require_cuda(LAYER_NAME, *operands, total)  # total is written in place
    if n == 0:
        return total
    rq, rh, lo, offsets, keys = operands[:5]
    threads = common.launch_threads(NAME, block_rows, n=d * n, width=lanes)
    build.launch(
        LAYER_NAME, rq.data_ptr(), rh.data_ptr(), lo.data_ptr(),
        None if match_e is None else operands[5].data_ptr(), offsets.data_ptr(),
        keys.data_ptr(), n, keys.shape[1], d, int(table_size), int(stride), int(epoch),
        int(max_probe), int(bool(accumulate)), lanes, threads, total.data_ptr(),
        build.stream_of(rq),
    )
    return total
