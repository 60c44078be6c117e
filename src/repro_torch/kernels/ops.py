"""Entry points around the CSR gather, bucket probe and flash attention
kernels (port of ``repro.kernels.ops``).

``csr_gather``, ``csr_gather_batched`` and ``csr_gather_layers`` keep the
reference's contracts: the prefix sum runs as plain tensor code, the gather
in kernel 3 or 4's Pallas-interface entries on the card (their plain twin on
the CPU); a ``(Tn, C)`` table gives ``(capacity, C)`` values from one row
search per slot, its columns read together.  The table's retrieve calls ``csr_gather_owners`` and
``csr_gather_queriers``, one launch per side for every shard and layer.  A
uint32 table (the ``torch.uint32`` dtype) goes through its int32 view, so
``fill=-1`` comes back as ``0xFFFFFFFF``.  ``bucket_probe`` keeps
the reference's argument order and runs kernel 5's window entry (the
table's query path calls kernel 5's layer entry,
``kernels.bucket_probe.bucket_probe_layer``, directly).  ``flash_attention``
takes ``(B, H, S, D)`` views and runs kernel 6 on them through their
strides (the reference flattens batch into heads).  ``slstm_recurrence``
runs kernel 7 on f32 inputs of any length (the reference's ``t_block``
padding has no counterpart).  ``hash_to_buckets`` and ``bin_histogram`` run
kernels 1 and 2 on flat arrays (the reference's lane padding has no
counterpart).

Every wrapper of kernels 1-5 takes ``block_rows=None`` where the
reference's does: left None it resolves through
:func:`repro_torch.kernels.common.resolve_block_rows` (the autotuned winner
of :mod:`repro_torch.kernels.autotune` for the call's kernel, width and size
bucket, else ``common.DEFAULT_BLOCK_ROWS``) at each launch, so a cache
loaded later takes effect on the next call; on the CPU the plain twins
ignore it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import hashing
from repro_torch.kernels import bucket_probe as _probe
from repro_torch.kernels import csr_gather as _gather
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import histogram as _hist
from repro_torch.kernels import murmur as _murmur
from repro_torch.kernels import slstm as _slstm


def hash_to_buckets(
    keys: torch.Tensor,
    table_size: int,
    seed: int = hashing.DEFAULT_SEED,
    *,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """Fused murmur3 + mod of a flat ``(N,)`` key array (int32 bits or
    ``torch.uint32``) → ``(N,)`` int32: kernel 1."""
    if keys.dtype == torch.uint32:
        keys = keys.view(torch.int32)
    return _murmur.murmur_bucket(keys, table_size, seed, block_rows=block_rows)


def bin_histogram(
    bins: torch.Tensor,
    num_bins: int,
    *,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """Histogram of ``(N,)`` int32 bin ids → ``(num_bins,)`` int32: kernel 2."""
    return _hist.bin_histogram(bins.to(torch.int32), num_bins, block_rows=block_rows)


def _as_int32_table(table: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if table.dtype == torch.uint32:
        return table.view(torch.int32), True
    if table.dtype != torch.int32:
        raise ValueError(f"csr_gather kernel supports int32/uint32 tables, got {table.dtype}")
    return table, False


def run_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums ``(..., N+1)`` int32 of ``(..., N)`` run lengths."""
    counts = counts.to(torch.int32)
    zero = torch.zeros(counts.shape[:-1] + (1,), dtype=torch.int32, device=counts.device)
    return torch.cat([zero, torch.cumsum(counts, -1, dtype=torch.int32)], -1)


def csr_gather(
    starts: torch.Tensor,
    counts: torch.Tensor,
    table: torch.Tensor,
    *,
    capacity: int,
    fill: int = -1,
    block_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """CSR match-run compaction of ``(N,)`` runs into ``capacity`` slots.

    Returns ``(offsets, row_idx, gathered, num_dropped)``: ``(N+1,)`` offsets
    clamped to ``capacity``, ``(capacity,)`` row ids and values, and the ()
    overflow ``max(0, total - capacity)``.
    """
    table, unsigned = _as_int32_table(table)
    offsets = run_offsets(counts)
    vals, rows = _gather.csr_gather_2d(
        offsets, starts.to(torch.int32), table, capacity, fill, block_rows=block_rows
    )
    if unsigned:
        vals = vals.view(torch.uint32)
    num_dropped = torch.clamp(offsets[-1] - capacity, min=0)
    return torch.clamp(offsets, max=capacity), rows, vals, num_dropped


def csr_gather_batched(
    starts: torch.Tensor,
    counts: torch.Tensor,
    table: torch.Tensor,
    *,
    capacity: int,
    fill: int = -1,
    block_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """S CSR gathers over one shared table in one launch.

    ``starts``/``counts`` are ``(S, N)``.  Returns ``(offsets, row_idx,
    gathered, num_dropped)``: ``(S, N+1)`` clamped offsets, ``(S, capacity)``
    row ids and values, and the () total overflow across sources.
    """
    table, unsigned = _as_int32_table(table)
    offsets = run_offsets(counts)
    vals, rows = _gather.csr_gather_batched_2d(
        offsets, starts.to(torch.int32), table, capacity, fill, block_rows=block_rows
    )
    if unsigned:
        vals = vals.view(torch.uint32)
    num_dropped = torch.clamp(offsets[:, -1] - capacity, min=0).sum().to(torch.int32)
    return torch.clamp(offsets, max=capacity), rows, vals, num_dropped


interleave_layer_runs = _gather.interleave_layer_runs


def csr_gather_layers(
    starts: torch.Tensor,
    counts: torch.Tensor,
    tables: Sequence[torch.Tensor],
    *,
    capacity: int,
    fill: int = -1,
    block_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Owner-side gather across a layer stack: one batched launch for L·S CSRs.

    Returns ``(gathered, num_dropped)``: ``(S, capacity)`` packed segments
    and the () total overflow across sources.
    """
    starts_i, counts_i, table_cat = interleave_layer_runs(starts, counts, tables)
    _, _, gathered, num_dropped = csr_gather_batched(
        starts_i, counts_i, table_cat, capacity=capacity, fill=fill, block_rows=block_rows
    )
    return gathered, num_dropped


def csr_gather_owners(
    starts: torch.Tensor,
    counts: torch.Tensor,
    tables: Sequence[torch.Tensor],
    *,
    capacity: int,
    fill: int = -1,
    block_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Owner side of a retrieve: every owner, source and layer in one launch.

    ``starts``/``counts`` ``(L, D_o, D_s, R)`` index each layer's own table
    ``(D_o, M_l)``.  Returns ``(segments, num_dropped, slot_counts)``:
    ``(D_o, D_s, capacity)`` packed slot-major/layer-minor (the order of
    :func:`csr_gather_layers`), the () total overflow, and the int32
    ``(D_o, D_s, R)`` per-slot totals ``counts.sum(0)``.
    """
    conv = [_as_int32_table(t) for t in tables]
    seg, dropped, slot_counts = _gather.csr_gather_owners(
        starts.to(torch.int32), counts.to(torch.int32), [t for t, _ in conv], capacity, fill,
        block_rows=block_rows,
    )
    if conv and conv[0][1]:
        seg = seg.view(torch.uint32)
    return seg, dropped.sum(), slot_counts


def csr_gather_queriers(
    starts: torch.Tensor,
    counts: torch.Tensor,
    table: torch.Tensor,
    *,
    capacity: int,
    fill: int = -1,
    block_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Querier side of a retrieve: ``D`` CSR gathers, each over its own row
    of ``table`` ``(D, W)``, in one launch.  Returns ``(offsets, row_idx,
    gathered, num_dropped)`` as :func:`csr_gather` does per row, and the ()
    total overflow."""
    table, unsigned = _as_int32_table(table)
    offsets, rows, vals, dropped = _gather.csr_gather_queriers(
        starts.to(torch.int32), counts.to(torch.int32), table, capacity, fill,
        block_rows=block_rows,
    )
    if unsigned:
        vals = vals.view(torch.uint32)
    return offsets, rows, vals, dropped.sum()


def bucket_probe(
    table_keys: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    queries: torch.Tensor,
    *,
    max_probe: int = 64,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """Per-query match count by linear bucket scan (the paper's query loop).

    Keys are int32 bit patterns or ``torch.uint32``; ``starts``/``ends`` any
    integer type.  ``(N,)`` queries over a ``(M,)`` table, or ``(S, N)`` over
    ``(S, M)``; 2-lane keys add a trailing dim of 2 to both.
    """
    table_keys, _ = _as_int32_table(table_keys)
    if queries.dtype == torch.uint32:
        queries = queries.view(torch.int32)
    return _probe.bucket_probe(
        starts.to(torch.int32), ends.to(torch.int32), queries, table_keys, max_probe,
        block_rows=block_rows,
    )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention over (B, Hq, S, D) with GQA kv (B, Hkv, Skv, D).

    The views are handed to kernel 6 as they are (no copy: it reads them
    through their strides); ``out``, a (B, Hq, S, D) view of any layout the
    kernel takes, receives the result in place when given.
    """
    return _flash.flash_attention_bhsd(
        q, k, v, causal=causal, window=window, scale=scale,
        q_heads_per_kv=q.shape[1] // k.shape[1], out=out,
    )


def slstm_recurrence(
    pre: torch.Tensor,
    r: torch.Tensor,
    c0: torch.Tensor,
    n0: torch.Tensor,
    h0: torch.Tensor,
    m0: torch.Tensor,
) -> tuple[torch.Tensor, tuple]:
    """sLSTM recurrence with on-chip recurrent weights.

    pre (B,H,S,4,hd), r (H,4,hd,hd), state (B,H,hd) each, cast to f32 (a
    bf16 ``r`` is passed as it is: the kernel widens it exactly).  Returns
    (hs (B,H,S,hd), (c,n,h,m) finals).
    """
    rr = (r if r.dtype in _slstm.R_DTYPES else r.float()).contiguous()
    pre = pre.float()
    if pre.stride(-1) != 1:
        pre = pre.contiguous()
    return _slstm.slstm_sequence(
        pre, rr, *(t.float().contiguous() for t in (c0, n0, h0, m0))
    )
