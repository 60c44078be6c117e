"""Kernels 3 and 4 wrappers: CSR gather (``csrc/csr_gather.cu``).

Replace the Pallas ``csr_gather_2d`` and ``csr_gather_batched_2d``
(``repro/kernels/bucket_probe.py``).  Four entries launch one device
routine (a load-balanced search per tile of output slots):

- :func:`csr_gather_2d` and :func:`csr_gather_batched_2d`, the Pallas
  functions' interface: the exact ``num_rows + 1`` prefix sums of the run
  lengths, the run starts and an int32 table, returning
  ``(values, row_idx)`` per output slot;
- :func:`csr_gather_owners`, the owner side of a retrieve: every owner,
  source and layer in one launch, reading the per-layer run descriptors and
  the layer tables in place;
- :func:`csr_gather_queriers`, the querier side: every querier in one
  launch, each from its own row of the returned segments.

Every table may carry C value columns, ``(..., M, C)`` int32 row-major
(``(..., M)`` is one column): each output slot then holds its row's C words,
``(..., capacity, C)``, found with one row search.

Every wrapper takes ``block_rows`` (None: ``common.resolve_block_rows``;
the Pallas-interface entries under their own names, the owner and querier
entries under ``csr_gather_batched``, with ``n`` the capacity and
``width`` the columns): a CTA's tile of output slots, 8, 16 or 32 rows of
128.  On CUDA tensors the wrappers launch the kernel or raise; on CPU
tensors they run the plain twins (:func:`gather_plain`,
:func:`csr_gather_owners_plain`, :func:`csr_gather_queriers_plain`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import hashgraph
from repro_torch.kernels import build, common

SINGLE = "csr_gather"
BATCHED = "csr_gather_batched"
OWNERS = "csr_gather_owners"
QUERIERS = "csr_gather_queriers"
# Output slots of one block: positions are int32 in the kernel, with a tile
# of headroom.
MAX_CAPACITY = 2**31 - 1 - 2048


def interleave_layer_runs(
    starts: torch.Tensor, counts: torch.Tensor, tables: Sequence[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot-major/layer-minor interleave of ``(L, S, N)`` run descriptors.

    ``starts`` are already offset into the concatenated layer tables.  The
    ``(S, N·L)`` result places slot ``i``'s L runs adjacently in epoch order:
    the packing the ragged return reconstructs from per-slot totals.  The
    single definition of that order for the plain path.
    """
    l, s_dim, n = counts.shape
    table_cat = tables[0] if l == 1 else torch.cat(list(tables), 0)
    starts_i = starts.to(torch.int32).permute(1, 2, 0).reshape(s_dim, n * l)
    counts_i = counts.to(torch.int32).permute(1, 2, 0).reshape(s_dim, n * l)
    return starts_i, counts_i, table_cat


def gather_plain(
    offsets: torch.Tensor,
    starts: torch.Tensor,
    table: torch.Tensor,
    capacity: int,
    fill: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of both kernels: ``offsets`` ``(..., N+1)`` with
    ``offsets[..., 0] == 0``, ``starts`` ``(..., N)``, a ``(M,)`` or
    ``(M, C)`` ``table``."""
    counts = torch.diff(offsets, dim=-1)
    _, rows, vals, _ = hashgraph.csr_gather(starts, counts, table, capacity, fill=fill)
    return vals, rows


def csr_gather_owners_plain(
    starts: torch.Tensor,
    counts: torch.Tensor,
    tables: Sequence[torch.Tensor],
    seg_capacity: int,
    fill: int = -1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`csr_gather_owners`: per owner, the layers' runs
    rebased into the concatenated tables, interleaved slot-major and gathered
    per source."""
    nl, d_o, d_s, r = counts.shape
    widths = [0] + [t.shape[1] for t in tables[:-1]]
    base = torch.cumsum(torch.tensor(widths, dtype=torch.int32), 0, dtype=torch.int32)
    base = base.to(starts.device).view(nl, 1, 1)
    segs, dropped = [], []
    for o in range(d_o):
        st, ct, table = interleave_layer_runs(
            starts[:, o] + base, counts[:, o], tuple(t[o] for t in tables)
        )
        _, _, seg, drop = hashgraph.csr_gather(st, ct, table, seg_capacity, fill=fill)
        segs.append(seg)
        dropped.append(drop)
    return torch.stack(segs), torch.stack(dropped), counts.sum(0, dtype=torch.int32)


def csr_gather_queriers_plain(
    starts: torch.Tensor,
    counts: torch.Tensor,
    table: torch.Tensor,
    capacity: int,
    fill: int = -1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`csr_gather_queriers`: one CSR gather per querier
    over its own table row."""
    parts = [
        hashgraph.csr_gather(starts[q], counts[q], table[q], capacity, fill=fill)
        for q in range(counts.shape[0])
    ]
    return tuple(torch.stack(p) for p in zip(*parts))


def _check(name, offsets, starts, table, lead: int) -> int:
    for label, t in (("offsets", offsets), ("starts", starts), ("table", table)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t.dtype}")
    if offsets.ndim != lead + 1 or starts.ndim != lead + 1 or table.ndim not in (1, 2):
        raise ValueError(
            f"{name}: shapes offsets {tuple(offsets.shape)}, starts "
            f"{tuple(starts.shape)}, table {tuple(table.shape)}"
        )
    num_rows = starts.shape[-1]
    if offsets.shape[-1] != num_rows + 1 or offsets.shape[:-1] != starts.shape[:-1]:
        raise ValueError(
            f"{name}: offsets {tuple(offsets.shape)} do not match starts "
            f"{tuple(starts.shape)}"
        )
    if num_rows >= 2**31 - 1:
        raise ValueError(f"{name}: {num_rows} rows exceed int32")
    return num_rows


def _check_capacity(name: str, capacity: int) -> None:
    if not 0 <= capacity <= MAX_CAPACITY:
        raise ValueError(f"{name}: capacity {capacity} outside [0, {MAX_CAPACITY}]")


def _cols(table: torch.Tensor, lead: int) -> int:
    """Value columns of a table with ``lead`` leading dims before its rows."""
    return 1 if table.ndim == lead + 1 else int(table.shape[-1])


def _aligned(table: torch.Tensor, cols: int) -> torch.Tensor:
    """The table contiguous, and 16-byte aligned where the kernel moves its
    rows of 4 columns with 16-byte loads."""
    table = table.contiguous()
    if cols == 4 and table.data_ptr() % 16:
        table = table.clone()
    return table


def _owner_table(t: torch.Tensor, cols: int) -> torch.Tensor:
    """A layer's ``(D_o, M[, C])`` table as the owner entry reads it: each
    owner's rows of C words in place (the stride between owners is read as
    it is), 16-byte aligned rows for C = 4; else a contiguous copy."""
    ok = t.stride(1) == cols and (t.ndim == 2 or t.stride(2) == 1)
    if cols == 4:
        ok = ok and t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0
    return t if ok else _aligned(t, cols)


def _launch(name, offsets, starts, table, capacity, fill, num_sources, block_rows):
    num_rows = starts.shape[-1]
    dev = offsets.device
    cols = _cols(table, 0)
    vals = torch.empty((num_sources, capacity) + tuple(table.shape[1:]), dtype=torch.int32,
                       device=dev)
    rows = torch.empty((num_sources, capacity), dtype=torch.int32, device=dev)
    if capacity == 0 or num_sources == 0:
        return vals, rows
    _check_capacity(name, capacity)
    build.require_cuda(name, offsets, starts, table, vals, rows)
    args = [
        offsets.data_ptr(), starts.data_ptr(), table.data_ptr(), table.shape[0], cols,
        vals.data_ptr(), rows.data_ptr(), capacity, num_rows,
    ]
    if name == BATCHED:
        args.append(num_sources)
    threads = common.launch_threads(name, block_rows, n=capacity, width=cols)
    build.launch(name, *args, int(fill), threads, build.stream_of(offsets))
    return vals, rows


def csr_gather_2d(
    offsets: torch.Tensor,
    starts: torch.Tensor,
    table: torch.Tensor,
    capacity: int,
    fill: int = -1,
    *,
    block_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3: one CSR.  ``offsets`` ``(N+1,)``, ``starts`` ``(N,)``, a
    ``(M[, C])`` table → values ``(capacity[, C])`` and row ids ``(capacity,)``."""
    _check(SINGLE, offsets, starts, table, lead=0)
    if not build.on_card(SINGLE, offsets):
        return gather_plain(offsets, starts, table, capacity, fill)
    vals, rows = _launch(
        SINGLE, offsets.contiguous(), starts.contiguous(), _aligned(table, _cols(table, 0)),
        capacity, fill, 1, block_rows,
    )
    return vals[0], rows[0]


def csr_gather_batched_2d(
    offsets: torch.Tensor,
    starts: torch.Tensor,
    table: torch.Tensor,
    capacity: int,
    fill: int = -1,
    *,
    block_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4: one CSR per source over a shared ``(M[, C])`` table.
    ``offsets`` ``(S, N+1)``, ``starts`` ``(S, N)`` → values ``(S,
    capacity[, C])`` and row ids ``(S, capacity)``."""
    _check(BATCHED, offsets, starts, table, lead=1)
    if not build.on_card(BATCHED, offsets):
        return gather_plain(offsets, starts, table, capacity, fill)
    return _launch(
        BATCHED, offsets.contiguous(), starts.contiguous(), _aligned(table, _cols(table, 0)),
        capacity, fill, offsets.shape[0], block_rows,
    )


def csr_gather_owners(
    starts: torch.Tensor,
    counts: torch.Tensor,
    tables: Sequence[torch.Tensor],
    seg_capacity: int,
    fill: int = -1,
    *,
    block_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Owner-side gather of a retrieve, every owner and layer in one launch.

    ``starts``/``counts`` ``(L, D_o, D_s, R)`` int32: layer ``l``'s run of
    routed slot ``n`` from source ``s`` at owner ``o``, a start into that
    owner's row of ``tables[l]`` ``(D_o, M_l[, C])`` (each run inside it, as
    the locate gives them; every layer has the same C).  Returns ``(seg,
    dropped, slot_counts)``: ``(D_o, D_s, seg_capacity[, C])`` segments,
    slot ``n``'s layer runs packed
    in epoch order, slots in order (``fill`` past the total), the
    ``(D_o, D_s)`` overflows ``max(0, total - seg_capacity)``, and each
    slot's total over the layers ``(D_o, D_s, R)`` (``counts.sum(0)``, the
    sizes the ragged return ships).
    """
    if starts.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError(f"{OWNERS}: starts and counts must be int32")
    if counts.ndim != 4 or starts.shape != counts.shape:
        raise ValueError(f"{OWNERS}: starts {tuple(starts.shape)}, counts {tuple(counts.shape)}")
    nl, d_o, d_s, r = counts.shape
    if nl < 1 or len(tables) != nl:
        raise ValueError(f"{OWNERS}: {len(tables)} tables for counts {tuple(counts.shape)}")
    cols = _cols(tables[0], 1)
    for t in tables:
        if t.dtype != torch.int32 or t.ndim not in (2, 3) or t.shape[0] != d_o or (
            _cols(t, 1) != cols
        ):
            raise ValueError(
                f"{OWNERS}: a table of {t.dtype} {tuple(t.shape)}, want int32 ({d_o}, M) or "
                f"({d_o}, M, C) with one C for every layer"
            )
    if r >= 2**31 - 1:
        raise ValueError(f"{OWNERS}: {r} rows exceed int32")
    _check_capacity(OWNERS, seg_capacity)
    if not build.on_card(OWNERS, counts):
        return csr_gather_owners_plain(starts, counts, tables, seg_capacity, fill)
    dev = counts.device
    starts, counts = starts.contiguous(), counts.contiguous()
    tables = [_owner_table(t, cols) for t in tables]
    slot_counts = counts.sum(0, dtype=torch.int32)
    # One flat scan: the kernel rebases each block (a scan per row of a
    # (D_o, D_s, R) tensor is one slow launch at D > 1).
    slot_incl = torch.cumsum(slot_counts.reshape(-1), 0, dtype=torch.int32)
    seg = torch.empty((d_o, d_s, seg_capacity) + tuple(tables[0].shape[2:]), dtype=torch.int32,
                      device=dev)
    dropped = torch.empty((d_o, d_s), dtype=torch.int32, device=dev)
    build.require_cuda(OWNERS, counts, starts, slot_incl, seg, dropped)
    if any(t.device != dev for t in tables):
        raise ValueError(f"{OWNERS}: tables on {[str(t.device) for t in tables]}, runs on {dev}")
    # Each layer's (base address, owner row stride in words, table rows),
    # L x 24 bytes: the copy from pageable memory is staged before it
    # returns, so the host tensor may go at once.
    layer_tables = torch.tensor(
        [[t.data_ptr(), t.stride(0), t.shape[1]] for t in tables], dtype=torch.int64
    ).to(dev, non_blocking=True)
    threads = common.launch_threads(BATCHED, block_rows, n=seg_capacity, width=cols)
    build.launch(
        OWNERS, slot_incl.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        layer_tables.data_ptr(), nl, d_o, d_s, r, cols, seg.data_ptr(), dropped.data_ptr(),
        seg_capacity, int(fill), threads, build.stream_of(counts),
    )
    return seg, dropped, slot_counts


def csr_gather_queriers(
    starts: torch.Tensor,
    counts: torch.Tensor,
    table: torch.Tensor,
    capacity: int,
    fill: int = -1,
    *,
    block_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Querier-side gather of a retrieve, every querier in one launch.

    ``starts``/``counts`` ``(D, N)`` int32 runs into each querier's own row
    of ``table`` ``(D, W[, C])``.  Returns ``(offsets, row_idx, values,
    dropped)``: ``(D, N+1)`` offsets clamped to ``capacity``, ``(D,
    capacity)`` row ids (-1 unused), ``(D, capacity[, C])`` values
    (``fill`` unused), and the ``(D,)`` overflows ``max(0, total -
    capacity)``.
    """
    if starts.dtype != torch.int32 or counts.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError(f"{QUERIERS}: starts, counts and table must be int32")
    if counts.ndim != 2 or starts.shape != counts.shape or table.ndim not in (2, 3) or (
        table.shape[0] != counts.shape[0]
    ):
        raise ValueError(
            f"{QUERIERS}: starts {tuple(starts.shape)}, counts {tuple(counts.shape)}, "
            f"table {tuple(table.shape)}"
        )
    d, n = counts.shape
    if n >= 2**31 - 1:
        raise ValueError(f"{QUERIERS}: {n} rows exceed int32")
    _check_capacity(QUERIERS, capacity)
    if not build.on_card(QUERIERS, counts):
        return csr_gather_queriers_plain(starts, counts, table, capacity, fill)
    dev = counts.device
    starts, table = starts.contiguous(), _aligned(table, _cols(table, 1))
    incl = torch.cumsum(counts.reshape(-1), 0, dtype=torch.int32)  # flat, as the owners'
    offsets = torch.empty((d, n + 1), dtype=torch.int32, device=dev)
    rows = torch.empty((d, capacity), dtype=torch.int32, device=dev)
    vals = torch.empty((d, capacity) + tuple(table.shape[2:]), dtype=torch.int32, device=dev)
    dropped = torch.empty((d,), dtype=torch.int32, device=dev)
    build.require_cuda(QUERIERS, incl, starts, table, offsets, rows, vals, dropped)
    cols = _cols(table, 1)
    threads = common.launch_threads(BATCHED, block_rows, n=capacity, width=cols)
    build.launch(
        QUERIERS, incl.data_ptr(), starts.data_ptr(), table.data_ptr(), table.shape[1],
        cols, vals.data_ptr(), rows.data_ptr(), offsets.data_ptr(),
        dropped.data_ptr(), capacity, n, d, int(fill), threads, build.stream_of(counts),
    )
    return offsets, rows, vals, dropped
