"""Incremental compaction: fold the oldest layers (port of
``repro.core.maintenance``).

``compact()`` folds the whole stack through a full rebuild: a strided deal,
the build's exchange and a new histogram.  :func:`fold_oldest` merges only
the ``k`` oldest deltas into the base.  On a partition-coherent stack that is
a layer-local rebuild (``multi_hashgraph.fold_layers_local``): each shard
already owns its hash range's rows in every layer, so the fold makes no
exchange call at all (``exchange.CALLS`` stays unchanged), and the remaining
deltas and surviving tombstones shift down by ``k`` epochs.

:class:`CompactionPolicy` decides when: delta-depth, tombstone-load and
dropped-rows triggers over a :class:`TableStats` snapshot.
:func:`record_fold` records a fold's pause and reclaimed rows into a metrics
registry (``repro_torch.obs.registry``), once per fold.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core import multi_hashgraph, plans
from repro_torch.core.hashgraph import EMPTY_BITS
from repro_torch.core.state import TableState, Tombstones


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Host-side snapshot of a :class:`TableState`'s maintenance signals."""

    delta_depth: int  # live deltas
    base_rows: int  # base CSR rows over all shards (allocated)
    delta_rows: int  # sum of delta CSR rows (allocated)
    tombstone_count: int  # used tombstone slots
    tombstone_capacity: int  # allocated tombstone slots
    tombstone_dropped: int  # deletes lost to tombstone capacity
    num_dropped: int  # total drops across builds + tombstones
    tombstone_expired: int = 0  # entries already effective at the clock

    @property
    def tombstone_load(self) -> float:
        """Tombstone fill fraction (0.0 on a zero-capacity buffer)."""
        if not self.tombstone_capacity:
            return 0.0
        return self.tombstone_count / self.tombstone_capacity

    @property
    def expired_load(self) -> float:
        """Fraction of tombstone slots whose entry is already effective."""
        if not self.tombstone_capacity:
            return 0.0
        return self.tombstone_expired / self.tombstone_capacity


def _rows(graph) -> int:
    """CSR rows of a graph over all shards (keys are ``(local, M[, L])``,
    every shard of the same M)."""
    return int(graph.group.size * graph.local.keys.shape[1])


def collect_stats(state: TableState) -> TableStats:
    """Read a :class:`TableStats` snapshot off ``state``: global numbers, the
    same on every rank of a process group (the tombstones are replicated
    and ``num_dropped`` was summed over the group), so a policy decides
    alike everywhere."""
    ts = state.tombstones
    expired = 0
    if ts.capacity:
        expired = int(((ts.epochs >= 0) & (ts.now >= ts.expires)).sum())
    return TableStats(
        delta_depth=len(state.deltas),
        base_rows=_rows(state.base),
        delta_rows=sum(_rows(d) for d in state.deltas),
        tombstone_count=int(ts.count),
        tombstone_capacity=ts.capacity,
        tombstone_dropped=int(ts.num_dropped),
        num_dropped=int(state.num_dropped),
        tombstone_expired=expired,
    )


def collect_layer_live(state: TableState) -> tuple:
    """Per-layer ``(live_rows, allocated_rows)`` pairs over every shard,
    base first."""
    live = [int(x) for x in plans.exec_layer_live(state.table, state)]
    alloc = [_rows(layer) for layer in state.layers]
    return tuple(zip(live, alloc))


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Trigger thresholds for (incremental) compaction.

    ``max_delta_depth`` folds when the ring reaches that depth (``None``
    disables); ``tombstone_load`` at that buffer fill fraction;
    ``tombstone_overflow`` once deletes were lost to capacity;
    ``max_dropped`` once total drops exceed it (``None`` disables);
    ``expired_load`` (TTL eviction) once that fraction of the buffer is
    already effective (``None`` disables).  ``fold_k`` is how many oldest
    deltas an incremental pass merges; ``None`` sizes it from the per-layer
    live counts (:func:`collect_layer_live`): the longest prefix of deltas at
    or below ``cold_live_ratio`` of the hottest delta's live rows.
    """

    max_delta_depth: Optional[int] = None
    tombstone_load: float = 0.5
    tombstone_overflow: bool = True
    max_dropped: Optional[int] = None
    fold_k: Optional[int] = 2
    cold_live_ratio: float = 0.5
    expired_load: Optional[float] = None

    def due(self, stats: TableStats) -> bool:
        """Is a state with these stats due for compaction?"""
        if self.max_delta_depth is not None and stats.delta_depth >= self.max_delta_depth:
            return True
        return self.escalates(stats)

    def escalates(self, stats: TableStats) -> bool:
        """Does the state need a full compaction rather than a fold?  True
        under tombstone, expiry or dropped-row pressure, at any depth."""
        if self.tombstone_overflow and stats.tombstone_dropped > 0:
            return True
        if stats.tombstone_capacity and stats.tombstone_load >= self.tombstone_load:
            return True
        if (
            self.expired_load is not None
            and stats.tombstone_capacity
            and stats.expired_load >= self.expired_load
        ):
            return True
        return self.max_dropped is not None and stats.num_dropped > self.max_dropped

    def fold_amount(self, stats: TableStats, layer_live=None) -> int:
        """How many oldest deltas to fold: every delta when :meth:`escalates`,
        else ``fold_k`` (clamped), else the cold prefix of ``layer_live``;
        at least one when there is a delta."""
        if self.escalates(stats):
            return stats.delta_depth
        if not stats.delta_depth:
            return 0
        if self.fold_k is not None:
            return min(max(1, self.fold_k), stats.delta_depth)
        k = 1
        if layer_live is not None:
            deltas = layer_live[1:]  # index 0 is the base
            peak = max((live for live, _ in deltas), default=0)
            if peak == 0:
                k = len(deltas)  # nothing live anywhere: fold them all
            else:
                for j, (live, _alloc) in enumerate(deltas, start=1):
                    if live <= self.cold_live_ratio * peak:
                        k = j
                    else:
                        break
        return min(max(1, k), stats.delta_depth)


def allocated_rows(state: TableState) -> int:
    """Total allocated CSR rows (base + deltas) over all shards."""
    return _rows(state.base) + sum(
        _rows(d) for d in state.deltas
    )


def record_fold(metrics, *, kind: str, seconds: float, rows_before: int, rows_after: int) -> None:
    """Record one fold's pause time and reclaimed rows into ``metrics``.

    ``kind`` is ``"fold"`` (incremental) or ``"full"`` (compaction).
    Reclaimed rows clamp at zero: an incremental fold grows the base by the
    folded deltas' rows, and a counter must not go down.  One recording site
    per fold: the server's fold code calls this, and only direct callers
    pass ``metrics`` to :func:`fold_oldest`.  ``metrics=None`` is a no-op.
    """
    if metrics is None:
        return
    metrics.counter(
        "maintenance_folds_total",
        labels={"kind": kind},
        help="Fold/compact passes by kind (fold=incremental, full=rebuild).",
    ).inc()
    metrics.histogram(
        "maintenance_fold_seconds",
        labels={"kind": kind},
        help="Fold pause time (the write-path stall a fold costs).",
    ).observe(seconds)
    reclaimed = max(0, int(rows_before) - int(rows_after))
    metrics.counter(
        "maintenance_reclaimed_rows_total",
        help="Allocated CSR rows returned by folds/compactions.",
    ).inc(reclaimed)
    metrics.gauge(
        "maintenance_last_reclaimed_rows",
        help="Rows reclaimed by the most recent fold (0 when it grew).",
    ).set(reclaimed)


def _remap_tombstones(ts: Tombstones, k: int) -> Tombstones:
    """Shift a tombstone buffer past a fold of the ``k`` oldest deltas.

    Effective tombstones with epoch ``<= k`` are spent by the fold and
    dropped; those with ``e > k`` keep hiding the surviving deltas at
    ``e - k``.  Entries still pending at the clock masked nothing yet, so
    they survive whatever their epoch, clamped to 0.  Survivors are repacked
    to the front; the overflow tally and the clock are kept.
    """
    spent = ts.now >= ts.expires
    keep = (ts.epochs > k) | ((ts.epochs >= 0) & ~spent)
    order = torch.sort((~keep).to(torch.int32), stable=True).indices
    kept = keep[order]
    new_epochs = torch.clamp(ts.epochs[order] - k, min=0)
    return Tombstones(
        keys=torch.where(kept.view(-1, *(1,) * (ts.keys.ndim - 1)), ts.keys[order], EMPTY_BITS),
        epochs=torch.where(kept, new_epochs, -1).to(torch.int32),
        expires=torch.where(kept, ts.expires[order], 0).to(torch.int32),
        count=int(keep.sum()),
        num_dropped=ts.num_dropped,
        now=ts.now,
    )


def exec_fold(table, state: TableState, *, k: int):
    """The layer-local fold of the ``k`` oldest deltas of a coherent stack as
    one executor: ``(new_base, remapped_tombstones)``, no exchange call
    (``fold_layers_local`` never leaves the shard).  ``table`` is accepted
    for the reference's signature; the state carries its own."""
    del table
    new_base = multi_hashgraph.fold_layers_local(
        state.layers[: k + 1], tombstones=state.tombstones.index()
    )
    return new_base, _remap_tombstones(state.tombstones, k)


def fold_oldest(state: TableState, k: int, *, metrics=None) -> TableState:
    """Merge the ``k`` oldest delta layers into the base; keep the rest.

    The new state has ``depth - k`` deltas and the surviving tombstones
    shifted down ``k`` epochs, and answers every query as before.  On a
    coherent stack the fold is layer-local (no exchange call); a mixed-split
    stack cannot fold locally and takes the full ``compact()``.  ``k <= 0``
    is the identity; ``k`` is clamped to the delta depth.  ``metrics`` (a
    ``MetricsRegistry``) records the fold by :func:`record_fold`, for direct
    callers only: the server times its folds itself.
    """
    k = min(int(k), len(state.deltas))
    if k <= 0:
        return state
    t0 = time.perf_counter()
    rows_before = allocated_rows(state)
    if not state.coherent:
        out = state.table.compact(state)
        kind = "full"
    else:
        new_base, new_ts = exec_fold(state.table, state, k=k)
        out = TableState(
            base=new_base,
            deltas=state.deltas[k:],
            tombstones=new_ts,
            table=state.table,
            coherent=True,
        )
        kind = "fold"
    record_fold(metrics, kind=kind, seconds=time.perf_counter() - t0,
                rows_before=rows_before, rows_after=allocated_rows(out))
    return out
