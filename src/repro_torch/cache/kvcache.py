"""KVCache — an eager KV-cache facade over the versioned distributed table
(port of ``repro.cache.kvcache``).

The table core is a *multiset* (insert adds occurrences); a cache wants a
*map* with lifetimes.  This facade closes the gap with the three pieces
the core already has for it:

* **put** is ``DistributedHashTable.upsert``: prior versions tombstoned at
  the current epoch, the new row in a fresh delta, so every read resolves
  the newest value through the same fused two-exchange-call route as a
  plain query.
* **TTL** rides the tombstone ``expires`` lane against the state's logical
  clock: ``advance(now)`` is O(1) and functional; expiry is resolved at
  read time.
* **Eviction** is the :class:`~repro_torch.core.maintenance.CompactionPolicy`
  eviction trigger: expired rows are invisible once the clock passes them,
  but their capacity returns only with a fold or compact, which
  :meth:`maintain` runs (stats-driven cold-first folds, escalation to the
  live-count-sized full rebuild under expired or tombstone pressure).

Eager and host-driven (each call reads a few scalars): the single-process
counterpart of ``repro_torch.serve_table``.  The cache lives on its table's
device.  :meth:`get` builds its answer from the retrieve's CSR with tensor
operations (the reference loops over per-key Python lists); the array it
returns is the reference's.

Over a process group (a table built with ``group=``) the cache runs SPMD,
as a ``torchrun`` program would: every rank calls the same methods in the
same order.  ``keys``/``values`` at construction are the rank's block of
the initial table; :meth:`get` / :meth:`contains` take the rank's own keys
(blocks of different lengths are EMPTY-padded to the group's longest: one
``agree``) and answer them; :meth:`put` / :meth:`delete` take the same
(replicated) batch on every rank, and the clock is replicated too.  Every
policy decision reads global numbers (the stats, the ``psum``'d live
counts), so every rank folds and evicts alike; each rank keeps its own
metrics registry.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import maintenance, plans
from repro_torch.core.hashgraph import EMPTY_BITS, EMPTY_KEY
from repro_torch.core.maintenance import CompactionPolicy
from repro_torch.core.state import TableState
from repro_torch.core.table import DistributedHashTable
from repro_torch.obs.registry import MetricsRegistry, RegistrySnapshot


class KVCache:
    """Insert-or-replace cache with TTL and eviction over one ``TableState``.

    ``table`` owns the device and the settings; ``keys``/``values``
    (optional) pre-load the cache through one bulk build.  ``default_ttl``
    applies to every :meth:`put` that passes none; ``policy`` defaults to
    stats-driven folds (``fold_k=None``), ring-full folding and the
    eviction escalation at 25% expired tombstone load.

    Every method is eager; the state is functional underneath, so
    :attr:`state` at any moment is an immutable snapshot.
    """

    def __init__(
        self,
        table: DistributedHashTable,
        keys=None,
        values=None,
        *,
        default_ttl: Optional[int] = None,
        policy: Optional[CompactionPolicy] = None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.table = table
        self.default_ttl = default_ttl
        self.metrics_registry = metrics if metrics is not None else MetricsRegistry()
        reg = self.metrics_registry
        self._c_puts = reg.counter("kvcache_puts_total", help="put() batches applied.")
        self._c_gets = reg.counter("kvcache_gets_total", help="get()/contains() batches served.")
        self._c_deletes = reg.counter("kvcache_deletes_total", help="delete() batches applied.")
        self._c_evictions = reg.counter(
            "kvcache_evictions_total", help="Full compacts run by maintenance."
        )
        self._c_folds = reg.counter(
            "kvcache_folds_total", help="Incremental folds run by maintenance."
        )
        self._h_put = reg.histogram("kvcache_put_seconds", help="put() wall-clock latency.")
        self._h_get = reg.histogram("kvcache_get_seconds", help="get() wall-clock latency.")
        self.policy = policy or CompactionPolicy(
            max_delta_depth=table.max_deltas,
            fold_k=None,
            expired_load=0.25,
        )
        if keys is None:
            # Empty cache: a base of EMPTY sentinel rows (zero live keys),
            # 8 a shard (a rank passes its own shard's).
            n = 8 * table.group.local
            lanes = table.schema.key_lanes
            keys = np.full((n,) if lanes == 1 else (n, lanes), EMPTY_KEY, np.uint32)
            values = np.full((n,), -1, np.int32)
            if table.schema.value_cols > 1:
                values = np.stack([values] * table.schema.value_cols, axis=1)
        self.state: TableState = table.init(keys, values)
        self.evictions = 0  # full compacts run by maintain()
        self.folds = 0  # incremental folds run by maintain()

    # -- clock ---------------------------------------------------------------
    @property
    def now(self) -> int:
        """The logical clock TTLs expire against."""
        return int(self.state.now)

    def advance(self, now: int) -> None:
        """Advance the logical clock (monotone); expiry is read-resolved."""
        self.state = self.state.advance(now)

    def tick(self, dt: int = 1) -> None:
        """Advance the clock by ``dt``."""
        self.advance(self.now + int(dt))

    # -- writes --------------------------------------------------------------
    def put(self, keys, values=None, *, ttl: Optional[int] = None) -> None:
        """Insert-or-replace ``keys`` -> ``values``; optional per-call TTL.

        Runs the compaction policy first (neither the delta ring nor the
        tombstone buffer can overflow mid-stream while its triggers are
        on), then one ``table.upsert``.  ``ttl=None`` falls back to
        ``default_ttl``; ``ttl=0`` is an immediately expired write.
        """
        t0 = time.perf_counter()
        stats = self.state.stats()
        if self.policy.due(stats):
            self.maintain(stats=stats, force=True)
        if ttl is None:
            ttl = self.default_ttl
        self.state = self.table.upsert(self.state, keys, values, ttl=ttl)
        self._c_puts.inc()
        self._h_put.observe(time.perf_counter() - t0)

    def delete(self, keys) -> None:
        """Drop ``keys`` from every later read (tombstoned at once)."""
        stats = self.state.stats()
        if self.policy.due(stats):
            self.maintain(stats=stats, force=True)
        self.state = self.table.delete(self.state, keys)
        self._c_deletes.inc()

    # -- reads ---------------------------------------------------------------
    def _pad_queries(self, keys) -> tuple[torch.Tensor, int]:
        """Keys on the table's device, EMPTY-padded to a multiple of the
        shard count (over a process group: to the longest rank's block, one
        ``agree``); and the real count."""
        q = self.table.schema.pack_keys(keys, self.table.device)
        n = q.shape[0]
        group = self.table.group
        pad = group.agree([n])[0] - n if group.is_process else (-n) % self.table.num_devices
        if pad:
            q = torch.cat([q, q.new_full((pad,) + tuple(q.shape[1:]), EMPTY_BITS)])
        return q, n

    def contains(self, keys) -> np.ndarray:
        """Boolean per key: a live (unexpired) entry is present."""
        q, n = self._pad_queries(keys)
        self._c_gets.inc()
        return self.table.query(self.state, q)[:n].cpu().numpy() > 0

    def get(self, keys, *, fill: int = -1) -> np.ndarray:
        """Current value per key; ``fill`` where missing or expired.

        Returns ``(N,)`` int32 for 1-column schemas, ``(N, C)`` otherwise.
        Under the KV discipline a present key has one live row; a key's
        answer is the first value of its run (the reference's per-key list
        element 0), picked on the device from the retrieve's CSR.
        """
        t0 = time.perf_counter()
        q, n = self._pad_queries(keys)
        res = self.table.retrieve(self.state, q)
        d = self.table.group.local  # the shard blocks this caller holds
        n_local = q.shape[0] // d
        out_cap = res.values.shape[0] // d
        off = res.offsets.reshape(d, n_local + 1)
        lens = (off[:, 1:] - off[:, :-1]).reshape(-1)
        block = torch.arange(d, device=off.device).unsqueeze(1) * out_cap
        first = (off[:, :-1] + block).reshape(-1).clamp(max=max(res.values.shape[0] - 1, 0))
        vals = res.values[first.to(torch.int64)]
        hit = lens > 0 if vals.ndim == 1 else (lens > 0).unsqueeze(-1)
        out = torch.where(hit, vals, fill)[:n].to(torch.int32).cpu().numpy()
        self._c_gets.inc()
        self._h_get.observe(time.perf_counter() - t0)
        return out

    # -- maintenance / eviction ----------------------------------------------
    def live_count(self) -> int:
        """Global live (visible at the current clock) row count."""
        return int(plans.exec_live_count(self.table, self.state))

    def stats(self):
        """The underlying ``TableStats`` (``tombstone_expired`` included)."""
        return self.state.stats()

    def metrics(self, refresh: bool = True) -> RegistrySnapshot:
        """One atomic sample of the cache's metrics registry.

        With ``refresh`` (default) the state-derived gauges (delta depth,
        tombstone load and expired load, logical clock) are re-read first.
        """
        if refresh:
            st = self.state.stats()
            reg = self.metrics_registry
            reg.gauge("kvcache_delta_depth", help="Live delta layers.").set(st.delta_depth)
            reg.gauge("kvcache_tombstone_load", help="Tombstone fill fraction.").set(
                st.tombstone_load
            )
            reg.gauge("kvcache_expired_load", help="Expired tombstone fraction.").set(
                st.expired_load
            )
            reg.gauge("kvcache_now", help="Logical clock TTLs expire on.").set(self.now)
        return self.metrics_registry.snapshot()

    def maintain(self, *, stats=None, force: bool = False) -> bool:
        """Run one policy-driven fold or eviction pass; True iff one ran.

        Escalations (tombstone pressure, dropped rows, the ``expired_load``
        trigger) and mixed-split stacks run the full live-count-sized
        ``compact()``, the pass that returns expired and superseded
        capacity; otherwise a stats-driven ``fold_oldest`` merges the cold
        prefix.  ``force`` skips the ``due`` check (``put`` made it).
        """
        if stats is None:
            stats = self.state.stats()
        if not force and not self.policy.due(stats):
            return False
        if self.policy.escalates(stats) or not self.state.coherent:
            self._run_fold(full=True)
            return True
        layer_live = None
        if self.policy.fold_k is None and stats.delta_depth:
            layer_live = maintenance.collect_layer_live(self.state)
        k = self.policy.fold_amount(stats, layer_live)
        if not k:
            return False
        self._run_fold(full=k >= stats.delta_depth, k=k)
        return True

    def _run_fold(self, *, full: bool, k: int = 0) -> None:
        """One timed fold or compact, recorded in the registry."""
        t0 = time.perf_counter()
        rows_before = maintenance.allocated_rows(self.state)
        if full:
            self.state = self.state.compact()
            self.evictions += 1
            self._c_evictions.inc()
        else:
            self.state = maintenance.fold_oldest(self.state, k)
            self.folds += 1
            self._c_folds.inc()
        maintenance.record_fold(
            self.metrics_registry,
            kind="full" if full else "fold",
            seconds=time.perf_counter() - t0,
            rows_before=rows_before,
            rows_after=maintenance.allocated_rows(self.state),
        )

    def evict_expired(self) -> int:
        """Force a full compact; returns the rows reclaimed (allocated base
        and delta rows before, less after)."""
        before = self.state.stats()
        alloc_before = before.base_rows + before.delta_rows
        self._run_fold(full=True)
        after = self.state.stats()
        return alloc_before - (after.base_rows + after.delta_rows)
