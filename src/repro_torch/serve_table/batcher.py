"""Query micro-batching — ragged request streams onto cached static shapes
(port of ``repro.serve_table.batcher``).

:class:`MicroBatcher` is the admission layer between a stream of small,
ragged read requests and the table's plans.  It

1. **coalesces** a batch of variable-size requests into one flat query
   array,
2. **pads** it with EMPTY sentinels up to a **pow2-bucketed** static size
   (sentinel queries count nothing), so the set of (bucket, state
   structure) pairs an AOT grid must hold is logarithmic in the request
   sizes,
3. executes ONE plan over the whole batch, and
4. **scatters** the results back per request.

Output capacities are bucketed the same way (next pow2 of the planning
round's exact need); overflow (``num_dropped > 0``) doubles them, bounded,
never silently.

On the card every read runs on the batcher's own CUDA stream: it waits on
the snapshot's ``ready`` event (a device-side wait) and never queues behind
a write or a fold on another stream.  A :class:`PendingBatch` waits on the
event recorded after its dispatch, not on the whole device.  Every
execution runs inside ``counting.scoped``: its exchange rounds (counted on
the calling thread only) are held against the read budget — two on a
partition-coherent stack, two a layer on a mixed-split one — and it is
logged in :attr:`MicroBatcher.timeline` with its launches and its start
and end events.

Over a process group (a table built with ``group=``) every rank holds the
same requests: each executes its block of the padded batch (``bucket / D``
rows) and one ``all_gather`` returns every rank's answers, so each rank
scatters the whole batch.  The batch's collectives go over the group's
``"read"`` communicator (``exchange.role``).  A :class:`TableServer` across
processes sets :attr:`MicroBatcher.announce`: rank 0 then broadcasts each
batch (kind, padded keys, seqno, capacities) under the batch lock before
running it, and the followers run it through :meth:`MicroBatcher.follow`.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import counting
from repro_torch.core import exchange, plans
from repro_torch.core.hashgraph import EMPTY_BITS
from repro_torch.core.multi_hashgraph import ShardRetrieval
from repro_torch.core.state import as_state
from repro_torch.core.table import retrieval_to_lists
from repro_torch.obs.registry import MetricsRegistry, RegistrySnapshot
from repro_torch.utils import cdiv, on_stream


TIMELINE = 4096  # read executions kept in MicroBatcher.timeline


@dataclasses.dataclass(frozen=True)
class BatcherStats:
    """Counters of one :class:`MicroBatcher` (monotone, host-side)."""

    requests: int  # individual requests served
    batches: int  # coalesced executions
    cache_hits: int  # executions reusing a cached (bucket, caps) plan
    cache_misses: int  # executions that had to build a plan
    overflow_retries: int  # capacity-doubling re-executions
    keys_served: int  # real (unpadded) query keys
    keys_padded: int  # EMPTY sentinel keys shipped for shape bucketing

    @property
    def pad_fraction(self) -> float:
        total = self.keys_served + self.keys_padded
        return self.keys_padded / total if total else 0.0


@dataclasses.dataclass(frozen=True)
class ExecRecord:
    """One read execution: what it ran against and what it cost."""

    kind: str  # "query" | "retrieve"
    bucket: int
    depth: int  # delta depth of the state
    fused: bool  # one routing round for the whole stack
    rounds: int  # exchange rounds made by the executing thread
    budget: int  # the rounds the path should make
    round_bytes: int  # bytes one shard sent through them
    launches: dict  # kernel -> launches
    t0: float  # host perf_counter at dispatch
    t1: float  # host perf_counter once enqueued
    start: Optional[object] = None  # CUDA events on the read stream (card only)
    end: Optional[object] = None


@dataclasses.dataclass
class PendingBatch:
    """One dispatched (not yet gathered) fused query execution.

    ``counts`` is the device tensor already enqueued on the read stream;
    nothing has waited on it yet.  :meth:`scatter` copies it to the host
    and slices the results back per request — the front end runs it on a
    separate thread so the device runs batch ``n+1`` while the host
    scatters batch ``n``.
    """

    counts: object  # enqueued device tensor
    bounds: list  # (start, stop) per request in the flat batch
    seqno: int  # snapshot the batch executed against
    aot: bool  # served by a warmed executor of the grid
    event: Optional[object] = None  # recorded after the dispatch (card only)

    @property
    def bucket(self) -> int:
        """The static batch size this execution was padded to."""
        return int(self.counts.shape[0])

    def wait(self) -> "PendingBatch":
        """Block until the batch's own work is done (its CUDA event, not a
        device-wide sync, which would also wait for a fold in flight)."""
        if self.event is not None:
            self.event.synchronize()
        return self

    def scatter(self) -> list:
        self.wait()
        c = self.counts.cpu().numpy()
        return [c[a:b] for a, b in self.bounds]


class MicroBatcher:
    """Coalesce ragged read requests into plan-cache-hitting static batches.

    ``min_bucket`` floors the padded batch size; buckets are the next power
    of two of the coalesced total, rounded up to a shard multiple.  One
    batcher serves one table.  Concurrent readers are safe but serialize
    through an internal lock for the duration of a batch (the plan caches,
    working capacities and counters are shared).
    """

    # metric name -> BatcherStats field, in declaration order
    _METRICS = {
        "batch_requests_total": "requests",
        "batch_executions_total": "batches",
        "batch_cache_hits_total": "cache_hits",
        "batch_cache_misses_total": "cache_misses",
        "batch_overflow_retries_total": "overflow_retries",
        "batch_keys_served_total": "keys_served",
        "batch_keys_padded_total": "keys_padded",
    }

    def __init__(
        self,
        table,
        *,
        min_bucket: int = 64,
        max_retries: int = 4,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.table = table
        self.min_bucket = max(int(min_bucket), table.num_devices)
        self.max_retries = int(max_retries)
        # AOT executor grid (repro_torch.serve_table.aot.ExecutorGrid),
        # attached by warm_server() and consulted before the plan caches.
        self.executors = None
        # Called with each batch's header under the batch lock before it runs
        # (a server across processes broadcasts it to the followers).
        self.announce = None
        self._batch_lock = threading.Lock()
        self._qplans = {}  # bucket -> QueryPlan
        self._rplans = {}  # (bucket, out_cap, seg_cap, per_layer) -> RetrievePlan
        self._caps = {}  # bucket -> (out_cap, seg_cap) current working caps
        dev = table.device
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        # The newest executions, oldest first (ExecRecord).
        self.timeline: collections.deque = collections.deque(maxlen=TIMELINE)
        self.metrics_registry = registry if registry is not None else MetricsRegistry()
        self._make_counters()

    def _make_counters(self) -> None:
        reg = self.metrics_registry
        self._counters = {
            name: reg.counter(name, help=f"MicroBatcher {field.replace('_', ' ')}.")
            for name, field in self._METRICS.items()
        }
        self._c_rounds = reg.counter(
            "batch_exchange_rounds_total",
            help="Exchange rounds made by read executions (counted per thread).",
        )
        self._c_budget = reg.counter(
            "batch_exchange_budget_misses_total",
            help="Read executions whose exchange rounds differ from the budget (want 0).",
        )

    def bind_registry(self, registry: MetricsRegistry) -> None:
        """Re-home the batcher's counters onto ``registry``, carrying the
        counts accumulated so far."""
        with self._batch_lock:
            old = self.metrics_registry.snapshot()
            self.metrics_registry = registry
            self._make_counters()
            for name in (*self._METRICS, "batch_exchange_rounds_total",
                         "batch_exchange_budget_misses_total"):
                carried = int(old.value(name))
                if carried:
                    registry.counter(name).inc(carried)

    # -- shape bucketing -----------------------------------------------------
    def bucket_size(self, total: int) -> int:
        """Static batch size for ``total`` coalesced keys: pow2, shard-aligned."""
        b = max(self.min_bucket, total)
        b = 1 << (b - 1).bit_length()
        d = self.table.num_devices
        return cdiv(b, d) * d

    def _coalesce(self, requests: Sequence):
        """Pack, concatenate and EMPTY-pad the request keys; returns the
        padded host batch and each request's ``(start, stop)`` in it."""
        packed = [self.table.schema.pack_keys(r, "cpu").numpy() for r in requests]
        bounds = []
        off = 0
        for p in packed:
            bounds.append((off, off + p.shape[0]))
            off += p.shape[0]
        bucket = self.bucket_size(off)
        lanes = self.table.schema.key_lanes
        flat = np.full((bucket,) if lanes == 1 else (bucket, lanes), EMPTY_BITS, np.int32)
        if packed:
            flat[:off] = np.concatenate(packed, axis=0)
        self._counters["batch_keys_served_total"].inc(off)
        self._counters["batch_keys_padded_total"].inc(bucket - off)
        return flat, bounds

    def _on_device(self, flat: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(flat).to(self.table.device)

    def _mine(self, q: torch.Tensor) -> torch.Tensor:
        """This caller's rows of a padded batch: all of it stacked, a rank's
        block over a process group."""
        return self.table._deal(q).flatten(0, 1)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's answers of a batch, in rank order (one ``all_gather``
        over a process group; stacked, ``t`` is the whole batch's)."""
        group = self.table.group
        if not group.is_process:
            return t
        return group.all_gather(t.unsqueeze(0)).reshape(-1, *t.shape[1:])

    def _gather_retrieval(self, res: ShardRetrieval) -> ShardRetrieval:
        """A rank's block of a retrieve (its offsets, values, counts and
        per-layer counts) and every other rank's, as the stacked run's global
        layout: one ``all_gather`` of the blocks side by side.  On the card
        the read stream is synchronised before it returns: the caller slices
        the result on the host, outside the stream."""
        if not self.table.group.is_process:
            return res
        parts = [res.offsets, res.values, res.counts]
        if res.layer_counts is not None:
            parts.append(res.layer_counts)
        flat = torch.cat([p.reshape(-1).to(torch.int32) for p in parts])
        got = self._gather(flat).reshape(self.table.group.size, -1)
        out, at = [], 0
        for p in parts:
            n = p.numel()
            out.append(got[:, at: at + n].reshape(-1, *p.shape[1:]).to(p.dtype))
            at += n
        if self.stream is not None:
            self.stream.synchronize()
        return ShardRetrieval(offsets=out[0], values=out[1], counts=out[2],
                              num_dropped=res.num_dropped,
                              layer_counts=out[3] if len(out) > 3 else None)

    # -- execution ------------------------------------------------------------
    def _caller_stream(self):
        return None if self.stream is None else torch.cuda.current_stream(self.stream.device)

    def _wait_ready(self, ready, caller) -> None:
        """Order the read after the state's kernels: the snapshot's event,
        or without one everything the caller's stream has queued (a state
        the caller built).  Call on the read stream."""
        if self.stream is None:
            return
        if ready is not None:
            self.stream.wait_event(ready)
        else:
            self.stream.wait_stream(caller)

    def _execute(self, kind: str, st, bucket: int, fn):
        """Run one read execution inside a per-thread scope, log it and hold
        its exchange rounds against the budget.  Call on the read stream."""
        fused = plans._fused(self.table, st)
        start = end = None
        if self.stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
        t0 = time.perf_counter()
        with counting.scoped() as scope:
            out = fn()
        t1 = time.perf_counter()
        if end is not None:
            end.record(self.stream)
        budget = 2 if fused else 2 * len(st.layers)
        self.timeline.append(ExecRecord(
            kind=kind, bucket=bucket, depth=len(st.deltas), fused=fused,
            rounds=scope.exchange_rounds, budget=budget, round_bytes=scope.exchange_bytes,
            launches=dict(scope.launches), t0=t0, t1=t1, start=start, end=end,
        ))
        self._c_rounds.inc(scope.exchange_rounds)
        if scope.exchange_rounds != budget:
            self._c_budget.inc()
        return out

    # -- read paths ----------------------------------------------------------
    def dispatch_query(self, state, requests: Sequence, seqno: int = -1,
                       ready=None) -> PendingBatch:
        """Enqueue one fused query execution; return before results land.

        ``ready`` (the snapshot's event) is waited on by the read stream
        before the state is read.  An attached AOT :attr:`executors` grid is
        consulted first; a miss falls back to the cached plans and is
        counted on the grid.
        """
        st = as_state(self.table, state)
        caller = self._caller_stream()
        with on_stream(self.stream):
            flat, bounds = self._coalesce(requests)
            q = self._on_device(flat)
        with self._batch_lock, on_stream(self.stream), exchange.role("read"):
            self._wait_ready(ready, caller)
            if self.announce is not None:
                self.announce({"kind": "query", "q": flat, "seqno": seqno})
            counts, hit = self._query_batch(st, q)
            event = None
            if self.stream is not None:
                event = torch.cuda.Event()
                event.record(self.stream)
                if ready is None:  # the caller may free the state once we return
                    caller.wait_event(event)
            self._counters["batch_requests_total"].inc(len(requests))
            return PendingBatch(counts=counts, bounds=bounds, seqno=seqno, aot=hit, event=event)

    def _query_batch(self, st, q: torch.Tensor) -> tuple:
        """One query execution of the padded batch ``q`` (this caller's rows
        of it, then every rank's answers): ``(counts, served by the grid)``.
        Call under the batch lock on the read stream."""
        bucket = q.shape[0]
        grid = self.executors
        handle = grid.query_handle(st, bucket) if grid is not None else None
        if handle is not None:
            self._counters["batch_cache_hits_total"].inc()
            run = handle
        else:
            plan = self._qplans.get(bucket)
            if plan is None:
                plan = self.table.plan_query(num_queries=bucket)
                self._qplans[bucket] = plan
                self._counters["batch_cache_misses_total"].inc()
            else:
                self._counters["batch_cache_hits_total"].inc()
            run = plan
        mine = self._mine(q)
        counts = self._gather(self._execute("query", st, bucket, lambda: run(st, mine)))
        self._counters["batch_executions_total"].inc()
        return counts, handle is not None

    def query_many(self, state, requests: Sequence, ready=None, seqno: int = -1) -> list:
        """Merged multiplicities for each request, one fused execution: one
        ``np.int32`` array per request, aligned with its keys."""
        if not requests:
            return []
        return self.dispatch_query(state, requests, seqno=seqno, ready=ready).scatter()

    def follow(self, header: dict, state, ready=None) -> None:
        """Run one batch rank 0 announced (:attr:`announce`) on this rank's
        block: the same execution, retries and ``all_gather`` as rank 0's,
        against ``state`` (the snapshot at the header's seqno)."""
        st = as_state(self.table, state)
        caller = self._caller_stream()
        with on_stream(self.stream):
            q = self._on_device(header["q"])
        with self._batch_lock, on_stream(self.stream), exchange.role("read"):
            self._wait_ready(ready, caller)
            if header["kind"] == "query":
                self._query_batch(st, q)
            else:
                caps = header["caps"]
                if caps is None:
                    self._caps.pop(q.shape[0], None)
                else:
                    self._caps[q.shape[0]] = tuple(caps)
                self._retrieve_batch(st, q, header["per_layer"])

    def retrieve_many(self, state, requests: Sequence, *, per_layer_counts: bool = False,
                      ready=None, seqno: int = -1):
        """All stored values for each request's keys, one fused execution.

        Returns one list per request with one value array per key.  With
        ``per_layer_counts=True`` returns ``(values, layer_counts)`` pairs
        per request, ``layer_counts`` the request's ``(num_keys, L)`` block.

        The first batch of a bucket runs the exact counts round and rounds
        both capacities up to powers of two; a batch that outgrows them
        (``num_dropped > 0``) doubles them (at most ``max_retries`` times)
        and re-executes, and raises rather than return short lists.
        """
        if not requests:
            return []
        st = as_state(self.table, state)
        caller = self._caller_stream()
        with on_stream(self.stream):
            flat, bounds = self._coalesce(requests)
            q = self._on_device(flat)
        with self._batch_lock, on_stream(self.stream), exchange.role("read"):
            self._wait_ready(ready, caller)
            if self.announce is not None:
                self.announce({"kind": "retrieve", "q": flat, "seqno": seqno,
                               "caps": self._caps.get(q.shape[0]),
                               "per_layer": per_layer_counts})
            res = self._retrieve_batch(st, q, per_layer_counts)
            self._counters["batch_requests_total"].inc(len(requests))
        # The result is complete (num_dropped was read on the read stream;
        # across processes the gather synchronised it): the host-side
        # slicing needs neither the lock nor the stream.
        per_key = retrieval_to_lists(res)
        out = [per_key[a:b] for a, b in bounds]
        if not per_layer_counts:
            return out
        lc = res.layer_counts.cpu().numpy()
        return [(vals, lc[a:b]) for vals, (a, b) in zip(out, bounds)]

    def _retrieve_batch(self, st, q: torch.Tensor, per_layer: bool) -> ShardRetrieval:
        """One retrieve of the padded batch ``q`` with the bucket's working
        capacities (the exact counts round first if it has none, doubled on
        overflow): every rank's blocks in the global layout.  Every decision
        reads global numbers, so the ranks run the same rounds.  Call under
        the batch lock on the read stream."""
        bucket = q.shape[0]
        mine = self._mine(q)
        caps = self._caps.get(bucket)
        if caps is None:
            seg_need, out_need = self.table.plan_caps(st, mine)
            caps = (_pow2(out_need), _pow2(seg_need))
            self._caps[bucket] = caps
        res, hit = self._exec_retrieve(st, mine, bucket, caps, per_layer)
        for _ in range(self.max_retries):
            if int(res.num_dropped) == 0:
                break
            caps = (caps[0] * 2, caps[1] * 2)
            self._caps[bucket] = caps
            self._counters["batch_overflow_retries_total"].inc()
            res, hit = self._exec_retrieve(st, mine, bucket, caps, per_layer)
        if int(res.num_dropped) != 0:
            raise RuntimeError(
                f"retrieve batch still overflows after {self.max_retries} "
                f"capacity doublings (bucket {bucket}, out/seg caps {caps}, "
                f"num_dropped {int(res.num_dropped)}); raise max_retries or "
                "pre-warm the bucket with representative traffic"
            )
        if hit:
            self._counters["batch_cache_hits_total"].inc()
        else:
            self._counters["batch_cache_misses_total"].inc()
        self._counters["batch_executions_total"].inc()
        return self._gather_retrieval(res)

    def _exec_retrieve(self, st, q, bucket, caps, per_layer):
        grid = self.executors
        run, hit = None, False
        if grid is not None:
            run = grid.retrieve_handle(st, bucket, caps[0], caps[1], per_layer)
            hit = run is not None
        if run is None:
            key = (bucket, caps[0], caps[1], per_layer)
            run = self._rplans.get(key)
            hit = run is not None
            if run is None:
                run = self.table.plan_retrieve(
                    num_queries=bucket,
                    out_capacity=caps[0],
                    seg_capacity=caps[1],
                    per_layer_counts=per_layer,
                )
                self._rplans[key] = run
        return self._execute("retrieve", st, bucket, lambda: run(st, q)), hit

    # -- metrics --------------------------------------------------------------
    def stats(self, snapshot: Optional[RegistrySnapshot] = None) -> BatcherStats:
        """A :class:`BatcherStats` view over one registry snapshot."""
        snap = snapshot if snapshot is not None else self.metrics_registry.snapshot()
        return BatcherStats(
            **{field: int(snap.value(name)) for name, field in self._METRICS.items()}
        )


def _pow2(n) -> int:
    n = int(n)
    return 8 if n <= 8 else 1 << (n - 1).bit_length()
