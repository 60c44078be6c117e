"""Async request front end — futures in, deadline-batched executions out
(port of ``repro.serve_table.frontend``; it imports numpy and ``obs`` only).

The synchronous serving path (:meth:`TableServer.query_many`) makes the
*caller* responsible for coalescing: one thread shows up with a list of
requests and blocks for the whole execute+scatter round trip.  Open-loop
traffic doesn't arrive that way — requests trickle in from many callers at
ragged times, and a device kept waiting for a "full" batch is a device
idling.  :class:`AsyncFrontend` closes that gap with the classic serving
triad:

* :class:`DeadlineBatcher` — a bounded admission queue that groups
  requests into a batch when a pow2 bucket's worth of keys has
  accumulated **or** the oldest request's deadline (capped by the
  ``linger`` period) comes due, whichever is first.  Low load pays at
  most one linger of latency; high load always ships full buckets.
* a **dispatcher thread** that pops due batches, stamps them with the
  current snapshot, and *enqueues* the fused execution on the device
  without blocking on results (:meth:`MicroBatcher.dispatch_query`);
* a **scatter thread** that waits on the batch's CUDA event, copies the
  counts to the host and resolves
  each caller's :class:`~concurrent.futures.Future` — so the host-side
  scatter of batch ``n`` overlaps the device execution of batch ``n+1``
  (the dispatch/scatter handoff queue is bounded, which also bounds
  device work in flight).

Writes go through the owning :class:`TableServer`'s writer loop; the front
end adds a **bounded write backlog**: ``submit_insert``/``submit_delete``
block (backpressure) while the server's queue is at capacity instead of
letting an open-loop producer grow it without bound.

Every public entry point returns immediately with a ``Future`` (reads) or
after admission (writes); no live request ever traces or compiles when the
server was warmed (:meth:`TableServer.warm`) — the dispatcher rides the
AOT executor grid like every other read.

Across processes the front end runs on rank 0, the server's leader: its
batches go to the followers through :meth:`TableServer.dispatch_query`,
which also gathers every rank's answers before it returns.

The batcher takes an injectable ``clock`` so the deadline logic is testable
under a fake clock (drive :meth:`DeadlineBatcher.poll` manually) as well as
the real timer (:meth:`DeadlineBatcher.next_batch` blocks on a Condition
with the exact next-due timeout — no polling loop).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from repro_torch.obs.registry import MetricsRegistry, RegistrySnapshot
from repro_torch.obs.tracing import Tracer


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """What a read future resolves to: counts + the snapshot that served it."""

    counts: np.ndarray  # int32, aligned with the request's keys
    seqno: int  # snapshot seqno the batch executed against


@dataclasses.dataclass
class _Pending:
    """One admitted request parked in the deadline batcher."""

    keys: np.ndarray  # packed key array
    size: int  # number of keys
    deadline: float  # absolute clock() time the caller needs dispatch by
    enqueued: float  # absolute clock() admission time
    future: Future = dataclasses.field(default_factory=Future)
    trace: Optional[object] = None  # obs.tracing.Trace when tracing is on


class DeadlineBatcher:
    """Bounded request queue with fill-or-deadline flushing.

    Flush rule — a batch is due as soon as either holds:

    * **fill**: pending keys reach ``flush_keys`` (a pow2 bucket's worth —
      shipping it now costs no extra padding), or
    * **deadline**: the clock reaches ``min(oldest.enqueued + linger,
      oldest.deadline)`` — nobody waits longer than the linger period, and
      a request with an earlier explicit deadline pulls the flush forward.

    ``capacity`` bounds admitted-but-undispatched requests; ``submit``
    blocks (backpressure) while full.  All state lives under one
    Condition; :meth:`poll` is the non-blocking fake-clock entry point and
    :meth:`next_batch` the blocking real-timer one.
    """

    def __init__(
        self,
        *,
        flush_keys: int = 64,
        linger: float = 0.002,
        capacity: int = 4096,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[MetricsRegistry] = None,
    ):
        if flush_keys < 1:
            raise ValueError("flush_keys must be >= 1")
        if linger < 0:
            raise ValueError("linger must be >= 0")
        self.flush_keys = int(flush_keys)
        self.linger = float(linger)
        self.capacity = int(capacity)
        self.clock = clock
        self._cond = threading.Condition()
        self._queue: list[_Pending] = []
        self._queued_keys = 0
        self._closed = False
        # Counters live in a registry (private unless a front end shares
        # its server's); instruments are leaf-locked, safe under _cond.
        self.metrics_registry = registry if registry is not None else MetricsRegistry()
        self._c_submitted = self.metrics_registry.counter(
            "frontend_submitted_total", help="Read requests admitted."
        )
        self._c_flushed = self.metrics_registry.counter(
            "frontend_flushed_batches_total", help="Batches popped for dispatch."
        )
        self._c_fill = self.metrics_registry.counter(
            "frontend_flushed_fill_total",
            help="Batches shipped because the bucket filled.",
        )
        self._c_due = self.metrics_registry.counter(
            "frontend_flushed_due_total",
            help="Batches shipped on linger/deadline expiry.",
        )

    # -- admission -------------------------------------------------------------
    def submit(
        self,
        keys,
        *,
        deadline: Optional[float] = None,
        timeout: Optional[float] = None,
        trace=None,
    ) -> _Pending:
        """Admit one request; block while the queue is at capacity.

        ``deadline`` is an absolute ``clock()`` time (default: admission +
        linger).  Raises :class:`RuntimeError` once closed and
        :class:`TimeoutError` if backpressure outlasts ``timeout``.
        ``trace`` (an :class:`~repro_torch.obs.tracing.Trace`) rides the request
        through the pipeline; its admission phase ends here, at enqueue —
        so backpressure waits are *admission* time, not linger.
        """
        keys = np.asarray(keys)
        size = int(keys.shape[0])
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._closed or len(self._queue) < self.capacity,
                timeout=timeout,
            )
            if self._closed:
                raise RuntimeError("batcher is closed")
            if not ok:
                raise TimeoutError(
                    f"admission queue full ({self.capacity}) for {timeout}s"
                )
            now = self.clock()
            req = _Pending(
                keys=keys,
                size=size,
                deadline=now + self.linger if deadline is None else deadline,
                enqueued=now,
                trace=trace,
            )
            if trace is not None:
                trace.mark("admission", now)
            self._queue.append(req)
            self._queued_keys += size
            self._c_submitted.inc()
            self._cond.notify_all()  # wake the dispatcher (and full-queue waiters)
            return req

    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- flush decision ----------------------------------------------------------
    def _due_at(self) -> Optional[float]:
        """Absolute time the next flush is owed (None = empty queue).

        The linger bound is tightest at the head (FIFO admission), but an
        explicit deadline can arrive on *any* queued request — a later
        submission with an urgent deadline pulls the whole flush forward,
        so the deadline term is the queue-wide minimum.
        """
        if not self._queue:
            return None
        return min(
            self._queue[0].enqueued + self.linger,
            min(r.deadline for r in self._queue),
        )

    def _pop_batch_locked(self) -> list[_Pending]:
        """Pop FIFO requests up to one bucket's worth (always >= 1)."""
        batch = []
        total = 0
        while self._queue:
            r = self._queue[0]
            if batch and total + r.size > self.flush_keys:
                break  # next request starts the following batch
            batch.append(self._queue.pop(0))
            total += r.size
            if total >= self.flush_keys:
                break
        self._queued_keys -= total
        self._c_flushed.inc()
        if total >= self.flush_keys:
            self._c_fill.inc()
        else:
            self._c_due.inc()
        self._cond.notify_all()  # free capacity: wake blocked submitters
        return batch

    def poll(self, now: Optional[float] = None) -> Optional[list[_Pending]]:
        """Non-blocking: the due batch at time ``now``, or None.

        The deterministic entry point for fake-clock tests; the real-timer path
        (:meth:`next_batch`) applies the same rule.
        """
        with self._cond:
            if not self._queue:
                return None
            if now is None:
                now = self.clock()
            if self._queued_keys >= self.flush_keys or now >= self._due_at():
                return self._pop_batch_locked()
            return None

    def next_batch(self, timeout: Optional[float] = None) -> Optional[list[_Pending]]:
        """Block until a batch is due (or ``timeout``/close); None if neither.

        Sleeps on the Condition for exactly the time until the earliest
        flush obligation — a submit that fills the bucket (or arrives with
        an earlier deadline) wakes it immediately.
        """
        outer = None if timeout is None else self.clock() + timeout
        with self._cond:
            while True:
                now = self.clock()
                if self._queue and (
                    self._queued_keys >= self.flush_keys or now >= self._due_at()
                ):
                    return self._pop_batch_locked()
                if self._closed:
                    # Drain everything still queued on close (dispatched,
                    # never dropped), then report exhaustion.
                    return self._pop_batch_locked() if self._queue else None
                waits = [] if outer is None else [outer - now]
                if self._queue:
                    waits.append(self._due_at() - now)
                if outer is not None and now >= outer:
                    return None
                self._cond.wait(timeout=min(waits) if waits else None)

    def close(self) -> None:
        """Stop admissions; wake every waiter (queued requests stay poppable)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def counters(self) -> dict:
        snap = self.metrics_registry.snapshot()  # one consistent sample
        with self._cond:
            queued = len(self._queue)
        return {
            "submitted": int(snap.value("frontend_submitted_total")),
            "queued": queued,
            "flushed_batches": int(snap.value("frontend_flushed_batches_total")),
            "flushed_fill": int(snap.value("frontend_flushed_fill_total")),
            "flushed_due": int(snap.value("frontend_flushed_due_total")),
        }


@dataclasses.dataclass(frozen=True)
class FrontendStats:
    """One coherent sample of the async front end's counters."""

    submitted: int  # read requests admitted
    completed: int  # read futures resolved (results or errors)
    failed: int  # read futures resolved with an exception
    batches_dispatched: int  # fused executions enqueued on the device
    batches_fill: int  # ... flushed because the bucket filled
    batches_due: int  # ... flushed on linger/deadline expiry
    queue_depth: int  # admitted, not yet dispatched
    inflight: int  # dispatched, not yet scattered
    write_backpressure_waits: int  # writes that blocked on the backlog bound
    last_error: Optional[str]


class AsyncFrontend:
    """Futures-returning async facade over a (warmed) :class:`TableServer`.

    ``linger`` is the latency knob (max time a lone request waits for
    company), ``flush_keys`` the throughput knob (how many keys make a
    bucket worth shipping early; default: the server batcher's
    ``min_bucket``), ``default_deadline`` the per-request dispatch
    deadline when the caller doesn't pass one.  ``write_backlog`` bounds
    the server's write queue as seen through this front end —
    ``submit_insert``/``submit_delete`` block while it is full.

    Lifecycle: ``start()`` launches the dispatcher + scatter threads (and
    the server's embedded writer loop unless it is already running);
    ``stop()`` closes admission, drains in-flight batches, resolves every
    remaining future, and joins all threads.
    """

    # frontend counter names -> FrontendStats fields (per-instance views
    # subtract the at-construction base, the shared registry stays
    # cumulative across sequential front ends on one server)
    _METRICS = {
        "frontend_submitted_total": "submitted",
        "frontend_completed_total": "completed",
        "frontend_failed_total": "failed",
        "frontend_flushed_batches_total": "batches_dispatched",
        "frontend_flushed_fill_total": "batches_fill",
        "frontend_flushed_due_total": "batches_due",
        "frontend_backpressure_waits_total": "write_backpressure_waits",
    }

    def __init__(
        self,
        server,
        *,
        linger: float = 0.002,
        flush_keys: Optional[int] = None,
        capacity: int = 4096,
        default_deadline: float = 0.05,
        write_backlog: int = 64,
        inflight: int = 2,
        clock: Callable[[], float] = time.monotonic,
        tracing: bool = True,
        trace_ring: int = 256,
    ):
        self.server = server
        self.default_deadline = float(default_deadline)
        self.write_backlog = int(write_backlog)
        self.clock = clock
        # One registry for the whole stack: share the server's.
        self.metrics_registry = server.metrics_registry
        self.tracer = Tracer(
            self.metrics_registry, ring=trace_ring, enabled=tracing, clock=clock
        )
        self.batcher = DeadlineBatcher(
            flush_keys=(
                server.batcher.min_bucket if flush_keys is None else int(flush_keys)
            ),
            linger=linger,
            capacity=capacity,
            clock=clock,
            registry=self.metrics_registry,
        )
        # dispatcher -> scatter handoff; the bound is the overlap depth AND
        # the cap on un-scattered device work in flight.
        self._handoff: list = []
        self._handoff_cond = threading.Condition()
        self._handoff_bound = max(1, int(inflight))
        self._dispatcher: Optional[threading.Thread] = None
        self._scatterer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started_writer = False
        self._c_completed = self.metrics_registry.counter(
            "frontend_completed_total",
            help="Read futures resolved (results or errors).",
        )
        self._c_failed = self.metrics_registry.counter(
            "frontend_failed_total",
            help="Read futures resolved with an exception.",
        )
        self._c_bp_waits = self.metrics_registry.counter(
            "frontend_backpressure_waits_total",
            help="Writes that blocked on the backlog bound.",
        )
        base = self.metrics_registry.snapshot()
        self._base = {name: int(base.value(name)) for name in self._METRICS}
        self._last_error: Optional[str] = None
        self._lock = threading.Lock()  # last_error only

    # -- lifecycle ---------------------------------------------------------------
    def start(self) -> "AsyncFrontend":
        if self._dispatcher is not None:
            raise RuntimeError("frontend already started")
        self._stop.clear()
        if not (
            self.server._writer_thread is not None
            and self.server._writer_thread.is_alive()
        ):
            self.server.start()
            self._started_writer = True
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-frontend-dispatch", daemon=True
        )
        self._scatterer = threading.Thread(
            target=self._scatter_loop, name="serve-frontend-scatter", daemon=True
        )
        self._dispatcher.start()
        self._scatterer.start()
        return self

    def stop(self) -> None:
        """Graceful shutdown: stop admissions, flush the pipeline, join."""
        self.batcher.close()
        if self._dispatcher is not None:
            self._dispatcher.join()
        self._stop.set()
        with self._handoff_cond:
            self._handoff_cond.notify_all()
        if self._scatterer is not None:
            self._scatterer.join()
        self._dispatcher = None
        self._scatterer = None
        if self._started_writer:
            self.server.stop()
            self._started_writer = False

    def __enter__(self) -> "AsyncFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- read path ----------------------------------------------------------------
    def submit_query(
        self,
        keys,
        *,
        deadline: Optional[float] = None,
        timeout: Optional[float] = None,
    ) -> Future:
        """Admit one query; resolve later to a :class:`QueryResult`.

        ``deadline`` (absolute ``clock()`` time; default now +
        ``default_deadline``) bounds how long the request may linger
        undispatched.  Blocks only on admission backpressure (bounded
        queue), never on execution.
        """
        packed = self.server.table.schema.pack_keys(keys, "cpu").numpy()
        if deadline is None:
            deadline = self.clock() + self.default_deadline
        trace = self.tracer.start(size=int(packed.shape[0]))
        try:
            req = self.batcher.submit(
                packed, deadline=deadline, timeout=timeout, trace=trace
            )
        except Exception:
            self.tracer.abandon(trace)  # rejected at admission: not a span
            raise
        return req.future

    # -- write path (bounded backlog -> server writer loop) -------------------------
    def _write_backpressure(self, timeout: Optional[float]) -> None:
        if self.server.pending() < self.write_backlog:
            return
        self._c_bp_waits.inc()
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.server.pending() >= self.write_backlog:
            if self._stop.is_set():
                raise RuntimeError("frontend stopped while write was blocked")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"write backlog stayed at/above {self.write_backlog} "
                    f"for {timeout}s"
                )
            time.sleep(0.0002)

    def submit_insert(self, keys, values=None, *, timeout: Optional[float] = None):
        """Queue one insert through the bounded backlog (blocks when full)."""
        self._write_backpressure(timeout)
        self.server.submit_insert(keys, values)

    def submit_delete(self, keys, *, timeout: Optional[float] = None):
        """Queue one delete through the bounded backlog (blocks when full)."""
        self._write_backpressure(timeout)
        self.server.submit_delete(keys)

    def submit_upsert(
        self,
        keys,
        values=None,
        *,
        ttl: Optional[int] = None,
        timeout: Optional[float] = None,
    ):
        """Queue one insert-or-replace through the bounded backlog.

        KV semantics (``TableServer.submit_upsert``): prior versions are
        hidden, later reads see exactly the new values, ``ttl`` schedules
        expiry on the server's logical clock.
        """
        self._write_backpressure(timeout)
        self.server.submit_upsert(keys, values, ttl=ttl)

    # -- worker loops ----------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            batch = self.batcher.next_batch(timeout=0.05)
            if batch is None:
                with self.batcher._cond:
                    if self.batcher._closed and not self.batcher._queue:
                        return
                continue
            now = self.clock()
            for r in batch:
                if r.trace is not None:
                    r.trace.mark("linger", now)
            try:
                pending = self.server.dispatch_query([r.keys for r in batch])
            except Exception as e:  # dispatch failed: fail this batch, keep serving
                self._fail_batch(batch, e)
                continue
            done = self.clock()
            for r in batch:
                if r.trace is not None:
                    r.trace.mark("dispatch", done)
                    r.trace.seqno = pending.seqno
                    r.trace.bucket = pending.bucket
            with self._handoff_cond:
                self._handoff_cond.wait_for(
                    lambda: len(self._handoff) < self._handoff_bound
                    or self._stop.is_set()
                )
                if self._stop.is_set():
                    self._fail_batch(
                        batch, RuntimeError("frontend stopped before scatter")
                    )
                    return
                self._handoff.append((pending, batch))
                self._handoff_cond.notify_all()

    def _scatter_loop(self) -> None:
        while True:
            with self._handoff_cond:
                self._handoff_cond.wait_for(
                    lambda: self._handoff or self._stop.is_set()
                )
                if not self._handoff:
                    if self._stop.is_set():
                        return
                    continue
                pending, batch = self._handoff.pop(0)
                self._handoff_cond.notify_all()
            traced = [r for r in batch if r.trace is not None]
            try:
                if traced:
                    # Split the device wait from the host-side scatter so
                    # the two phases are separately attributable; untraced
                    # batches keep the single blocking transfer.
                    pending.wait()
                    now = self.clock()
                    for r in traced:
                        r.trace.mark("device", now)
                results = pending.scatter()
            except Exception as e:
                self._fail_batch(batch, e)
                continue
            # Futures resolve BEFORE trace bookkeeping: callers see results
            # at the earliest instant; the scatter mark lands just after.
            for req, counts in zip(batch, results):
                req.future.set_result(QueryResult(counts=counts, seqno=pending.seqno))
            self._c_completed.inc(len(batch))
            if traced:
                now = self.clock()
                for r in traced:
                    r.trace.mark("scatter", now)
                    self.tracer.finish(r.trace)

    def _fail_batch(self, batch, exc: Exception) -> None:
        self._c_failed.inc(len(batch))
        self._c_completed.inc(len(batch))
        with self._lock:
            self._last_error = f"{type(exc).__name__}: {exc}"
        for req in batch:
            self.tracer.abandon(req.trace)  # error paths don't pollute latency
            if not req.future.done():
                req.future.set_exception(exc)

    # -- metrics ------------------------------------------------------------------
    def stats(self, snapshot: Optional[RegistrySnapshot] = None) -> FrontendStats:
        """Per-instance counter view from ONE registry snapshot.

        A single lock acquisition samples every counter (no tearing);
        values are this front end's own (the shared registry's cumulative
        totals minus the at-construction base).
        """
        snap = snapshot if snapshot is not None else self.metrics_registry.snapshot()
        vals = {
            field: int(snap.value(name)) - self._base[name]
            for name, field in self._METRICS.items()
        }
        with self._lock:
            last_error = self._last_error
        return FrontendStats(
            queue_depth=self.batcher.pending(),
            inflight=len(self._handoff),
            last_error=last_error,
            **vals,
        )

    def metrics(self, refresh: bool = True) -> RegistrySnapshot:
        """One atomic sample of the shared registry (front-end view).

        With ``refresh`` (default) the instantaneous gauges — admission
        queue depth, dispatch/scatter handoff depth, live (unfinished)
        traces — are re-read first.  The sample includes everything the
        owning server recorded too (same registry).
        """
        if refresh:
            reg = self.metrics_registry
            reg.gauge(
                "frontend_queue_depth", help="Admitted, not yet dispatched."
            ).set(self.batcher.pending())
            reg.gauge(
                "frontend_inflight", help="Dispatched, not yet scattered."
            ).set(len(self._handoff))
            reg.gauge(
                "trace_live",
                help="Traces started but not finished (0 after drain).",
            ).set(self.tracer.live())
        return self.metrics_registry.snapshot()


__all__ = [
    "AsyncFrontend",
    "DeadlineBatcher",
    "FrontendStats",
    "QueryResult",
]
