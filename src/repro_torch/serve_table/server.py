"""TableServer — snapshot-swapped reads over a mutating distributed table
(port of ``repro.serve_table.server``).

* **Readers** execute against the last *published*
  :class:`~repro_torch.serve_table.snapshot.Snapshot` through the
  :class:`~repro_torch.serve_table.batcher.MicroBatcher`; they never wait on
  a write or a fold.
* A **writer loop** pops queued insert/delete/upsert batches, applies them
  to a private *shadow* state (``TableState`` mutations are functional) and
  publishes the result with a fresh seqno.
* **Incremental background compaction**: between write batches the writer
  checks a :class:`~repro_torch.core.maintenance.CompactionPolicy` and runs
  :func:`~repro_torch.core.maintenance.fold_oldest` (layer-local, no
  exchange round) inline (``maintain()``) or on a worker thread
  (``fold_async()``) while reads keep flowing; escalations run the full
  ``compact()``.

On the card each role has its own CUDA stream: reads run on the batcher's,
writes on the writer's and every fold on the fold stream, which first waits
on the writer's.  A state is handed over when it is published: the event
recorded after its last kernel is waited on by the publishing thread (its
own stream only) and stored on the snapshot, which every reader's stream
waits on before reading it, and each of its tensors is marked with
``record_stream`` for the other streams, so the caching allocator never
reuses its memory while another stream still reads it.  So a read never
queues behind a fold's kernels.

Threading contract: one writer (the embedded ``start()`` thread or
an external caller of ``step()``/``maintain()``) plus any number of reader
threads.  Writer state (shadow, queue) is mutex-guarded; while a background
fold is in flight the writer defers new applications (writes queue up).

**Across processes** (a table built with ``group=``: one shard a rank) the
server runs on every rank, built alike (``keys`` / ``values`` are the
rank's block of the initial table, the ``table.init`` contract), warmed
alike, and rank 0 leads:

* *One communicator per role.*  Reads, writes and folds each get their own
  ``torch.distributed`` group over the same ranks (``ProcessGroup.
  add_roles``, created in that order when the server is built); each role's
  thread enters ``exchange.role``, so within a role the ranks issue their
  collectives in one order and across roles nothing needs ordering: a read
  never waits on a fold.
* *A leader and followers.*  Rank 0 holds the request queues, the batching
  decisions and the compaction policy, as the reference's single controller
  does.  Each decision goes out on its role's communicator before rank 0
  runs it: a read batch (kind, padded keys, seqno, capacities, per-layer
  flag), a window of writes (kind, keys, values, TTL), a ``maintain``, a
  background fold (its ``k``), an ``advance``, and stop.  Every rank runs
  the same code on its block (``bucket / D`` read rows, its block of an
  insert); a read's answers come back to every rank in one ``all_gather``.
  Followers run :meth:`TableServer.follow`, one thread a role, until rank 0
  sends stop; a follower never decides from its own clock or queue.
* *The same snapshot everywhere.*  A read runs against rank 0's seqno on
  every rank.  A follower keeps every published snapshot until rank 0's
  writes report that no read can ask for it (the oldest seqno a read in
  flight holds); mutations carry rank 0's sequence number and apply in that
  order on every rank.  Rank 0 holds a read's seqno until the read's
  gathered answers are complete on its read stream, not merely until its
  call returns: a collective may return once queued (NCCL), but its
  ``all_gather`` completes on rank 0 only after every follower has joined
  it, and a follower joins only after it has taken the snapshot.  Within
  one communicator the ranks' collectives run in the order they were issued.
* *Agreed failures.*  A mutation fails on every rank when it fails on any
  (one ``agree`` after it), so the shadows never diverge; rank 0 requeues
  and surfaces the write as the stacked server does.  Every wait is bounded
  by the group's timeout (idle roles get a heartbeat), so a dead rank makes
  the others raise.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import counting
from repro_torch.core import exchange, maintenance
from repro_torch.core.hashgraph import EMPTY_BITS
from repro_torch.core.maintenance import CompactionPolicy, TableStats
from repro_torch.core.state import TableState, empty_tombstones
from repro_torch.obs.registry import MetricsRegistry, RegistrySnapshot
from repro_torch.serve_table.batcher import BatcherStats, MicroBatcher
from repro_torch.serve_table.snapshot import Snapshot, SnapshotRegistry
from repro_torch.utils import on_stream


FOLD_LOG = 256  # folds kept in TableServer.fold_log
ROLES = ("read", "write", "fold")  # a server's communicators across processes


@dataclasses.dataclass(frozen=True)
class ServerStats:
    """One coherent sample of the server's counters and state signals."""

    seqno: int  # last published snapshot
    pending_writes: int  # queued, not yet applied
    writes_applied: int  # insert/delete batches applied to the shadow
    reads: int  # individual read requests served
    read_batches: int  # coalesced read executions
    folds: int  # incremental fold_oldest passes
    full_compacts: int  # full compact() escalations
    fold_seconds_total: float
    last_fold_seconds: float
    fold_in_flight: bool  # a background fold is currently running
    skew_fallbacks: int  # inserts routed incoherent by the skew guard
    last_error: Optional[str]  # last write-application failure (None = healthy)
    batcher: BatcherStats
    shadow: TableStats  # maintenance signals of the writer's state
    warmup: Optional[object] = None  # WarmupStats once warm() ran, else None


@dataclasses.dataclass(frozen=True)
class FoldRecord:
    """One fold: its kind, host and device times, and exchange rounds."""

    kind: str  # "fold" | "full"
    background: bool  # ran on the fold_async thread
    t0: float  # host perf_counter at start
    t_ready: float  # host perf_counter once its kernels were done
    t1: float  # host perf_counter once handed over
    rounds: int  # exchange rounds made by the folding thread
    launches: dict
    start: Optional[object] = None  # CUDA events on the fold stream (card only)
    end: Optional[object] = None


def _state_tensors(state: TableState):
    for layer in state.layers:
        g = layer.local
        yield from (g.offsets, g.keys, g.values, layer.hash_splits, layer.num_dropped)
        if g.fingerprints is not None:
            yield g.fingerprints
    ts = state.tombstones
    yield from (ts.keys, ts.epochs, ts.expires)


class TableServer:
    """Serve reads from published snapshots while a writer loop mutates.

    ``keys``/``values`` build the initial table (the ``table.init``
    contract).  ``policy`` defaults to folding whenever the delta ring
    reaches ``table.max_deltas``.  ``window`` is how many queued mutation
    batches the writer applies per publish.  ``write_bucket`` (a power of
    two, a multiple of the shard count) pads every insert to one geometry,
    which is what lets :meth:`warm` enumerate every state structure.

    Over a process group (module docstring) every rank builds the server
    alike; rank 0 takes the traffic and the others call :meth:`follow`.
    """

    def __init__(
        self,
        table,
        keys,
        values=None,
        *,
        policy: Optional[CompactionPolicy] = None,
        batcher: Optional[MicroBatcher] = None,
        window: int = 8,
        write_bucket: Optional[int] = None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.table = table
        group = table.group
        self.leader = group.rank == 0
        # Across processes: the role communicators (created alike on every
        # rank), rank 0's mutation sequence number, and the reads in flight
        # by the seqno they pinned (the followers keep those snapshots).
        self._lanes = group.is_process
        if self._lanes:
            group.add_roles(ROLES)
        self._mseq = 0
        self._turn = threading.Condition()
        self._lane_failed = False  # a follower's role failed: the others stop waiting
        self._pins: collections.Counter = collections.Counter()
        self._dispatched: list = []  # (seqno, event) of reads not yet gathered
        self._pin_lock = threading.Lock()
        self._closed = False
        self._last_sent = {lane: time.monotonic() for lane in ROLES}
        self._heartbeat: Optional[threading.Thread] = None
        self.write_bucket: Optional[int] = None
        if write_bucket is not None:
            wb = int(write_bucket)
            if wb < 1 or wb & (wb - 1):
                raise ValueError("write_bucket must be a power of two")
            if wb % table.num_devices:
                raise ValueError("write_bucket must be a multiple of the device count")
            self.write_bucket = wb
        self.metrics_registry = metrics if metrics is not None else MetricsRegistry()
        self.batcher = batcher or MicroBatcher(table)
        self.batcher.bind_registry(self.metrics_registry)
        dev = table.device
        self._write_stream = self._fold_stream = None
        self._streams = ()
        if dev.type == "cuda":
            self._write_stream = torch.cuda.Stream(dev)
            self._fold_stream = torch.cuda.Stream(dev)
            self._streams = (self.batcher.stream, self._write_stream, self._fold_stream)
        with on_stream(self._write_stream):
            if self._lanes:  # the rank's block: row ids global, no padding
                k, v = self._admit(keys, values)
                if values is None:
                    v = v + group.rank * k.shape[0]
                state = table.init(torch.from_numpy(k), torch.from_numpy(v))
            else:
                state = table.init(*self._pad_insert(*self._admit(keys, values)))
            if self.write_bucket is not None:
                # Shape-stable serving pre-grows the tombstone buffer (init
                # leaves it at zero capacity until the first delete): one
                # tombstone structure for the state's whole life.
                state = dataclasses.replace(state, tombstones=self._empty_tombstones())
        # A follower keeps every snapshot until rank 0 releases it.
        self.registry = SnapshotRegistry(
            state, ready=self._hand_over(state, self._write_stream),
            history=None if self._lanes and not self.leader else 8)
        self.policy = policy or CompactionPolicy(max_delta_depth=table.max_deltas)
        self.window = max(1, int(window))
        self._shadow = state
        self._shadow_ready = self.registry.current().ready
        self._writes: deque = deque()
        self._lock = threading.Lock()  # queue + shadow swaps
        # Serializes every shadow mutation (step vs background fold).
        self._writer_mutex = threading.Lock()
        self._fold_thread: Optional[threading.Thread] = None
        self._writer_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_error: Optional[str] = None
        self._fold_error: Optional[str] = None
        self._skew_base = table.skew_fallbacks
        # The newest folds, oldest first (FoldRecord).
        self.fold_log: collections.deque = collections.deque(maxlen=FOLD_LOG)
        reg = self.metrics_registry
        self._c_reads = reg.counter("serve_reads_total", help="Individual read requests served.")
        self._c_read_batches = reg.counter(
            "serve_read_batches_total", help="Coalesced read executions."
        )
        self._c_writes_applied = reg.counter(
            "serve_writes_applied_total",
            help="Insert/delete/upsert batches applied to the shadow.",
        )
        # Same instruments maintenance.record_fold targets (get-or-create).
        self._c_folds = reg.counter("maintenance_folds_total", labels={"kind": "fold"})
        self._c_full_compacts = reg.counter("maintenance_folds_total", labels={"kind": "full"})
        self._g_last_fold = reg.gauge(
            "serve_last_fold_seconds", help="Duration of the most recent fold."
        )
        self._c_fold_budget = reg.counter(
            "maintenance_fold_budget_misses_total",
            help="Incremental folds that made an exchange round (want 0).",
        )
        if self._lanes and self.leader:
            self.batcher.announce = lambda header: self._announce("read", header)
            self._heartbeat = threading.Thread(target=self._heartbeat_loop,
                                               name="serve-table-heartbeat", daemon=True)
            self._heartbeat.start()

    # -- lanes (across processes) -------------------------------------------------
    def _timeout(self) -> float:
        t = getattr(self.table.group, "timeout_s", None)
        return float(t) if t else 120.0

    def _bind_device(self) -> None:
        """A new thread's current card: the table's, where it names one."""
        dev = self.table.device
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)

    def _check_leader(self) -> None:
        if self._lanes and not self.leader:
            raise RuntimeError("a follower takes its work from rank 0: call follow()")
        if self._closed:
            raise RuntimeError("the server was stopped: its followers have left")

    def _floor(self) -> int:
        """The oldest seqno a read may still ask for (a read in flight's,
        else the current).  A dispatched batch holds its seqno until its
        gathered answers are complete on the read stream."""
        with self._pin_lock:
            self._dispatched = [(s, e) for s, e in self._dispatched if not e.query()]
            return min([self.registry.seqno, *self._pins, *(s for s, _ in self._dispatched)])

    @contextlib.contextmanager
    def _read_snapshot(self):
        """The current snapshot, pinned until the read on it returns (so the
        followers keep it)."""
        with self._pin_lock:
            snap = self.registry.current()
            self._pins[snap.seqno] += 1
        try:
            yield snap
        finally:
            with self._pin_lock:
                self._pins[snap.seqno] -= 1
                if not self._pins[snap.seqno]:
                    del self._pins[snap.seqno]

    def _announce(self, lane: str, record: dict) -> None:
        """Rank 0: send ``record`` to the followers on ``lane``'s
        communicator.  A mutation gets the next sequence number and the
        oldest seqno a read may still ask for.  Call holding the lane's lock
        (the batch lock for reads, the writer mutex otherwise)."""
        if not self._lanes:
            return
        if record["kind"] not in ("tick", "stop", "query", "retrieve"):
            self._mseq += 1
            record = {**record, "mseq": self._mseq, "floor": self._floor()}
        with exchange.role(lane):
            self.table.group.broadcast_object(record)
        self._last_sent[lane] = time.monotonic()

    def _heartbeat_loop(self) -> None:
        """Rank 0: a tick on every role idle for a quarter of the group's
        timeout, so an idle follower's wait never runs out."""
        period = self._timeout() / 4
        locks = {"read": self.batcher._batch_lock, "write": self._writer_mutex,
                 "fold": self._writer_mutex}
        while not self._closed:
            time.sleep(min(1.0, period / 4))
            for lane in ROLES:
                if self._closed or time.monotonic() - self._last_sent[lane] < period:
                    continue
                if not locks[lane].acquire(blocking=False):
                    continue
                try:
                    if not self._closed:
                        self._announce(lane, {"kind": "tick"})
                except Exception as e:  # noqa: BLE001 - a dead group: surfaced
                    self._last_error = f"{type(e).__name__}: {e}"
                    return
                finally:
                    locks[lane].release()

    def _agreed(self, fn):
        """``fn()``, its failure agreed over a process group: every rank
        raises when any rank's ``fn`` raised (one ``agree``), so a mutation
        lands everywhere or nowhere.  Stacked, ``fn()``."""
        group = self.table.group
        if not group.is_process:
            return fn()
        out, err = None, None
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 - re-raised after the verdict
            err = e
        if group.agree([int(err is not None)])[0]:
            raise err if err is not None else RuntimeError(
                "the mutation failed on another rank (agreed: no rank applied it)")
        return out

    def _block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a replicated batch (the whole of it stacked)."""
        return self.table._deal(t).flatten(0, 1)

    @contextlib.contextmanager
    def _in_turn(self, mseq: int):
        """A follower: wait until every earlier mutation of rank 0's order
        has applied here, run this one, then let the next go."""
        with self._turn:
            if not self._turn.wait_for(lambda: self._lane_failed or self._mseq == mseq - 1,
                                       timeout=self._timeout()):
                raise TimeoutError(f"mutation {mseq} waited for {mseq - 1} past the timeout")
            if self._lane_failed:
                raise RuntimeError(f"mutation {mseq}: another role of this rank failed")
        try:
            yield
        finally:
            with self._turn:
                self._mseq = mseq
                self._turn.notify_all()

    def follow(self) -> None:
        """A follower's serve loop: one thread a role, each running the
        records rank 0 sends on its communicator, until rank 0 sends stop.
        Raises ``RuntimeError`` when a role failed (a dead or diverged rank:
        a collective raised or ran out of the group's timeout)."""
        if not self._lanes or self.leader:
            raise RuntimeError("follow() is for ranks other than 0 of a process group")
        errors = []

        def lane_loop(lane):
            try:
                self._bind_device()
                with exchange.role(lane):
                    while True:
                        rec = self.table.group.broadcast_object(None)
                        kind = rec["kind"]
                        if kind == "stop":
                            return
                        if kind == "tick":
                            continue
                        if lane == "read":
                            self._follow_read(rec)
                        else:
                            with self._in_turn(rec["mseq"]):
                                self.registry.release_below(rec["floor"])
                                self._apply_record(rec)
            except Exception as e:  # noqa: BLE001 - reported by follow()
                errors.append(f"{lane}: {type(e).__name__}: {e}")
                with self._turn:
                    self._lane_failed = True
                    self._turn.notify_all()

        threads = [threading.Thread(target=lane_loop, args=(lane,), daemon=True,
                                    name=f"serve-table-follow-{lane}") for lane in ROLES]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._closed = True
        if errors:
            raise RuntimeError("follower lanes failed: " + "; ".join(errors))

    def _follow_read(self, rec: dict) -> None:
        """A follower: one of rank 0's read batches, against its seqno."""
        self.registry.wait_for(rec["seqno"], timeout=self._timeout())
        snap = self.registry.recent(rec["seqno"])
        if snap is None:
            raise RuntimeError(f"snapshot {rec['seqno']} was released before its read")
        try:
            self.batcher.follow(rec, snap.state, ready=snap.ready)
        except Exception as e:  # noqa: BLE001 - rank 0's batch failed alike
            self._last_error = f"{type(e).__name__}: {e}"

    def _apply_record(self, rec: dict) -> None:
        """One of rank 0's mutations, as a follower (or a stacked replay of
        rank 0's log) applies it; an error, agreed with rank 0, which
        surfaces it, is kept in ``last_error``."""
        kind = rec["kind"]
        try:
            if kind == "ops":
                with on_stream(self._write_stream), self._writer_mutex:
                    self._apply_ops(list(rec["ops"]))
            elif kind == "maintain":
                with self._writer_mutex:
                    self._maintain_body()
            elif kind == "fold":
                with self._writer_mutex:
                    self._fold_body(rec["k"])
            elif kind == "advance":
                with self._writer_mutex:
                    self._advance_body(rec["now"])
            else:
                raise ValueError(f"unknown record {kind!r}")
        except Exception as e:  # noqa: BLE001 - agreed with rank 0
            self._last_error = f"{type(e).__name__}: {e}"

    # -- streams ---------------------------------------------------------------
    def _hand_over(self, state: TableState, stream, mark: bool = True):
        """Publishable ``state`` built on ``stream``: wait for its kernels
        (this stream only) and mark its tensors as used by the server's other
        streams.  Returns the event readers wait on (None on the CPU)."""
        if stream is None:
            return None
        ready = torch.cuda.Event()
        ready.record(stream)
        ready.synchronize()
        if mark:
            self._mark_streams(state, stream)
        return ready

    def _mark_streams(self, state: TableState, stream) -> None:
        """``record_stream`` every tensor of ``state`` for the server's
        streams other than ``stream`` (its own)."""
        if stream is None:
            return
        for t in _state_tensors(state):
            for s in self._streams:
                if s is not stream:
                    t.record_stream(s)

    def _publish(self) -> Snapshot:
        return self.registry.publish(self._shadow, self._shadow_ready)

    def _empty_tombstones(self, now: int = 0):
        t = self.table
        return empty_tombstones(t.tombstone_capacity, now, device=t.device,
                                key_lanes=t.schema.key_lanes)

    # -- write path (admission) ----------------------------------------------
    def _admit(self, keys, values):
        """Host copies of one batch: packed keys and values (row ids when
        ``values`` is None, repeated across the schema's columns)."""
        schema = self.table.schema
        k = schema.pack_keys(keys, "cpu").numpy()
        n = k.shape[0]
        if values is None:
            values = np.arange(n, dtype=np.int32)
            if schema.value_cols > 1:
                values = np.stack([values] * schema.value_cols, axis=1)
        return k, schema.pack_values(values, "cpu").numpy()

    def _pad_insert(self, keys: np.ndarray, values: np.ndarray, bucket: Optional[int] = None):
        """Shard-align one host batch: EMPTY-pad keys, -1-pad values; with
        ``bucket`` all the way to that size (one delta geometry)."""
        n = keys.shape[0]
        pad = (-n) % self.table.num_devices if bucket is None else bucket - n
        if pad:
            keys = np.concatenate([keys, np.full((pad,) + keys.shape[1:], EMPTY_BITS, np.int32)])
            values = np.concatenate([values, np.full((pad,) + values.shape[1:], -1, np.int32)])
        return torch.from_numpy(keys), torch.from_numpy(values)

    def submit_insert(self, keys, values=None) -> None:
        """Queue one insert batch (applied by the writer loop); with
        ``write_bucket`` chunked to the bucket and each chunk padded to it."""
        self._check_leader()
        keys, values = self._admit(keys, values)
        wb = self.write_bucket
        if wb is None:
            ops = [self._pad_insert(keys, values)]
        else:
            ops = [
                self._pad_insert(keys[i : i + wb], values[i : i + wb], bucket=wb)
                for i in range(0, max(1, keys.shape[0]), wb)
            ]
        with self._lock:
            for k, v in ops:
                self._writes.append(("insert", k, v, None))

    def submit_delete(self, keys) -> None:
        """Queue one delete batch, chunked to at most half the tombstone
        capacity so the per-op policy check can escalate before a chunk
        could overflow the buffer."""
        self._check_leader()
        keys = torch.from_numpy(self.table.schema.pack_keys(keys, "cpu").numpy())
        chunk = max(1, self.table.tombstone_capacity // 2)
        with self._lock:
            for i in range(0, max(1, keys.shape[0]), chunk):
                self._writes.append(("delete", keys[i : i + chunk], None, None))

    def submit_upsert(self, keys, values=None, *, ttl: Optional[int] = None) -> None:
        """Queue one insert-or-replace batch: keep-last deduplicated at
        admission and chunked like inserts; each chunk applies as one delete
        of prior versions plus one bucket-padded delta.  ``ttl`` schedules
        expiry at ``now + ttl`` on the server's logical clock."""
        self._check_leader()
        kn, vn = self._admit(keys, values)
        rows = kn if kn.ndim == 2 else kn[:, None]
        _, first = np.unique(rows[::-1], axis=0, return_index=True)
        keep = np.sort(rows.shape[0] - 1 - first)
        keep = keep[~np.all(rows[keep] == EMPTY_BITS, axis=1)]
        if keep.shape[0] == 0:
            return
        keys, values = kn[keep], vn[keep]
        chunk = self.write_bucket or max(1, keys.shape[0])
        chunk = min(chunk, max(1, self.table.tombstone_capacity // 2))
        with self._lock:
            for i in range(0, keys.shape[0], chunk):
                self._writes.append(("upsert", keys[i : i + chunk], values[i : i + chunk], ttl))

    def advance(self, now) -> None:
        """Advance the serving logical clock to ``now`` and publish (a data
        field of the state: no structure change)."""
        with self._writer_mutex:
            self._check_leader()
            self._announce("write", {"kind": "advance", "now": int(now)})
            self._advance_body(now)

    def _advance_body(self, now) -> None:
        self._shadow = self._shadow.advance(now)
        self._publish()

    def pending(self) -> int:
        return len(self._writes)

    def step(self) -> int:
        """Apply up to ``window`` queued mutations to the shadow; publish.

        Returns the number of batches applied (0 while a background fold is
        in flight).  Runs the compaction policy before every mutation.  A
        window is popped at once and announced to the followers (across
        processes) before it applies; a failed write and those after it go
        back to the front of the queue and the error is re-raised.
        """
        if self.fold_in_flight or not self._writer_mutex.acquire(blocking=False):
            return 0
        try:
            self._check_leader()
            with self._lock:
                ops = [self._writes.popleft() for _ in range(min(self.window, len(self._writes)))]
            if not ops:
                return 0
            applied, err = 0, None
            with on_stream(self._write_stream), exchange.role("write"):
                try:
                    self._announce("write", {"kind": "ops", "ops": ops})
                except Exception as e:  # noqa: BLE001 - nothing applied: requeued below
                    err = e
                else:
                    applied, err = self._apply_ops(ops)
            if err is not None:
                # An acknowledged write never vanishes.
                with self._lock:
                    self._writes.extendleft(reversed(ops[applied:]))
                raise err
            return applied
        finally:
            self._writer_mutex.release()

    def _apply_ops(self, ops: list) -> tuple:
        """Apply a window of writes to the shadow, each after the policy's
        check, and publish.  Stops at the first failure (kept in
        ``last_error``): returns ``(applied, error or None)``, the applied
        prefix published."""
        applied, err = 0, None
        stats = None
        for kind, keys, values, ttl in ops:
            try:
                if stats is None:
                    stats = self._shadow.stats()
                if self.policy.due(stats):
                    self._fold_shadow()
                    stats = self._shadow.stats()
                if kind == "insert":
                    self._shadow = self._agreed(lambda: self.table.insert(
                        self._shadow, self._block(keys), self._block(values)))
                    stats = dataclasses.replace(stats, delta_depth=len(self._shadow.deltas))
                elif kind == "upsert":
                    self._shadow = self._agreed(lambda: self._upserted(keys, values, ttl))
                    stats = None  # delta depth and tombstones moved
                else:
                    self._shadow = self._agreed(lambda: self.table.delete(self._shadow, keys))
                    stats = None  # tombstone signals moved: re-read
            except Exception as e:  # noqa: BLE001 - returned to the caller
                self._last_error = f"{type(e).__name__}: {e}"
                err = e
                break
            self._c_writes_applied.inc()
            applied += 1
        if applied:
            self._shadow_ready = self._hand_over(self._shadow, self._write_stream)
            self._publish()
        return applied, err

    def _upserted(self, keys: np.ndarray, values: np.ndarray, ttl) -> TableState:
        """The shadow after one deduplicated upsert chunk: tombstone the real
        keys, insert the chunk padded to ``write_bucket`` (the warmed insert
        geometry; a rank inserts its block of it)."""
        real = torch.from_numpy(keys).to(self.table.device)
        shadow = self.table.delete(self._shadow, real)  # epoch d
        k_pad, v_pad = self._pad_insert(keys, values, bucket=self.write_bucket)
        shadow = self.table.insert(shadow, self._block(k_pad), self._block(v_pad))  # epoch d + 1
        if ttl is not None:
            ts = shadow.tombstones
            shadow = dataclasses.replace(
                shadow,
                tombstones=ts.push(real, epoch=len(shadow.deltas), expires=ts.now + int(ttl)),
            )
        return shadow

    # -- maintenance (off the read path) --------------------------------------
    def maintain(self) -> bool:
        """Fold the shadow now if the policy says it is due; publish.
        Returns True iff a fold ran."""
        if self.fold_in_flight or not self._writer_mutex.acquire(blocking=False):
            return False
        try:
            self._check_leader()
            if not self.policy.due(self._shadow_stats()):
                return False
            self._announce("write", {"kind": "maintain"})
            with exchange.role("write"):
                return self._maintain_body()
        finally:
            self._writer_mutex.release()

    def _maintain_body(self) -> bool:
        ran = self._fold_counts()
        self._fold_shadow()
        if self._fold_counts() == ran:
            return False  # due but nothing actionable: no phantom publish
        self._publish()
        return True

    def _shadow_stats(self) -> TableStats:
        with on_stream(self._write_stream):
            return self._shadow.stats()

    def _fold_shadow(self, background: bool = False) -> None:
        if self._fold_stream is not None:
            self._fold_stream.wait_stream(self._write_stream)
        with on_stream(self._fold_stream):
            stats = self._shadow.stats()
            escalate = self.policy.escalates(stats)
            layer_live = None
            if self.policy.fold_k is None and not escalate and stats.delta_depth:
                layer_live = maintenance.collect_layer_live(self._shadow)
            k = self.policy.fold_amount(stats, layer_live)
            if not escalate and not k:
                return
            # An incoherent shadow cannot fold locally: full compaction.
            if escalate or k >= stats.delta_depth or not self._shadow.coherent:
                self._apply_fold(self.table.compact, full=True, background=background)
            else:
                self._apply_fold(lambda s: maintenance.fold_oldest(s, k), full=False,
                                 background=background)

    def _fold_counts(self) -> tuple:
        return (self._c_folds.value, self._c_full_compacts.value)

    def _apply_fold(self, fold_fn, *, full: bool, background: bool = False) -> None:
        """Run one timed fold of the shadow on the fold stream, hand the
        result over and record it."""
        if self._fold_stream is not None:
            self._fold_stream.wait_stream(self._write_stream)
        with on_stream(self._fold_stream):
            start = end = None
            if self._fold_stream is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(self._fold_stream)
            t0 = time.perf_counter()
            rows_before = maintenance.allocated_rows(self._shadow)
            with counting.scoped() as scope:
                shadow = self._agreed(lambda: fold_fn(self._shadow))
            if full and self.write_bucket is not None:
                # compact() resets the tombstone buffer to zero capacity when
                # nothing was pending; shape-stable serving re-grows it
                # (clock kept).  A capacity-preserving remap of pending TTL
                # entries is kept as it is.
                ts = shadow.tombstones
                if ts.capacity != self.table.tombstone_capacity:
                    shadow = dataclasses.replace(shadow, tombstones=self._empty_tombstones(ts.now))
            if end is not None:
                end.record(self._fold_stream)
            ready = self._hand_over(shadow, self._fold_stream, mark=False)
            t_ready = time.perf_counter()
            self._mark_streams(shadow, self._fold_stream)
            self._shadow, self._shadow_ready = shadow, ready
            dt = time.perf_counter() - t0
        kind = "full" if full else "fold"
        self.fold_log.append(FoldRecord(
            kind=kind, background=background, t0=t0, t_ready=t_ready, t1=t0 + dt,
            rounds=scope.exchange_rounds, launches=dict(scope.launches), start=start, end=end,
        ))
        if not full and scope.exchange_rounds:
            self._c_fold_budget.inc()
        maintenance.record_fold(
            self.metrics_registry,
            kind=kind,
            seconds=dt,
            rows_before=rows_before,
            rows_after=maintenance.allocated_rows(self._shadow),
        )
        self._g_last_fold.set(dt)

    def fold_async(self, k: Optional[int] = None) -> threading.Thread:
        """Start one background fold of the shadow on its own thread and
        stream; reads keep flowing.  The fold holds the shadow-mutation
        mutex for its whole duration and publishes on completion.  Returns
        the thread."""
        if self.fold_in_flight:
            raise RuntimeError("a background fold is already in flight")
        self._check_leader()

        def run():
            try:
                self._bind_device()
                with self._writer_mutex, exchange.role("fold"):
                    self._check_leader()
                    self._announce("fold", {"kind": "fold", "k": k})
                    self._fold_body(k)
            except Exception as e:
                # Never silent: surfaced on stats().last_error and re-raised
                # by drain(); the read path keeps serving the last snapshot.
                self._fold_error = f"{type(e).__name__}: {e}"
                self._last_error = self._fold_error

        t = threading.Thread(target=run, name="serve-table-fold", daemon=True)
        self._fold_thread = t
        t.start()
        return t

    def _fold_body(self, k: Optional[int]) -> None:
        ran_before = self._fold_counts()
        if k is None:
            self._fold_shadow(background=True)
        else:
            kk = min(k, len(self._shadow.deltas))
            if kk <= 0:
                return
            if self._shadow.coherent and kk < len(self._shadow.deltas):
                self._apply_fold(lambda s: maintenance.fold_oldest(s, kk),
                                 full=False, background=True)
            else:  # fold-all or incoherent: full rebuild either way
                self._apply_fold(self.table.compact, full=True, background=True)
        if self._fold_counts() != ran_before:
            self._publish()

    @property
    def fold_in_flight(self) -> bool:
        t = self._fold_thread
        return t is not None and t.is_alive()

    # -- read path (never blocks on writes/folds) ------------------------------
    def current(self) -> Snapshot:
        """The snapshot reads execute against right now."""
        return self.registry.current()

    def dispatch_query(self, requests):
        """Enqueue one fused query of ``requests`` against the current
        snapshot (:meth:`MicroBatcher.dispatch_query`); the front end's
        dispatcher calls this.  Returns the ``PendingBatch``."""
        self._check_leader()
        with self._read_snapshot() as snap:
            pending = self.batcher.dispatch_query(snap.state, requests, seqno=snap.seqno,
                                                  ready=snap.ready)
            if self._lanes and pending.event is not None:
                with self._pin_lock:  # held past the return: see the module docstring
                    self._dispatched.append((snap.seqno, pending.event))
            return pending

    def query_many(self, requests) -> tuple[list, int]:
        """Merged multiplicities per request against the current snapshot:
        ``(results, seqno)``, every key of the batch read at that seqno."""
        self._check_leader()
        with self._read_snapshot() as snap:
            out = self.batcher.query_many(snap.state, requests, ready=snap.ready,
                                          seqno=snap.seqno)
        self._c_reads.inc(len(requests))
        self._c_read_batches.inc()
        return out, snap.seqno

    def retrieve_many(self, requests, *, per_layer_counts: bool = False):
        """Stored values per request key against the current snapshot:
        ``(results, seqno)``; see :meth:`MicroBatcher.retrieve_many`."""
        self._check_leader()
        with self._read_snapshot() as snap:
            out = self.batcher.retrieve_many(
                snap.state, requests, per_layer_counts=per_layer_counts, ready=snap.ready,
                seqno=snap.seqno)
        self._c_reads.inc(len(requests))
        self._c_read_batches.inc()
        return out, snap.seqno

    def query(self, keys) -> np.ndarray:
        """Single-request convenience wrapper over :meth:`query_many`."""
        return self.query_many([keys])[0][0]

    # -- AOT warmup ---------------------------------------------------------------
    def warm(self, **kwargs):
        """Warm the read-executor grid before admitting traffic; see
        :func:`repro_torch.serve_table.aot.warm_server`."""
        from repro_torch.serve_table.aot import warm_server

        return warm_server(self, **kwargs)

    # -- embedded writer loop ---------------------------------------------------
    def start(self, poll_interval: float = 0.001) -> None:
        """Run the writer loop on a daemon thread until :meth:`stop`; a write
        that fails stops the loop and surfaces as ``stats().last_error``."""
        if self._writer_thread is not None and self._writer_thread.is_alive():
            raise RuntimeError("writer loop already running")
        self._check_leader()
        self._stop.clear()

        def loop():
            self._bind_device()
            while not self._stop.is_set():
                try:
                    applied = self.step()
                except Exception:
                    self._stop.set()  # error is in stats().last_error
                    return
                if not applied:
                    time.sleep(poll_interval)

        self._writer_thread = threading.Thread(target=loop, name="serve-table-writer", daemon=True)
        self._writer_thread.start()

    def stop(self) -> None:
        """Stop the writer loop (queued writes stay queued).  Across
        processes rank 0 then sends stop on every role (after a fold in
        flight), the followers' :meth:`follow` returns and the server serves
        no more."""
        self._stop.set()
        if self._writer_thread is not None:
            self._writer_thread.join()
            self._writer_thread = None
        if not (self._lanes and self.leader) or self._closed:
            return
        if self._fold_thread is not None:
            self._fold_thread.join(timeout=self._timeout())
        try:
            with self._writer_mutex:
                for lane in ("write", "fold"):
                    self._announce(lane, {"kind": "stop"})
            with self.batcher._batch_lock:
                self._announce("read", {"kind": "stop"})
        finally:
            self._closed = True

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every queued write has been applied and published.

        Drives :meth:`step` inline without an embedded writer; joins folds
        in flight.  Raises ``TimeoutError`` (with the pending count) at
        ``timeout``, and ``RuntimeError`` at once if the embedded writer
        stops or a background fold failed.
        """
        deadline = time.monotonic() + timeout
        embedded = self._writer_thread is not None and self._writer_thread.is_alive()
        while True:
            if self._fold_error is not None:
                raise RuntimeError(f"background fold failed: {self._fold_error}")
            pending = self.pending()
            if not pending and not self.fold_in_flight and self._settled():
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain timed out with {pending} pending "
                    f"batch{'es' if pending != 1 else ''}"
                    + (" and a fold in flight" if self.fold_in_flight else "")
                )
            if self.fold_in_flight:
                t = self._fold_thread
                if t is not None:
                    t.join(timeout=min(0.05, max(0.0, deadline - time.monotonic())))
                continue
            writer_alive = self._writer_thread is not None and self._writer_thread.is_alive()
            if embedded and (self._stop.is_set() or not writer_alive):
                why = f"writer failed: {self._last_error}" if self._last_error else "server stopped"
                raise RuntimeError(
                    f"drain unblocked ({why}) with {pending} pending "
                    f"batch{'es' if pending != 1 else ''}"
                )
            if writer_alive:
                time.sleep(0.0005)
            else:
                self.step()

    def _settled(self) -> bool:
        """True once applied work is published, not merely dequeued."""
        if not self._writer_mutex.acquire(timeout=0.01):
            return False
        try:
            return not self.pending() and not self.fold_in_flight
        finally:
            self._writer_mutex.release()

    # -- metrics ----------------------------------------------------------------
    def stats(self) -> ServerStats:
        """A coherent host-side sample of every serving counter (one registry
        snapshot, plus the shadow's few-scalar stats)."""
        snap = self.metrics_registry.snapshot()
        hist_fold = snap.histogram("maintenance_fold_seconds", {"kind": "fold"})
        hist_full = snap.histogram("maintenance_fold_seconds", {"kind": "full"})
        fold_seconds = (hist_fold.sum if hist_fold else 0.0) + (hist_full.sum if hist_full else 0.0)
        return ServerStats(
            seqno=self.registry.seqno,
            pending_writes=self.pending(),
            writes_applied=int(snap.value("serve_writes_applied_total")),
            reads=int(snap.value("serve_reads_total")),
            read_batches=int(snap.value("serve_read_batches_total")),
            folds=int(snap.value("maintenance_folds_total", {"kind": "fold"})),
            full_compacts=int(snap.value("maintenance_folds_total", {"kind": "full"})),
            fold_seconds_total=fold_seconds,
            last_fold_seconds=float(snap.value("serve_last_fold_seconds", default=0.0)),
            fold_in_flight=self.fold_in_flight,
            skew_fallbacks=self.table.skew_fallbacks - self._skew_base,
            last_error=self._last_error,
            batcher=self.batcher.stats(snapshot=snap),
            shadow=self._shadow_stats(),
            warmup=self.batcher.executors.stats() if self.batcher.executors is not None else None,
        )

    def metrics(self, refresh: bool = True) -> RegistrySnapshot:
        """One atomic sample of the server's whole metrics registry; with
        ``refresh`` the state-derived gauges are re-read first.
        ``jit_dispatch_cache_size`` counts the plans the batcher built
        outside the AOT grid (flat once warmed: PyTorch has no jit cache)."""
        if refresh:
            reg = self.metrics_registry
            sh = self._shadow_stats()
            reg.gauge("serve_seqno", help="Last published snapshot seqno.").set(self.registry.seqno)
            reg.gauge("serve_pending_writes", help="Queued, not yet applied writes.").set(
                self.pending())
            reg.gauge("serve_fold_in_flight", help="1 while a background fold runs.").set(
                int(self.fold_in_flight))
            reg.gauge("serve_delta_depth", help="Live delta layers on the shadow.").set(
                sh.delta_depth)
            reg.gauge(
                "serve_dropped_rows",
                help="Rows lost to capacity anywhere in the stack (want 0).",
            ).set(sh.num_dropped)
            reg.gauge(
                "serve_tombstone_dropped", help="Deletes lost to tombstone capacity (want 0)."
            ).set(sh.tombstone_dropped)
            reg.gauge(
                "serve_skew_fallbacks", help="Inserts routed incoherent by the skew guard."
            ).set(self.table.skew_fallbacks - self._skew_base)
            reg.gauge(
                "jit_dispatch_cache_size",
                help="Plans built outside the AOT grid (flat once warmed).",
            ).set(len(self.batcher._qplans) + len(self.batcher._rplans))
        return self.metrics_registry.snapshot()
