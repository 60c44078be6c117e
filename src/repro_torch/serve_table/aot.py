"""AOT warmup — build the serving executor grid before the first request
(port of ``repro.serve_table.aot``).

The server admits reads on pow2-bucketed batch sizes and writes padded to a
fixed ``write_bucket``, so the (bucket, state structure) pairs live traffic
can reach are enumerable up front: the structure is fixed by the delta
depth, the (uniform) delta geometry, the tombstone buffer and how many
incremental folds have grown the base.

:func:`warm_server` walks that grid at server start and compiles one
:class:`~repro_torch.core.plans.CompiledPlan` per pair (PyTorch has no
program to compile: each compile runs the executor once against a prototype
state, which loads the kernel library and sizes the caching allocator's
blocks) and parks them in an :class:`ExecutorGrid` keyed as in the
reference by ``(kind, bucket, extra statics, state_signature)``.  A read
that misses the grid falls back to the batcher's plans and is counted.

Prototype states carry no real data: a **sentinel delta** (one insert of
``write_bucket`` EMPTY keys) has the geometry of any real write at that
bucket, so depth-``d`` prototypes are the base plus ``d`` references to it,
and fold-``f`` prototypes fold the sentinel stack ``f`` times.  The
reference compiles on a thread pool; the port warms the grid in order.

Across processes every rank calls :func:`warm_server` alike, before rank 0
takes traffic and the others :meth:`~TableServer.follow`: the sentinel
delta is built with the write role's collectives, the prototype folds with
the fold role's and each executor runs once with the read role's, so the
ranks warm the same grid in lock-step.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import torch

from repro_torch.core import exchange, maintenance
from repro_torch.core.hashgraph import EMPTY_BITS
from repro_torch.core.plans import CompiledPlan, state_signature
from repro_torch.core.state import TableState
from repro_torch.utils import on_stream


@dataclasses.dataclass(frozen=True)
class WarmupStats:
    """Coverage of the warmed executor grid (one coherent sample).

    ``entries`` is the number of compiled plans held; ``aot_hits`` /
    ``aot_misses`` count live read executions served by one vs falling back
    to the batcher's plans (a miss after warmup means traffic reached a
    structure outside the grid: widen ``depths``/``fold_horizon``/``buckets``).
    """

    write_bucket: int
    buckets: tuple  # read bucket sizes warmed
    depths: tuple  # delta depths warmed (at fold step 0)
    fold_horizon: int  # incremental folds whose post-fold bases are warmed
    entries: int  # compiled plans held
    compile_seconds: float  # wall-clock cost of the warmup pass
    aot_hits: int  # live executions served by a warmed plan
    aot_misses: int  # live executions that fell back to the batcher's plans
    profiles: tuple = ()  # ExecutorCost rows from the warmup profiling pass

    @property
    def coverage(self) -> float:
        total = self.aot_hits + self.aot_misses
        return self.aot_hits / total if total else 1.0


class ExecutorGrid:
    """Registry of warmed read executors, keyed by shape + structure:
    ``(kind, bucket, extra statics, state_signature(state))``."""

    def __init__(self):
        self._handles = {}
        self._retrieve_caps = {}  # bucket -> (out_cap, seg_cap) warmed caps
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._hit_counter = None
        self._miss_counter = None
        self.profiles: tuple = ()  # ExecutorCost rows (warmup profiling pass)
        self._meta = {
            "write_bucket": 0,
            "buckets": (),
            "depths": (),
            "fold_horizon": 0,
            "compile_seconds": 0.0,
        }

    def bind_registry(self, registry) -> None:
        """Mirror hit/miss counts into ``registry`` (carrying current counts)."""
        with self._lock:
            self._hit_counter = registry.counter(
                "aot_hits_total", help="Reads served by an AOT-warmed executable."
            )
            self._miss_counter = registry.counter(
                "aot_misses_total", help="Reads that fell back to the batcher's plans."
            )
            if self._hits:
                self._hit_counter.inc(self._hits)
            if self._misses:
                self._miss_counter.inc(self._misses)

    def __len__(self) -> int:
        return len(self._handles)

    def add(self, bucket: int, handle: CompiledPlan, extra: tuple = ()) -> None:
        key = (handle.kind, bucket, extra, handle.signature)
        with self._lock:
            self._handles[key] = handle

    def query_handle(self, state, bucket: int) -> Optional[CompiledPlan]:
        """The warmed query plan for this exact structure, or None (counted
        as a hit or a miss either way)."""
        return self._lookup(("query", bucket, (), state_signature(state)))

    def retrieve_handle(
        self, state, bucket: int, out_cap: int, seg_cap: int, per_layer: bool
    ) -> Optional[CompiledPlan]:
        return self._lookup(
            ("retrieve", bucket, (out_cap, seg_cap, per_layer), state_signature(state))
        )

    def _lookup(self, key) -> Optional[CompiledPlan]:
        with self._lock:
            h = self._handles.get(key)
            if h is None:
                self._misses += 1
                if self._miss_counter is not None:
                    self._miss_counter.inc()
            else:
                self._hits += 1
                if self._hit_counter is not None:
                    self._hit_counter.inc()
            return h

    def _peek(self, key) -> Optional[CompiledPlan]:
        """Uncounted lookup (warmup-internal; never a coverage signal)."""
        with self._lock:
            return self._handles.get(key)

    def cost_profile(self) -> tuple:
        """The warmup profiling pass's :class:`ExecutorCost` rows."""
        return self.profiles

    def retrieve_caps(self, bucket: int) -> Optional[tuple]:
        """The (out, seg) capacities retrieve was warmed with for a bucket."""
        return self._retrieve_caps.get(bucket)

    def stats(self) -> WarmupStats:
        with self._lock:
            return WarmupStats(
                write_bucket=self._meta["write_bucket"],
                buckets=tuple(self._meta["buckets"]),
                depths=tuple(self._meta["depths"]),
                fold_horizon=self._meta["fold_horizon"],
                entries=len(self._handles),
                compile_seconds=self._meta["compile_seconds"],
                aot_hits=self._hits,
                aot_misses=self._misses,
                profiles=self.profiles,
            )


def _sentinel_batch(table, n: int):
    """An all-EMPTY insert batch: real geometry, no visible rows."""
    schema = table.schema
    lanes = schema.key_lanes
    n = n * table.group.local // table.num_shards  # this caller's rows of it
    kshape = (n,) if lanes == 1 else (n, lanes)
    vshape = (n,) if schema.value_cols == 1 else (n, schema.value_cols)
    keys = torch.full(kshape, EMPTY_BITS, dtype=torch.int32, device=table.device)
    values = torch.full(vshape, -1, dtype=torch.int32, device=table.device)
    return keys, values


def warm_server(
    server,
    *,
    buckets: Optional[Sequence[int]] = None,
    depths: Optional[Sequence[int]] = None,
    fold_horizon: int = 1,
    retrieve_caps=None,
    per_layer_counts: Sequence[bool] = (False,),
    profile: bool = True,
) -> WarmupStats:
    """Warm the server's whole reachable read-executor grid.

    * ``buckets`` — read batch sizes (default: the batcher's ``min_bucket``
      and the next two doublings).
    * ``depths`` — delta depths warmed at fold step 0 (default: every depth
      the compaction policy lets the writer reach).
    * ``fold_horizon`` — incremental folds ahead: each grows the base, a
      new structure; post-fold steps warm depths ``trigger-fold_k..trigger``.
      Treated as 0 when the policy never folds incrementally.
    * ``retrieve_caps`` — ``(out, seg)`` or ``{bucket: (out, seg)}`` to warm
      retrieve executors too (queries only by default).
    * ``per_layer_counts`` — which retrieve variants to warm: the
      reference's ``(False,)``, or ``(False, True)`` for a server that also
      serves ``retrieve_many(per_layer_counts=True)``.
    * ``profile`` — one :class:`~repro_torch.obs.profiling.ExecutorCost` per
      (kind, depth) at the smallest bucket: the exchange rounds and bytes of
      one run, on ``grid.cost_profile()`` and as registry gauges.

    Attaches the :class:`ExecutorGrid` to the server's batcher and returns
    its :class:`WarmupStats`.  Holds the server's writer mutex and batch
    lock throughout (no write, fold or read interleaves).
    """
    with server._writer_mutex, server.batcher._batch_lock:
        return _warm(server, buckets, depths, fold_horizon, retrieve_caps, per_layer_counts,
                     profile)


def _warm(server, buckets, depths, fold_horizon, retrieve_caps, per_layer_counts, profile):
    table = server.table
    if server.write_bucket is None:
        raise ValueError(
            "AOT warmup needs a shape-stable write path: construct the "
            "TableServer with write_bucket=<pow2> so every insert delta "
            "shares one geometry"
        )
    t0 = time.perf_counter()
    state0 = server.current().state
    policy = server.policy
    trigger = policy.max_delta_depth
    if trigger is None or trigger > table.max_deltas:
        trigger = table.max_deltas
    pfk = 1 if policy.fold_k is None else policy.fold_k
    fold_k = min(max(1, pfk), max(1, trigger - 1))
    folds_incremental = trigger is not None and pfk < trigger
    if not folds_incremental:
        fold_horizon = 0  # escalations full-compact: geometry is data-sized

    if buckets is None:
        b0 = server.batcher.min_bucket
        buckets = (b0, b0 * 2, b0 * 4)
    buckets = tuple(sorted({server.batcher.bucket_size(int(b)) for b in buckets}))
    if depths is None:
        depths = range(0, trigger + 1)
    depths = tuple(sorted({int(d) for d in depths if 0 <= d <= table.max_deltas}))
    if isinstance(retrieve_caps, tuple):
        retrieve_caps = {b: retrieve_caps for b in buckets}
    retrieve_caps = retrieve_caps or {}

    # The sentinel delta is built on the writer's stream and the prototype
    # folds run on the fold stream, as the live writes and folds will: the
    # caching allocator then holds blocks of their sizes in those streams'
    # pools, so a live fold takes no new device memory (a cudaMalloc, which
    # serialises with the streams' work) while reads flow.
    write_stream, fold_stream = server._write_stream, server._fold_stream

    with on_stream(write_stream), exchange.role("write"):
        keys, values = _sentinel_batch(table, server.write_bucket)
        delta = table.insert(state0, keys, values).deltas[-1]
    if write_stream is not None:
        write_stream.synchronize()

    def proto(base, depth) -> TableState:
        return dataclasses.replace(state0, base=base, deltas=(delta,) * depth, coherent=True)

    protos = []  # (fold_step, depth, state)
    base = state0.base
    for f in range(fold_horizon + 1):
        dd = depths if f == 0 else tuple(range(max(0, trigger - fold_k), trigger + 1))
        for d in dd:
            protos.append((f, d, proto(base, d)))
        if f < fold_horizon:
            # The next fold step's base: fold fold_k sentinel deltas in.
            with on_stream(fold_stream), exchange.role("fold"):
                base = maintenance.fold_oldest(proto(base, fold_k), fold_k).base
            if fold_stream is not None:
                fold_stream.synchronize()

    # The executors run on the read stream, like live reads.
    stream = server.batcher.stream
    with on_stream(stream), exchange.role("read"):
        grid = ExecutorGrid()
        for _, _, st in protos:
            for b in buckets:
                grid.add(b, table.plan_query(num_queries=b).compile(st))
                caps = retrieve_caps.get(b)
                if caps is None:
                    continue
                out_cap, seg_cap = int(caps[0]), int(caps[1])
                for per_layer in per_layer_counts:
                    rp = table.plan_retrieve(num_queries=b, out_capacity=out_cap,
                                             seg_capacity=seg_cap,
                                             per_layer_counts=bool(per_layer))
                    grid.add(b, rp.compile(st), extra=(out_cap, seg_cap, bool(per_layer)))
        for b, caps in retrieve_caps.items():
            grid._retrieve_caps[int(b)] = (int(caps[0]), int(caps[1]))
        if profile:
            grid.profiles = _profile_grid(table, grid, protos, buckets, retrieve_caps)
        if stream is not None:
            stream.synchronize()

    grid._meta.update(
        write_bucket=server.write_bucket,
        buckets=buckets,
        depths=depths,
        fold_horizon=fold_horizon,
        compile_seconds=time.perf_counter() - t0,
    )
    registry = getattr(server, "metrics_registry", None)
    if registry is not None:
        grid.bind_registry(registry)
        registry.gauge("aot_entries", help="Compiled executables held by the AOT grid.").set(
            len(grid))
        registry.gauge("aot_compile_seconds", help="Wall-clock cost of the last warmup.").set(
            time.perf_counter() - t0)
        for cost in grid.profiles:
            labels = {"kind": cost.kind, "bucket": cost.bucket, "depth": cost.depth}
            registry.gauge(
                "executor_all_to_alls",
                labels=labels,
                help="Exchange rounds per executor run (counted on its thread).",
            ).set(cost.all_to_alls)
            registry.gauge(
                "executor_collective_bytes",
                labels=labels,
                help="Per-shard bytes moved through the exchange per call.",
            ).set(cost.total_collective_bytes)
    server.batcher.executors = grid
    # Seed the batcher's retrieve working caps so warmed buckets skip the
    # planning round and land on the warmed plans.
    for b, caps in grid._retrieve_caps.items():
        server.batcher._caps.setdefault(b, caps)
    return grid.stats()


def _profile_grid(table, grid, protos, buckets, retrieve_caps) -> tuple:
    """One :class:`ExecutorCost` per (kind, depth) structure at the smallest
    bucket (fold step 0): the rounds do not depend on the fold step."""
    from repro_torch.core.plans import _proto_queries
    from repro_torch.obs.profiling import profile_executor

    b0 = buckets[0]
    q = _proto_queries(table, b0)
    costs = []
    seen = set()
    for f, d, st in protos:
        if f != 0 or d in seen:
            continue
        seen.add(d)
        sig = state_signature(st)
        costs.append(profile_executor(
            table, st, q, kind="query", compiled=grid._peek(("query", b0, (), sig))
        ))
        caps = retrieve_caps.get(b0)
        if caps is not None:
            out_cap, seg_cap = int(caps[0]), int(caps[1])
            costs.append(profile_executor(
                table, st, q, kind="retrieve",
                compiled=grid._peek(("retrieve", b0, (out_cap, seg_cap, False), sig)),
                exec_kwargs={"out_capacity": out_cap, "seg_capacity": seg_cap},
            ))
    return tuple(costs)


__all__ = ["ExecutorGrid", "WarmupStats", "warm_server"]
