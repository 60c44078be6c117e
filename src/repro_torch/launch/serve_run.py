"""The table server's pass: rank 0 serves live traffic through
``AsyncFrontend`` while the other ranks follow, or one process serves it
over a stacked table.

:func:`run_server` builds a ``TableServer`` on ``n_keys`` uniform keys
(values: global row ids), warms its grid, then on the leader runs reader
threads of ragged query requests through the front end, a retrieve thread,
and one writer: ``inserts`` batches of ``write_bucket`` keys, a background
``fold_async(2)`` while the reads run, a delete, an upsert with a TTL
and the clock past it.  Every response is held against a numpy oracle at
the seqno it reports; every read execution's exchange rounds against the
budget.  A follower runs ``server.follow()`` until the leader stops.

Each rank returns its counters (read executions, writes, folds, seqno,
this process's reductions: ``agree``, ``broadcast``, ``all_gather``, ...),
the mutations it applied (rank 0's log, which :func:`replay` applies to a
stacked server) and its final shadow's blocks through a sink, so the
caller holds rank ``r``'s shadow against row ``r`` of the replay.  The
data is drawn from ``seed`` with numpy, the whole of it in every process.
The module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import exchange
from repro_torch.core.table import DistributedHashTable
from repro_torch.launch.table_run import Sink
from repro_torch.serve_table import AsyncFrontend, CompactionPolicy, MicroBatcher, TableServer

# The serve-table phase's server: slack 2.0 (a read batch's keys a dispatch
# slot stay 7 sigma below it at D = 8), folds of 2 deltas two steps ahead in
# the grid, and the upsert's TTL.  The policy's trigger is the inserts' depth
# (4): the background fold of 2 then lands on a structure the grid warmed (a
# fold step's depths run from the trigger less 2 to the trigger).
SLACK, FOLD_K, FOLD_HORIZON, TTL, MAX_DELTA_DEPTH = 2.0, 2, 2, 5, 4


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One server pass (global counts)."""

    n_keys: int
    seed: int = 0
    write_bucket: int = 1 << 16
    tombstones: int = 1 << 15
    buckets: tuple = (1024, 2048, 4096)  # warmed read buckets; the first is min_bucket
    readers: int = 4
    requests: int = 128  # query requests a reader
    req_sizes: tuple = (4, 256)
    retrieves: int = 8  # retrieve_many calls of 4 requests
    inserts: int = 4
    hot_repeats: int = 512  # copies of one absent key in every insert
    deletes: int = 1 << 12
    upserts: int = 1 << 12
    fold_pause_s: float = 0.0  # hold each fold this long first (reads start in the hold)


def make_data(cfg: ServeConfig) -> dict:
    """The pass's global arrays: the base keys, each reader's requests and
    the retrieve groups (90 % base keys, 10 % absent), the write stream."""
    n = cfg.n_keys
    if cfg.deletes > cfg.tombstones // 2 or cfg.upserts > min(cfg.write_bucket,
                                                              cfg.tombstones // 2):
        raise ValueError("each delete and upsert must apply as one chunk")
    rng = np.random.default_rng(cfg.seed + 2100)
    keys = rng.integers(0, n, size=n, dtype=np.uint32)
    hot = np.uint32(n + 7)

    def requests(r, count):
        out = []
        for size in r.integers(cfg.req_sizes[0], cfg.req_sizes[1] + 1, size=count):
            req = keys[r.integers(0, n, size=size)].astype(np.uint32)
            far = r.integers(n + 1024, 2**32 - 2, size=size, dtype=np.uint64).astype(np.uint32)
            absent = r.random(size) < 0.1
            req[absent] = far[absent]
            out.append(req)
        return out

    readers = [requests(np.random.default_rng(cfg.seed + 31 * i), cfg.requests)
               for i in range(cfg.readers)]
    groups = requests(np.random.default_rng(cfg.seed + 977), 4 * cfg.retrieves)
    writes = []
    for i in range(cfg.inserts):
        k = rng.integers(0, n, size=cfg.write_bucket, dtype=np.uint32)
        k[rng.choice(cfg.write_bucket, min(cfg.hot_repeats, cfg.write_bucket), replace=False)] = hot
        writes.append(("insert", k, ((1 << 28) + i * cfg.write_bucket
                                     + np.arange(cfg.write_bucket)).astype(np.int32)))
    present = np.unique(keys[rng.choice(n, 2 * (cfg.deletes + cfg.upserts), replace=False)])
    present = rng.permutation(present)[: cfg.deletes + cfg.upserts]
    writes.append(("delete", present[: cfg.deletes], None))
    ups = present[cfg.deletes:]
    writes.append(("upsert", ups, ((1 << 29) + np.arange(ups.shape[0])).astype(np.int32)))
    writes.append(("expire", ups, None))  # the clock past the upsert's TTL
    return {"keys": keys, "readers": readers, "groups": [groups[i: i + 4] for i in
                                                         range(0, len(groups), 4)],
            "writes": writes}


class Oracle:
    """numpy reference of the served table after each prefix of the write
    stream: the base's counts by ``bincount`` (keys in [0, N), values the
    row ids; the rows of the retrieved keys in one stable sort), then the
    inserts, the delete, the upsert and its expiry."""

    def __init__(self, data: dict, n_keys: int):
        keys = data["keys"]
        self.n = n_keys
        self.tally = np.bincount(keys, minlength=n_keys).astype(np.int64)
        wanted = np.concatenate([k for g in data["groups"] for k in g])
        mask = np.zeros(n_keys, bool)
        mask[wanted[wanted < n_keys]] = True
        rows = np.flatnonzero(mask[keys])
        order = np.argsort(keys[rows], kind="stable")
        self.sorted_keys, self.rows = keys[rows][order], rows[order].astype(np.int64)
        self.ops = []
        for kind, k, v in data["writes"]:
            o = np.argsort(k, kind="stable")
            self.ops.append((kind, k[o], None if v is None else v[o]))

    @staticmethod
    def _runs(sorted_keys, q):
        lo = np.searchsorted(sorted_keys, q, "left")
        return lo, np.searchsorted(sorted_keys, q, "right") - lo

    def count(self, q, applied: int) -> np.ndarray:
        inside = q < self.n
        c = np.where(inside, self.tally[np.where(inside, q, 0)], 0)
        for kind, keys, _ in self.ops[:applied]:
            hit = self._runs(keys, q)[1]
            if kind == "insert":
                c = c + hit
            elif kind == "upsert":
                c = np.where(hit > 0, 1, c)
            else:  # delete, expire
                c = np.where(hit > 0, 0, c)
        return c

    def values(self, k, applied: int) -> list:
        lo, n = self._runs(self.sorted_keys, k)
        vals = list(self.rows[lo: lo + n])
        for kind, keys, v in self.ops[:applied]:
            lo, n = self._runs(keys, k)
            if kind == "insert":
                vals += list(v[lo: lo + n])
            elif n:
                vals = list(v[lo: lo + n]) if kind == "upsert" else []
        return sorted(int(x) for x in vals)


def make_server(cfg: ServeConfig, *, group=None, num_shards: int = 1, device=None,
                keys=None) -> TableServer:
    """The pass's server on ``keys`` (default: the pass's base), of which it
    takes the whole stacked, or this rank's block."""
    kw = dict(hash_range=cfg.n_keys, device=device, tombstone_capacity=cfg.tombstones,
              capacity_slack=SLACK)
    table = DistributedHashTable(group=group, **kw) if group is not None else \
        DistributedHashTable(num_shards=num_shards, **kw)
    if keys is None:
        keys = make_data(cfg)["keys"]
    m = keys.shape[0] // table.num_shards
    keys = keys[table.group.rank * m: (table.group.rank + table.group.local) * m]
    return TableServer(table, keys, write_bucket=cfg.write_bucket,
                       policy=CompactionPolicy(max_delta_depth=MAX_DELTA_DEPTH, fold_k=FOLD_K),
                       batcher=MicroBatcher(table, min_bucket=cfg.buckets[0]))


def _pause_folds(server: TableServer, seconds: float, held: threading.Event) -> None:
    """Hold each fold ``seconds`` once it has begun (its window open), and
    set ``held`` then."""
    real = server._apply_fold

    def paused(fold_fn, **kw):
        def slow(state):
            held.set()
            time.sleep(seconds)
            return fold_fn(state)

        return real(slow, **kw)

    server._apply_fold = paused


def _log_reads(server: TableServer) -> list:
    """Log each read execution's kind, batch and state (depth, clock,
    tombstones) on this rank: every rank's log must be rank 0's."""
    reads, batcher = [], server.batcher

    def logged(kind, real):
        def run(st, q, *args):
            reads.append((kind, int(q.shape[0]), len(st.deltas), st.now, st.tombstones.count))
            return real(st, q, *args)
        return run

    batcher._query_batch = logged("query", batcher._query_batch)
    batcher._retrieve_batch = logged("retrieve", batcher._retrieve_batch)
    return reads


def _host(rec: dict) -> dict:
    """A mutation record with its tensors as numpy (to leave the process)."""
    out = {k: v for k, v in rec.items() if k not in ("mseq", "floor")}
    if "ops" in out:
        out["ops"] = [tuple(x.numpy() if isinstance(x, torch.Tensor) else x for x in op)
                      for op in out["ops"]]
    return out


def _device_ops(rec: dict) -> dict:
    """:func:`_host`'s inverse for the ops the server keeps as tensors."""
    if "ops" not in rec:
        return rec
    ops = []
    for kind, keys, values, ttl in rec["ops"]:
        if kind in ("insert", "delete"):
            keys = torch.from_numpy(keys)
            values = None if values is None else torch.from_numpy(values)
        ops.append((kind, keys, values, ttl))
    return {**rec, "ops": ops}


def put_state(sink: Sink, tag: str, state) -> None:
    """A state's blocks: every layer's CSR arrays, then the tombstones."""
    for i, layer in enumerate(state.layers):
        for f in ("offsets", "keys", "values"):
            sink.put(f"{tag}.layer{i}.{f}", getattr(layer.local, f))
        sink.scalar(f"{tag}.layer{i}.num_dropped", int(layer.num_dropped))
    ts = state.tombstones
    sink.scalar(f"{tag}.tombstones", [ts.count, ts.num_dropped, ts.now, bool(state.coherent)])
    for f in ("keys", "epochs", "expires"):
        sink.scalar(f"{tag}.tombstones.{f}", getattr(ts, f).cpu().numpy().tolist())


def run_server(cfg: ServeConfig, sink: Sink, *, group=None, num_shards: int = 1,
               device=None) -> dict:
    """One server pass (module docstring) on this process: the leader's
    traffic and checks, or a follower's loop.  Returns this rank's result."""
    data = make_data(cfg)
    reductions0 = collections.Counter(exchange.REDUCTIONS)
    t0 = time.perf_counter()
    server = make_server(cfg, group=group, num_shards=num_shards, device=device,
                         keys=data["keys"])
    table = server.table
    d, local, rank = table.num_shards, table.group.local, table.group.rank
    build_s = time.perf_counter() - t0
    # Retrieve caps per bucket from one counts round of base keys, 2x headroom.
    state0 = server.current().state
    caps, rng = {}, np.random.default_rng(cfg.seed + 5)
    for b in cfg.buckets:
        sample = data["keys"][rng.integers(0, cfg.n_keys, size=b)]
        m = b // d
        seg, out = table.plan_caps(state0, sample[rank * m: (rank + local) * m])
        caps[b] = (1 << (2 * out - 1).bit_length(), 1 << (2 * seg - 1).bit_length())
    del state0
    t1 = time.perf_counter()
    warm = server.warm(buckets=cfg.buckets, depths=range(MAX_DELTA_DEPTH + 1),
                       fold_horizon=FOLD_HORIZON, retrieve_caps=caps)
    warm_s = time.perf_counter() - t1
    held = threading.Event() if cfg.fold_pause_s else None
    if held is not None:
        _pause_folds(server, cfg.fold_pause_s, held)
    reads = _log_reads(server)
    log = []  # the mutations this rank applied, in order
    result = {"rank": rank, "world": d if group is not None else 1, "build_s": build_s,
              "warm_s": warm_s, "grid_entries": warm.entries}
    if group is not None and rank != 0:
        real = server._apply_record

        def logged(rec):
            log.append(_host(rec))
            return real(rec)

        server._apply_record = logged
        t2 = time.perf_counter()
        server.follow()
        result["serve_s"] = time.perf_counter() - t2
    else:
        result.update(_lead(cfg, server, data, log, held))
    st = server.stats()
    result.update(seqno=server.registry.seqno, read_batches=st.batcher.batches,
                  writes_applied=st.writes_applied, folds=st.folds,
                  full_compacts=st.full_compacts, last_error=st.last_error,
                  budget_misses=int(server.metrics().value("batch_exchange_budget_misses_total")),
                  fold_budget_misses=int(server.metrics().value(
                      "maintenance_fold_budget_misses_total")),
                  log=log, reads=reads, num_dropped=st.shadow.num_dropped,
                  reductions=dict(collections.Counter(exchange.REDUCTIONS) - reductions0))
    put_state(sink, "shadow", server._shadow)
    return result


def _lead(cfg: ServeConfig, server: TableServer, data: dict, log: list,
          held: Optional[threading.Event] = None) -> dict:
    """Rank 0 (or a stacked server): the traffic and its checks.  With
    ``held`` (folds paused) the readers' second half starts once the fold
    is held, so reads run while it is in flight whatever the host's speed."""
    real_announce = server._announce

    def announced(lane, rec):
        if rec["kind"] in ("ops", "maintain", "fold", "advance"):
            log.append(_host(rec))
        return real_announce(lane, rec)

    server._announce = announced
    oracle = Oracle(data, cfg.n_keys)
    applied_at = {0: 0}  # seqno -> writes applied when it was published
    real_publish = server.registry.publish
    expired = {"at": None}

    def publish(state, ready=None):
        snap = real_publish(state, ready)
        n = int(server.metrics_registry.snapshot().value("serve_writes_applied_total"))
        applied_at[snap.seqno] = n + (1 if expired["at"] is not None
                                      and state.now >= expired["at"] else 0)
        return snap

    server.registry.publish = publish
    fe = AsyncFrontend(server, linger=0.002, flush_keys=cfg.buckets[-1], write_backlog=64)
    phase2 = threading.Event()
    errors, responses, retrieved = [], [], []
    lock = threading.Lock()
    fold_window = {}

    def reader(i):
        try:
            prng = np.random.default_rng(cfg.seed + 5000 + i)
            reqs = data["readers"][i]
            for j, req in enumerate(reqs):
                if j == len(reqs) // 2 and not phase2.wait(300):
                    raise TimeoutError("the inserts never published")
                t_sub = time.perf_counter()
                fut = fe.submit_query(req, timeout=60)
                fut.add_done_callback(lambda f, req=req, t_sub=t_sub: responses.append(
                    (req, f, t_sub, time.perf_counter())))
                time.sleep(prng.exponential(0.006))
        except Exception as e:  # noqa: BLE001 - reported below
            with lock:
                errors.append(f"reader {i}: {type(e).__name__}: {e}")

    def retriever():
        try:
            for j, group in enumerate(data["groups"]):
                if j == len(data["groups"]) // 2 and not phase2.wait(300):
                    raise TimeoutError("the inserts never published")
                res, seqno = server.retrieve_many(group)
                retrieved.append((group, res, seqno))
                time.sleep(0.01)
        except Exception as e:  # noqa: BLE001
            with lock:
                errors.append(f"retrieve: {type(e).__name__}: {e}")

    def writer():
        try:
            inserts = [w for w in data["writes"] if w[0] == "insert"]
            for _, k, v in inserts:
                fe.submit_insert(k, v, timeout=300)
            deadline = time.monotonic() + 300
            while len(server.current().state.deltas) < len(inserts):
                if time.monotonic() > deadline or server._last_error is not None:
                    raise RuntimeError(f"the inserts did not publish ({server._last_error})")
                time.sleep(0.001)
            if held is None:
                phase2.set()
            fold_window["t0"] = time.perf_counter()
            fold = server.fold_async(FOLD_K)
            if held is not None:
                held.wait(300)
                phase2.set()
            fold.join(timeout=300)
            fold_window["t1"] = time.perf_counter()
            for kind, k, v in data["writes"][len(inserts):]:
                if kind == "delete":
                    fe.submit_delete(k, timeout=300)
                elif kind == "upsert":
                    fe.submit_upsert(k, v, ttl=TTL, timeout=300)
            server.drain(timeout=300)
            expired["at"] = server.current().state.now + TTL
            server.advance(expired["at"])
        except Exception as e:  # noqa: BLE001
            with lock:
                errors.append(f"writer: {type(e).__name__}: {e}")
            phase2.set()

    server.start()
    t0 = time.perf_counter()
    fe.start()
    threads = [threading.Thread(target=reader, args=(i,), name=f"pass-reader-{i}")
               for i in range(cfg.readers)]
    threads += [threading.Thread(target=retriever, name="pass-retrieve"),
                threading.Thread(target=writer, name="pass-writer")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    alive = [t.name for t in threads if t.is_alive()]
    server.drain(timeout=300)
    fe.stop()
    traffic_s = time.perf_counter() - t0
    server.stop()  # across processes: stop goes out on every role

    bad, keys_served, samples = 0, 0, []
    for req, fut, _, _ in responses:
        r = fut.result()
        keys_served += req.shape[0]
        applied = applied_at.get(r.seqno)
        if applied is None or not np.array_equal(r.counts, oracle.count(req, applied)):
            bad += 1
            if len(samples) < 8:  # which prefix of the writes the counts match, if any
                samples.append({"seqno": r.seqno, "applied": applied, "keys": int(req.shape[0]),
                                "wrong": int((r.counts != oracle.count(req, applied or 0)).sum()),
                                "matches": [a for a in range(len(data["writes"]) + 1) if
                                            np.array_equal(r.counts, oracle.count(req, a))]})
    for group, res, seqno in retrieved:
        for req, vals in zip(group, res):
            for k, v in zip(req, vals):
                got = sorted(np.asarray(v).tolist())
                if got != oracle.values(k, applied_at[seqno]):
                    bad += 1
                    if len(samples) < 16:
                        samples.append({"seqno": seqno, "applied": applied_at[seqno],
                                        "key": int(k), "got": got[:4],
                                        "want": oracle.values(k, applied_at[seqno])[:4]})
    timeline = list(server.batcher.timeline)
    folds = list(server.fold_log)
    during = [r for f in folds for r in timeline if r.t0 < f.t_ready and r.t1 > f.t0]
    lat_ms = sorted((t1 - t0) * 1e3 for _, _, t0, t1 in responses)
    fst = fe.stats()
    return {"errors": errors + [f"thread {n} did not finish" for n in alive],
            "responses": len(responses), "retrieved": len(retrieved), "bad": bad,
            "bad_samples": samples,
            "keys_served": keys_served, "requests": cfg.readers * cfg.requests,
            "failed": fst.failed, "completed": fst.completed,
            "writes": len(data["writes"]), "applied_final": applied_at[server.registry.seqno],
            "rounds": sorted({(r.rounds, r.budget) for r in timeline}),
            "fold_rounds": [(f.kind, f.rounds) for f in folds],
            "reads_during_folds": len(during),
            "aot_misses": server.stats().warmup.aot_misses,
            "traffic_s": traffic_s, "fold_s": fold_window.get("t1", 0) - fold_window.get("t0", 0),
            "latency_ms": {"p50": lat_ms[len(lat_ms) // 2] if lat_ms else None,
                           "p99": lat_ms[int(len(lat_ms) * 0.99)] if lat_ms else None}}


def replay(cfg: ServeConfig, log: list, num_shards: int, device=None,
           sink: Optional[Sink] = None) -> TableServer:
    """A stacked server of ``num_shards`` shards built as the pass builds
    its own, with rank 0's mutation log applied in order (no warm-up, no
    traffic); its shadow's blocks go to ``sink``."""
    server = make_server(cfg, num_shards=num_shards, device=device)
    for rec in log:
        server._apply_record(_device_ops(rec))
    if server._last_error is not None:
        raise RuntimeError(f"the replay failed: {server._last_error}")
    if sink is not None:
        put_state(sink, "shadow", server._shadow)
    return server
