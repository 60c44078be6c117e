"""The port's table server against the JAX package's, and on its own against
numpy oracles.

* One scripted synchronous sequence through both packages' ``TableServer``
  at D = 1 and D = 8 (inserts, a delete, an upsert, ``step``,
  ``query_many``, ``retrieve_many(per_layer_counts=True)``, a joined
  ``fold_async`` and a policy fold): seqnos, counts, retrieve lists, layer
  counts and every non-time field of ``ServerStats`` are equal.
* ``warm_server`` on the README's smallest grid (buckets (8, 16), depths
  0–2, fold horizon 2): the same ``WarmupStats`` and grid keys as the
  reference's (``profile=False`` there: its jaxpr walk fails on jax 0.9).
* The ``DeadlineBatcher`` property schedule under a fake clock through both
  packages: identical batches at identical times.
* The port alone: the reference's server cases whose reference path fails
  on jax 0.9 (a delete after a fold reaches a sharding error in the
  reference's tombstone push, as
  ``test_serve_table::test_server_maintenance_folds_and_stays_consistent``
  does), held against a numpy oracle instead; reads during a background
  fold; the async stress of ``tests/test_serve_async.py`` against a numpy
  oracle per seqno; writer- and fold-crash cases; the drain contract.

Tolerance: none; every output is an integer.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax

import repro.serve_table as jserve
from repro.core import table as jtable
from repro_torch import DistributedHashTable
import repro_torch.serve_table as pserve
from repro_torch.serve_table import CompactionPolicy, MicroBatcher, TableServer
from test_table_state import Oracle, _value_rows
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

MESHES = pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()


def _mesh(request, d):
    return request.getfixturevalue("mesh1" if d == 1 else "mesh8")


def _tables(mesh, d, **kw):
    return (jtable.DistributedHashTable(mesh, ("d",), **kw),
            DistributedHashTable(num_shards=d, device="cpu", **kw))


def _rows(lists):
    return [[sorted(_value_rows(np.asarray(v)), key=repr) for v in req] for req in lists]


def _stats_fields(st) -> dict:
    """Every ServerStats field but the times (and the warmup's)."""
    d = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    for name in ("fold_seconds_total", "last_fold_seconds", "warmup"):
        d.pop(name)
    d["batcher"] = dataclasses.asdict(d["batcher"])
    d["shadow"] = dataclasses.asdict(d["shadow"])
    return d


# ---------------------------------------------------------------------------
# The scripted sequence through both packages
# ---------------------------------------------------------------------------


@MESHES
def test_scripted_sequence_matches_reference(d, request):
    jt, pt = _tables(_mesh(request, d), d, hash_range=1 << 12, max_deltas=4,
                     tombstone_capacity=64)
    rng = np.random.default_rng(17 + d)
    keys = rng.integers(0, 1 << 13, 256, dtype=np.uint32)
    vals = np.arange(256, dtype=np.int32)
    policy = dict(max_delta_depth=3, fold_k=2)
    servers = [
        jserve.TableServer(jt, keys, vals, policy=jserve.CompactionPolicy(**policy),
                           batcher=jserve.MicroBatcher(jt, min_bucket=16), window=2),
        TableServer(pt, keys, vals, policy=CompactionPolicy(**policy),
                    batcher=MicroBatcher(pt, min_bucket=16), window=2),
    ]
    new = [rng.integers(1 << 13, 1 << 14, 8 * d, dtype=np.uint32) for _ in range(5)]
    reqs = [keys[:7], new[0][:3], np.concatenate([new[1], keys[10:20]]), new[3][:5]]

    def reads(tag):
        out = []
        for s in servers:
            counts, seq_q = s.query_many(reqs)
            res, seq_r = s.retrieve_many(reqs, per_layer_counts=True)
            out.append((seq_q, seq_r, [c.tolist() for c in counts],
                        _rows([v for v, _ in res]), [lc.tolist() for _, lc in res]))
        assert out[1] == out[0], tag

    def both(fn):
        return [fn(s) for s in servers]

    reads("seqno 0")
    both(lambda s: s.submit_insert(new[0], np.arange(8 * d, dtype=np.int32) + 1000))
    both(lambda s: s.submit_delete(keys[:4]))
    both(lambda s: s.submit_insert(new[1]))
    assert both(lambda s: s.pending()) == [3, 3]
    assert both(lambda s: s.step()) == [2, 2]
    reads("after one window")
    assert both(lambda s: s.step()) == [1, 1]
    both(lambda s: s.submit_upsert(np.concatenate([keys[4:6], new[0][:2]]),
                                   np.array([7, 8, 9, 10], np.int32)))
    both(lambda s: s.step())
    reads("after the upsert")
    for t in both(lambda s: s.fold_async(k=2)):
        t.join()
    reads("after the background fold")
    both(lambda s: s.submit_insert(new[2]))
    both(lambda s: s.submit_insert(new[3]))
    both(lambda s: s.submit_insert(new[4]))
    both(lambda s: s.drain())  # depth 3: the policy folds before the third insert
    reads("after the policy fold")
    jst, pst = both(lambda s: s.stats())
    assert pst.folds >= 2 and pst.last_error is None
    assert _stats_fields(pst) == _stats_fields(jst)
    assert servers[1].metrics().value("batch_exchange_budget_misses_total") == 0


# ---------------------------------------------------------------------------
# The warmed grid
# ---------------------------------------------------------------------------


def _warm_pair(mesh8):
    jt, pt = _tables(mesh8, 8, hash_range=1 << 16, max_deltas=3, tombstone_capacity=256)
    rng = np.random.default_rng(3)
    seed = (rng.choice(1 << 18, size=256, replace=False) + 1000).astype(np.uint32)
    policy = dict(max_delta_depth=2, fold_k=1, tombstone_load=0.9)
    js = jserve.TableServer(jt, seed, policy=jserve.CompactionPolicy(**policy),
                            batcher=jserve.MicroBatcher(jt, min_bucket=8), write_bucket=8)
    ps = TableServer(pt, seed, policy=CompactionPolicy(**policy),
                     batcher=MicroBatcher(pt, min_bucket=8), write_bucket=8)
    return js, ps, seed


def test_warm_grid_matches_reference(mesh8):
    js, ps, seed = _warm_pair(mesh8)
    kw = dict(buckets=(8, 16), depths=(0, 1, 2), fold_horizon=2, retrieve_caps={8: (64, 64)})
    jw = js.warm(profile=False, **kw)
    pw = ps.warm(**kw)
    for name in ("write_bucket", "buckets", "depths", "fold_horizon", "entries", "aot_hits",
                 "aot_misses"):
        assert getattr(pw, name) == getattr(jw, name), name
    assert pw.entries == 14 + 7  # the README's 14 queries, and the 8-bucket retrieves

    def grid_keys(grid):  # (kind, bucket, caps) of every entry; signatures differ in type
        return sorted((k[0], k[1], k[2]) for k in grid._handles)

    assert grid_keys(ps.batcher.executors) == grid_keys(js.batcher.executors)
    # Every profiled structure reads in two rounds.
    assert pw.profiles and all(c.all_to_alls == 2 for c in pw.profiles)
    snap = ps.metrics()
    assert snap.value("aot_entries") == pw.entries
    # Warmed reads at every depth and after a policy fold: no miss, as the reference.
    for s in (js, ps):
        assert s.query(seed[:5]).tolist() == [1] * 5
        s.submit_insert(np.array([21, 22], np.uint32))
        s.step()
        assert s.query_many([np.array([21, 22, 23], np.uint32), seed[:9]])[0][0].tolist() == [1, 1, 0]
        s.submit_insert(np.array([24], np.uint32))
        s.step()
        s.submit_insert(np.array([25], np.uint32))
        s.step()  # the policy folds (depth 2 -> 1) first: fold step 1
        assert s.stats().folds == 1
        vals, _ = s.retrieve_many([np.array([21, 25], np.uint32)])
        assert [len(v) for v in vals[0]] == [1, 1]
    assert ps.stats().warmup.aot_misses == js.stats().warmup.aot_misses == 0
    assert ps.stats().warmup.aot_hits == js.stats().warmup.aot_hits
    assert ps.metrics().value("jit_dispatch_cache_size") == 0


def test_compiled_plan_refuses_other_structures():
    pt = DistributedHashTable(num_shards=8, hash_range=1 << 12, device="cpu")
    server = TableServer(pt, np.arange(64, dtype=np.uint32), write_bucket=8,
                         batcher=MicroBatcher(pt, min_bucket=8))
    server.warm(buckets=(8,), depths=(0,), fold_horizon=0)
    grid = server.batcher.executors
    handle = grid._peek(next(iter(grid._handles)))
    deeper = server.current().state.insert(np.arange(8, dtype=np.uint32))
    with pytest.raises(ValueError, match="structure"):
        handle(deeper, np.arange(8, dtype=np.uint32))
    with pytest.raises(ValueError, match="queries"):
        handle(server.current().state, np.arange(16, dtype=np.uint32))


# ---------------------------------------------------------------------------
# DeadlineBatcher: one fake-clock schedule through both packages
# ---------------------------------------------------------------------------

LINGER, FLUSH_KEYS = 0.01, 16


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _batches(serve, schedule):
    """Drive a fake-clock DeadlineBatcher; returns ``[(time, [request index,
    ...]), ...]`` and checks exactly-once, the deadline and the bucket bound."""
    clock = FakeClock()
    b = serve.DeadlineBatcher(flush_keys=FLUSH_KEYS, linger=LINGER, capacity=10_000, clock=clock)
    arrivals = sorted((float(a), int(s), float(dl), i) for i, (a, s, dl) in enumerate(schedule))
    eps = 1e-6
    times = sorted({a for a, *_ in arrivals} | {a + LINGER + eps for a, *_ in arrivals}
                   | {a + dl + eps for a, _, dl, _ in arrivals})
    index, out, it = {}, [], iter(arrivals)
    nxt = next(it, None)
    for now in times:
        clock.t = now
        while nxt is not None and nxt[0] <= now + eps:
            a, size, dl, i = nxt
            index[id(b.submit(np.arange(size, dtype=np.uint32), deadline=a + dl))] = i
            nxt = next(it, None)
        while (batch := b.poll(now)) is not None:
            assert sum(r.size for r in batch) <= FLUSH_KEYS or len(batch) == 1
            for r in batch:
                assert now <= min(r.enqueued + LINGER, r.deadline) + 2 * eps
            out.append((now, [index[id(r)] for r in batch]))
    assert b.pending() == 0
    assert sorted(i for _, batch in out for i in batch) == list(range(len(schedule)))
    return out, b.counters()


@pytest.mark.parametrize("seed", range(12))
def test_deadline_batcher_same_batches_in_both(seed):
    rng = np.random.default_rng(seed)
    schedule = [(float(rng.uniform(0, 0.05)), int(rng.integers(1, 12)),
                 float(rng.uniform(0.0005, 0.03))) for _ in range(int(rng.integers(1, 60)))]
    assert _batches(pserve, schedule) == _batches(jserve, schedule)


def test_deadline_batcher_urgent_backpressure_and_close():
    clock = FakeClock()
    b = pserve.DeadlineBatcher(flush_keys=64, linger=1.0, capacity=2, clock=clock)
    b.submit(np.arange(2, dtype=np.uint32))
    clock.t = 0.1
    b.submit(np.arange(2, dtype=np.uint32), deadline=0.2)
    with pytest.raises(TimeoutError, match="admission queue full"):
        b.submit(np.arange(1, dtype=np.uint32), timeout=0.05)
    assert b.poll(0.15) is None
    assert len(b.poll(0.21)) == 2
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.arange(1, dtype=np.uint32))


# ---------------------------------------------------------------------------
# The port alone against numpy oracles
# ---------------------------------------------------------------------------


def test_server_maintenance_folds_and_stays_consistent():
    """A write stream with deletes after folds: answers stay exact and the
    ring never overflows.  (The reference's own case fails on jax 0.9, so
    the oracle is numpy.)"""
    table = DistributedHashTable(num_shards=8, hash_range=1 << 12, max_deltas=4, device="cpu")
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 1 << 14, 512, dtype=np.uint32)
    vals = np.arange(512, dtype=np.int32)
    server = TableServer(table, keys, vals, policy=CompactionPolicy(max_delta_depth=4, fold_k=2))
    oracle = Oracle()
    oracle.insert(keys, vals)
    next_val, live = 1000, []
    for wave in range(12):
        ins = rng.integers(1 << 14, 1 << 15, 16, dtype=np.uint32)
        iv = np.arange(next_val, next_val + 16, dtype=np.int32)
        next_val += 16
        server.submit_insert(ins, iv)
        oracle.insert(ins, iv)
        live.extend(ins.tolist())
        if wave % 3 == 2:
            dead = np.array(live[:8], np.uint32)
            server.submit_delete(dead)
            oracle.delete(dead)
            live = live[8:]
        server.drain()
    stats = server.stats()
    assert stats.folds + stats.full_compacts >= 1
    assert stats.shadow.delta_depth <= table.max_deltas
    q = np.concatenate([keys[:32], np.array(live[:32], np.uint32)])
    counts, _ = server.query_many([q])
    np.testing.assert_array_equal(counts[0], [oracle.count(k) for k in q])
    (res,), _ = server.retrieve_many([q])
    for k, rows in zip(q, res):
        assert sorted(_value_rows(np.asarray(rows)), key=repr) == oracle.values(k)
    assert all(r.rounds == 0 for r in server.fold_log if r.kind == "fold")
    assert server.metrics().value("maintenance_fold_budget_misses_total") == 0


def test_reads_flow_during_background_fold():
    table = DistributedHashTable(num_shards=8, hash_range=1 << 12, max_deltas=8, device="cpu")
    rng = np.random.default_rng(19)
    keys = rng.integers(0, 1 << 14, 512, dtype=np.uint32)
    server = TableServer(table, keys, np.arange(512, dtype=np.int32))
    oracle = Oracle()
    oracle.insert(keys, np.arange(512, dtype=np.int32))
    for _ in range(4):
        ins = rng.integers(1 << 14, 1 << 15, 32, dtype=np.uint32)
        server.submit_insert(ins, np.arange(64, 96, dtype=np.int32))
        oracle.insert(ins, np.arange(64, 96, dtype=np.int32))
    server.drain()
    pre = server.current().seqno
    server._writer_mutex.acquire()  # hold the fold at its start: reads must flow
    t = server.fold_async(k=2)
    reads = 0
    for _ in range(5):
        counts, seq = server.query_many([keys[:24]])
        assert seq == pre
        np.testing.assert_array_equal(counts[0], [oracle.count(k) for k in keys[:24]])
        reads += 1
    assert server.fold_in_flight and server.step() == 0  # writes defer
    server._writer_mutex.release()
    t.join()
    assert reads == 5 and server.current().seqno == pre + 1
    assert server.stats().folds == 1 and server.fold_log[-1].background
    counts, seq = server.query_many([keys[:24]])
    assert seq == pre + 1
    np.testing.assert_array_equal(counts[0], [oracle.count(k) for k in keys[:24]])


def test_delete_runs_escalate_and_failed_writes_surface():
    table = DistributedHashTable(num_shards=8, hash_range=1 << 12, tombstone_capacity=16,
                                 device="cpu")
    rng = np.random.default_rng(31)
    keys = rng.choice(np.arange(1 << 14, dtype=np.uint32), size=512, replace=False)
    server = TableServer(table, keys, np.arange(512, dtype=np.int32), window=16,
                         policy=CompactionPolicy(max_delta_depth=8, tombstone_load=0.5))
    for i in range(8):
        server.submit_delete(keys[i * 8: (i + 1) * 8])
    server.drain()
    stats = server.stats()
    assert stats.shadow.tombstone_dropped == 0 and stats.full_compacts >= 1
    counts, _ = server.query_many([keys[:64], keys[64:96]])
    assert (counts[0] == 0).all() and (counts[1] == 1).all()

    small = DistributedHashTable(num_shards=8, hash_range=1 << 10, max_deltas=1, device="cpu")
    never = CompactionPolicy(max_delta_depth=None, tombstone_load=2.0, tombstone_overflow=False)
    server = TableServer(small, keys[:256], np.arange(256, dtype=np.int32), policy=never)
    for _ in range(2):
        server.submit_insert(rng.integers(0, 1 << 14, 8, dtype=np.uint32))
    with pytest.raises(RuntimeError, match="delta ring full"):
        server.step()
    st = server.stats()
    assert server.pending() == 1 and "delta ring full" in st.last_error
    assert st.writes_applied == 1 and server.current().seqno == 1


def test_batcher_overflow_doubles_then_raises():
    table = DistributedHashTable(num_shards=8, hash_range=1 << 11, device="cpu")
    rng = np.random.default_rng(9)
    base = rng.choice(np.arange(1 << 14, dtype=np.uint32), size=64, replace=False)
    state = table.init(np.concatenate([base, np.repeat(base[0], 64)]))
    batcher = MicroBatcher(table, min_bucket=32)
    assert all(len(v) == 1 for v in batcher.retrieve_many(state, [base[1:9]])[0])
    out = batcher.retrieve_many(state, [base[:1]], per_layer_counts=True)
    assert len(out[0][0][0]) == 65 and out[0][1].tolist() == [[65]]
    assert batcher.stats().overflow_retries >= 1
    hot = table.init(np.concatenate([base, np.repeat(base[0], 192)]))
    tight = MicroBatcher(table, min_bucket=32, max_retries=1)
    tight.retrieve_many(hot, [base[1:9]])
    with pytest.raises(RuntimeError, match="capacity doublings"):
        tight.retrieve_many(hot, [base[:1]])


# ---------------------------------------------------------------------------
# Async front end: stress, faults, drain
# ---------------------------------------------------------------------------

PROBES = np.array([101, 202, 303, 404, 505, 606, 707, 808], dtype=np.uint32)


def _async_server(policy=None, seed=0, pool=256, write_bucket=8):
    table = DistributedHashTable(num_shards=8, hash_range=1 << 16, max_deltas=4,
                                 tombstone_capacity=256, device="cpu")
    rng = np.random.default_rng(seed)
    keys = (rng.choice(1 << 18, size=pool, replace=False) + 1000).astype(np.uint32)
    server = TableServer(
        table, keys,
        policy=policy or CompactionPolicy(max_delta_depth=2, fold_k=1, tombstone_load=0.9),
        batcher=MicroBatcher(table, min_bucket=8), write_bucket=write_bucket,
    )
    return server, keys


def test_async_stress_matches_oracle_per_seqno():
    """Three readers, a writer and background folds: every response equals
    the numpy oracle of the seqno it reports (the probe set's count is the
    number of applied probe inserts, the deleted seed keys count 0), none is
    lost or resolved twice, and no serving thread outlives stop()."""
    server, pool = _async_server(policy=CompactionPolicy(max_delta_depth=2, fold_k=1,
                                                         tombstone_load=0.95), pool=4096)
    seq_writes = {0: 0}  # seqno -> probe inserts applied
    published = []
    real_publish = server.registry.publish

    def publish(state, ready=None):
        snap = real_publish(state, ready)
        published.append(snap.seqno)
        return snap

    server.registry.publish = publish
    stop, errors, responses = threading.Event(), [], []
    fe = pserve.AsyncFrontend(server, linger=0.001, flush_keys=8, write_backlog=32).start()
    watched = pool[:64]

    def reader():
        while not stop.is_set():
            try:
                fut = fe.submit_query(np.concatenate([PROBES, watched[:8]]), timeout=10)
                r = fut.result(timeout=60)
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(repr(e))
                return
            responses.append((r.seqno, np.asarray(r.counts).tolist()))

    def writer():
        for i in range(24):
            if stop.is_set():
                return
            fe.submit_insert(PROBES, timeout=10)
            fe.submit_delete(pool[64 + i * 8: 64 + (i + 1) * 8], timeout=10)
            if i % 6 == 5 and not server.fold_in_flight:
                try:
                    server.fold_async()
                except RuntimeError:
                    pass
            time.sleep(0.003)

    threads = [threading.Thread(target=reader) for _ in range(3)] + [threading.Thread(target=writer)]
    for t in threads:
        t.start()
    threads[-1].join(timeout=120)
    time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    server.drain(timeout=120)
    fe.stop()
    assert not errors, errors[:3]
    st = fe.stats()
    assert st.failed == 0 and st.completed == st.submitted == len(responses)
    assert st.queue_depth == 0 and st.inflight == 0
    # The oracle per seqno: replay the snapshots' states on the numpy side.
    by_seq = {}
    for seqno, counts in responses:
        probe, seen = counts[:8], counts[8:]
        assert len(set(probe)) == 1, f"torn read at seqno {seqno}: {probe}"
        assert seen == [1] * 8  # never deleted
        assert by_seq.setdefault(seqno, probe[0]) == probe[0]
    ordered = [c for _, c in sorted(by_seq.items())]
    assert ordered == sorted(ordered) and ordered[-1] <= 24
    final, _ = server.query_many([PROBES, pool[64: 64 + 24 * 8]])
    assert final[0].tolist() == [24] * 8 and (final[1] == 0).all()
    assert server.stats().last_error is None
    assert server.metrics().value("batch_exchange_budget_misses_total") == 0
    leaked = [t for t in threading.enumerate() if t.is_alive()
              and t.name.startswith(("serve-table", "serve-frontend"))]
    assert not leaked


def test_writer_crash_surfaces_and_reads_survive(monkeypatch):
    server, _ = _async_server(seed=1)
    table = server.table
    real_insert = table.insert
    armed = {"on": False}

    def flaky(state, keys, values=None, **kw):
        if armed["on"]:
            raise RuntimeError("injected insert failure")
        return real_insert(state, keys, values, **kw)

    monkeypatch.setattr(table, "insert", flaky)
    server.start()
    try:
        server.submit_insert(np.array([42, 43], np.uint32))
        server.drain(timeout=60)
        good = server.registry.seqno
        armed["on"] = True
        server.submit_insert(np.array([77], np.uint32))
        server.submit_insert(np.array([78], np.uint32))
        deadline = time.monotonic() + 30
        while server._writer_thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not server._writer_thread.is_alive()
        assert "injected insert failure" in server.stats().last_error
        assert server.registry.seqno == good and server.pending() == 2
        res, seqno = server.query_many([np.array([42, 43], np.uint32)])
        assert seqno == good and res[0].tolist() == [1, 1]
        with pytest.raises(RuntimeError, match="injected insert failure"):
            server.drain(timeout=5)
    finally:
        armed["on"] = False
        server.stop()


def test_fold_crash_surfaces_and_reads_survive(monkeypatch):
    server, _ = _async_server(policy=CompactionPolicy(max_delta_depth=None), seed=2)
    server.submit_insert(np.array([11, 12], np.uint32))
    server.submit_insert(np.array([13, 14], np.uint32))
    while server.step():
        pass
    good = server.registry.seqno

    def boom(state, k):
        raise RuntimeError("injected fold failure")

    monkeypatch.setattr("repro_torch.core.maintenance.fold_oldest", boom)
    t = server.fold_async(1)
    t.join(timeout=30)
    assert not t.is_alive()
    assert "injected fold failure" in server.stats().last_error
    assert server.registry.seqno == good
    res, seqno = server.query_many([np.array([11, 13], np.uint32)])
    assert seqno == good and res[0].tolist() == [1, 1]
    with pytest.raises(RuntimeError, match="background fold failed"):
        server.drain(timeout=5)


def test_drain_contract_and_read_your_writes():
    server, _ = _async_server(seed=4)
    server.submit_insert(np.array([5], np.uint32))
    assert server._writer_mutex.acquire(timeout=5)
    try:
        with pytest.raises(TimeoutError, match="1 pending batch"):
            server.drain(timeout=0.3)
    finally:
        server._writer_mutex.release()
    server.drain(timeout=60)
    assert server.query(np.array([5], np.uint32)).tolist() == [1]
    server.start()
    assert server._writer_mutex.acquire(timeout=5)
    outcome = []

    def drainer():
        try:
            server.drain(timeout=60)
            outcome.append("returned")
        except Exception as e:  # noqa: BLE001 - the outcome under test
            outcome.append(e)

    try:
        server.submit_insert(np.array([6], np.uint32))
        t = threading.Thread(target=drainer, daemon=True)
        t.start()
        time.sleep(0.2)
        server.stop()
        t.join(timeout=10)
        assert not t.is_alive() and isinstance(outcome[0], RuntimeError)
    finally:
        server._writer_mutex.release()
        server.stop()
    with pserve.AsyncFrontend(server, linger=0.001) as fe:
        fe.submit_insert(np.array([91, 92], np.uint32))
        server.drain(timeout=60)
        target = server.registry.seqno
        assert server.registry.wait_for(target, timeout=30).seqno >= target
        r = fe.submit_query(np.array([91, 92, 93], np.uint32)).result(timeout=60)
        assert r.counts.tolist() == [1, 1, 0] and r.seqno >= target
    assert fe.tracer.live() == 0
