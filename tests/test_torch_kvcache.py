"""The port's ``cache/`` (KVCache and the YCSB generator) against the JAX
package, bit for bit.

* A scripted sequence through both packages' ``KVCache`` at D = 1 and
  D = 8: put, get, contains, delete, put with a TTL, ``tick``, ``advance``,
  ``maintain``, the policy's folds and compactions, ``evict_expired`` and
  ``live_count``; every read, ``folds`` / ``evictions``, ``stats()`` and
  the registry's counters must be equal.  (A pending TTL entry is kept
  throughout: without one, a compaction leaves a zero-capacity tombstone
  buffer and the reference restarts its clock at the next delete, a known
  reference caveat the port does not copy.)
* The reference's ``test_upsert_read_your_writes_last_writer_wins`` over
  its ``SCHEMAS`` (both packages on the upserted state, the port's fold and
  compaction against the same oracle), ``test_stats_driven_fold_amount_
  cold_prefix`` and ``test_eviction_reclaims_capacity``, as parity cases.
* The reference cases that fail on jax 0.9 (``test_workload_drives_
  kvcache_exactly`` and ``test_ttl_expires_exactly_at_boundary``) are held
  against dict oracles in the port alone.
* ``YCSBWorkload`` streams A–F equal to the reference's, and the port's
  ``TableServer.submit_upsert`` / ``advance`` case.

Tolerance: none; every output is an integer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.cache import KVCache as JKVCache
from repro.cache import WORKLOADS as JWORKLOADS
from repro.cache import YCSBWorkload as JYCSB
from repro.core import maintenance as jmaint
from repro.core.schema import TableSchema as JSchema
from repro.core.table import DistributedHashTable as JTable
from repro.core.table import retrieval_to_lists as jlists
from repro_torch import DistributedHashTable, TableSchema, counting, retrieval_to_lists
from repro_torch.cache import WORKLOADS, KVCache, YCSBWorkload, ZipfianGenerator, key_of
from repro_torch.core import maintenance
from repro_torch.core.schema import pack_u64
from test_table_state import _keys_for, _value_rows, _values_for
from test_torch_state import _mesh, _np

HASH_RANGE = 1 << 12
MESHES = pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])
COUNTERS = ("kvcache_puts_total", "kvcache_gets_total", "kvcache_deletes_total",
            "kvcache_evictions_total", "kvcache_folds_total")


def _tables(request, d, schema=None, **kw):
    kw.setdefault("hash_range", HASH_RANGE)
    js = None if schema is None else JSchema(schema.key_dtype, schema.value_cols)
    jt = JTable(_mesh(request, d), ("d",), schema=js, **kw)
    pt = DistributedHashTable(num_shards=d, device="cpu", schema=schema, **kw)
    return jt, pt


def _same_cache(jc: JKVCache, pc: KVCache):
    assert (pc.folds, pc.evictions, pc.now) == (jc.folds, jc.evictions, jc.now)
    assert dataclasses.asdict(pc.stats()) == dataclasses.asdict(jc.stats())
    assert pc.live_count() == jc.live_count()
    pm, jm = pc.metrics(), jc.metrics()
    for name in COUNTERS + ("kvcache_delta_depth", "kvcache_tombstone_load",
                            "kvcache_expired_load", "kvcache_now"):
        assert pm.value(name) == jm.value(name), name
    assert pm.histogram("kvcache_get_seconds").count == jm.histogram("kvcache_get_seconds").count


@MESHES
def test_scripted_cache_sequence_matches_reference(request, d):
    jt, pt = _tables(request, d, max_deltas=4, tombstone_capacity=256)
    keys = np.arange(1, 129, dtype=np.uint32)
    vals = np.arange(128, dtype=np.int32) * 2
    jc = JKVCache(jt, jnp.asarray(keys), jnp.asarray(vals))
    pc = KVCache(pt, keys, vals)
    absent = np.arange(1 << 20, (1 << 20) + 16, dtype=np.uint32)
    reads = np.concatenate([keys, absent])  # 144 keys, a multiple of 8

    def both(op, *args, **kw):
        out_j = getattr(jc, op)(*args, **kw)
        out_p = getattr(pc, op)(*args, **kw)
        return out_p, out_j

    def same_reads():
        for op in ("get", "contains"):
            got, want = both(op, reads)
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=op)
        _same_cache(jc, pc)

    both("put", np.array([1 << 21] * 8, np.uint32), np.arange(8, dtype=np.int32), ttl=1000)
    rng = np.random.default_rng(d)
    for step in range(5):  # folds at depth 4, compactions at half the buffer
        k = rng.choice(keys, 24, replace=True)
        both("put", k, np.arange(24, dtype=np.int32) + 100 * step)
        if step % 3 == 1:
            both("delete", rng.choice(keys, 8, replace=False))
        if step % 4 == 2:
            both("put", keys[step * 8: step * 8 + 8], np.full(8, -7 - step, np.int32), ttl=2)
            both("tick")
    same_reads()
    assert pc.folds + pc.evictions > 0
    both("advance", pc.now + 5)  # every short TTL expired
    same_reads()
    got, want = both("maintain")
    assert got == want
    got, want = both("evict_expired")
    assert got == want
    same_reads()


SCHEMAS = [
    pytest.param(TableSchema("uint32", 1), id="u32x1"),
    pytest.param(TableSchema("uint64", 2), id="u64x2"),
]


def _packed(schema, keys):
    return pack_u64(keys) if schema.key_dtype == "uint64" else keys


def _values_of(table, state, queries, lists):
    res = table.retrieve(state, queries, out_capacity=4096, seg_capacity=4096)
    assert int(res.num_dropped) == 0
    return [_value_rows(np.asarray(v)) for v in lists(res)]


@pytest.mark.parametrize("schema", SCHEMAS)
@MESHES
def test_upsert_read_your_writes_last_writer_wins(request, schema, d):
    jt, pt = _tables(request, d, schema)
    rng = np.random.default_rng(17 + d + schema.value_cols)
    base_keys = np.unique(_keys_for(schema, rng, 64))
    base_vals = _values_for(schema, 0, len(base_keys))
    js = jt.init(jnp.asarray(_packed(schema, base_keys)), jnp.asarray(base_vals))
    ps = pt.init(_packed(schema, base_keys), base_vals)
    old = base_keys[: len(base_keys) // 2]
    fresh = np.unique(_keys_for(schema, rng, 16, lo=1 << 17, hi=1 << 18))
    up_keys = np.concatenate([old, fresh, old])  # old repeated: the last wins
    up_vals = _values_for(schema, 10_000, len(up_keys))
    js = jt.upsert(js, jnp.asarray(_packed(schema, up_keys)), jnp.asarray(up_vals))
    ps = pt.upsert(ps, _packed(schema, up_keys), up_vals)
    queries = np.concatenate([base_keys, fresh])
    q = _packed(schema, queries)
    pad = (-len(queries)) % d
    q = np.concatenate([q, q[:pad]])  # reads of a multiple of D rows
    expect = dict(zip(base_keys.tolist(), _value_rows(base_vals)))
    expect.update(zip(up_keys.tolist(), _value_rows(up_vals)))
    want_vals = [[expect[int(k)]] for k in queries]
    counts = _np(pt.query(ps, q))
    np.testing.assert_array_equal(counts, np.asarray(jt.query(js, jnp.asarray(q))))
    np.testing.assert_array_equal(counts, np.ones(len(q), np.int32))
    assert _values_of(pt, ps, q, retrieval_to_lists)[: len(queries)] == want_vals
    assert _values_of(jt, js, jnp.asarray(q), jlists)[: len(queries)] == want_vals
    up2 = _values_for(schema, 50_000, len(queries))
    js = jt.upsert(js, jnp.asarray(_packed(schema, queries)), jnp.asarray(up2))
    ps = pt.upsert(ps, _packed(schema, queries), up2)
    want2 = [[v] for v in _value_rows(up2)]
    assert _values_of(jt, js, jnp.asarray(q), jlists)[: len(queries)] == want2
    # The fold and the compaction against the same oracle (the reference's
    # own test holds its side there).
    for sp in (ps, maintenance.fold_oldest(ps, 1), ps.compact()):
        np.testing.assert_array_equal(_np(pt.query(sp, q)), np.ones(len(q), np.int32))
        assert _values_of(pt, sp, q, retrieval_to_lists)[: len(queries)] == want2


def test_stats_driven_fold_amount_cold_prefix(mesh8, request):
    jt, pt = _tables(request, 8, max_deltas=6, tombstone_capacity=512)
    keys = np.arange(1, 257, dtype=np.uint32)
    vals = np.arange(256, dtype=np.int32)
    js, ps = jt.init(jnp.asarray(keys), jnp.asarray(vals)), pt.init(keys, vals)
    cold1 = np.arange(1 << 10, (1 << 10) + 32, dtype=np.uint32)
    cold2 = np.arange(1 << 11, (1 << 11) + 32, dtype=np.uint32)
    hot = np.arange(1 << 12, (1 << 12) + 32, dtype=np.uint32)
    for batch in (cold1, cold2, hot):
        js = js.insert(jnp.asarray(batch), jnp.asarray(np.arange(32, dtype=np.int32)))
        ps = ps.insert(batch, np.arange(32, dtype=np.int32))
    dead = np.concatenate([cold1, cold2])
    js, ps = jt.delete(js, jnp.asarray(dead)), pt.delete(ps, dead)
    layer_live = maintenance.collect_layer_live(ps)
    assert layer_live == jmaint.collect_layer_live(js)
    assert [live for live, _ in layer_live] == [256, 0, 0, 32]
    policy = maintenance.CompactionPolicy(fold_k=None, cold_live_ratio=0.5)
    jpolicy = jmaint.CompactionPolicy(fold_k=None, cold_live_ratio=0.5)
    k = policy.fold_amount(ps.stats(), layer_live)
    assert k == jpolicy.fold_amount(js.stats(), layer_live) == 2
    fp, fj = maintenance.fold_oldest(ps, k), jmaint.fold_oldest(js, k)
    assert len(fp.deltas) == len(fj.deltas) == 1
    for batch, want in ((hot, 1), (cold1, 0)):
        got = _np(pt.query(fp, batch))
        np.testing.assert_array_equal(got, np.asarray(jt.query(fj, jnp.asarray(batch))))
        np.testing.assert_array_equal(got, np.full(32, want, np.int32))
    assert maintenance.CompactionPolicy(fold_k=3).fold_amount(ps.stats(), layer_live) == 3


def test_eviction_reclaims_capacity(mesh8, request):
    jt, pt = _tables(request, 8, max_deltas=4, tombstone_capacity=512)
    jc, pc = JKVCache(jt, default_ttl=2), KVCache(pt, default_ttl=2)
    keys = np.arange(1, 65, dtype=np.uint32)
    allocs = []
    for t in range(12):
        for c in (jc, pc):
            c.put(keys, np.full(64, t, np.int32))
            c.tick()
        st = pc.stats()
        assert dataclasses.asdict(st) == dataclasses.asdict(jc.stats())
        allocs.append(st.base_rows + st.delta_rows)
        assert pc.live_count() == jc.live_count() == 64
    assert pc.evictions == jc.evictions >= 1 and pc.folds == jc.folds
    assert max(allocs[6:]) <= max(allocs[:6]), allocs
    np.testing.assert_array_equal(pc.get(keys), np.asarray(jc.get(keys)))
    np.testing.assert_array_equal(pc.get(keys), np.full(64, 11, np.int32))
    for c in (jc, pc):
        c.advance(c.now + 2)
    assert pc.live_count() == jc.live_count() == 0
    assert pc.evict_expired() == jc.evict_expired()
    assert pc.stats().tombstone_count == 0
    assert pc.get(keys)[0] == -1


# ---------------------------------------------------------------------------
# Port-only cases: the reference's versions fail on jax 0.9.
# ---------------------------------------------------------------------------
def test_workload_drives_kvcache_exactly():
    """A zipfian A mix through the port's KVCache matches a dict oracle,
    with reads of any length (not a multiple of D)."""
    table = DistributedHashTable(num_shards=8, hash_range=HASH_RANGE, device="cpu",
                                 max_deltas=4, tombstone_capacity=512)
    w = YCSBWorkload(WORKLOADS["A"], 128, batch=64, seed=2)
    cache = KVCache(table, w.load_keys(), w.load_values().astype(np.int32))
    oracle = dict(zip(w.load_keys().tolist(), w.load_values().tolist()))
    ragged = 0
    for kind, keys, vals in w.batches(512):
        if kind == "read":
            ragged += len(keys) % 8 != 0
            got = cache.get(keys)
            want = np.array([oracle.get(int(k), -1) for k in keys], np.int32)
            np.testing.assert_array_equal(got, want)
        else:
            cache.put(keys, vals)
            for k, v in zip(keys.tolist(), vals.tolist()):
                oracle[int(k)] = v
    assert ragged > 0
    assert cache.live_count() == len(oracle)
    assert cache.folds + cache.evictions > 0


def test_ttl_expires_exactly_at_boundary():
    table = DistributedHashTable(num_shards=8, hash_range=HASH_RANGE, device="cpu")
    keys = np.arange(1, 33, dtype=np.uint32)
    state = table.init(keys, np.arange(32, dtype=np.int32))
    state = table.upsert(state, keys[:8], np.arange(8, dtype=np.int32), ttl=5)
    for now in (0, 4):  # visible strictly before the deadline
        np.testing.assert_array_equal(_np(table.query(state.advance(now), keys)), np.ones(32))
    for now in (5, 9):  # gone at the deadline and after
        want = np.ones(32, np.int32)
        want[:8] = 0
        np.testing.assert_array_equal(_np(table.query(state.advance(now), keys)), want)
    # The clock is data: advancing keeps the read at the fused two exchange rounds.
    with counting.scoped() as scope:
        table.query(state.advance(7), keys)
    assert scope.exchange_rounds == 2


# ---------------------------------------------------------------------------
# YCSB generator and the server's upsert
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("letter", list("ABCDEF"))
def test_workload_streams_match_reference(letter):
    kw = dict(batch=128, scan_len=4, seed=11, theta=0.99)
    got = list(YCSBWorkload(WORKLOADS[letter], 512, **kw).batches(1000))
    want = list(JYCSB(JWORKLOADS[letter], 512, **kw).batches(1000))
    assert len(got) == len(want)
    for (gk, gkeys, gvals), (wk, wkeys, wvals) in zip(got, want):
        assert gk == wk
        np.testing.assert_array_equal(gkeys, wkeys)
        assert (gvals is None) == (wvals is None)
        if gvals is not None:
            np.testing.assert_array_equal(gvals, wvals)
    k = key_of(np.arange(1 << 16))
    assert len(np.unique(k)) == 1 << 16 and not np.any(k == np.uint32(0xFFFFFFFF))
    s = ZipfianGenerator(1000, theta=0.99, seed=0).sample(20_000)
    assert 0.08 < np.mean(s == 0) < 0.20


def test_server_upsert_and_clock():
    from repro_torch.serve_table import CompactionPolicy, MicroBatcher, TableServer

    table = DistributedHashTable(num_shards=8, hash_range=HASH_RANGE, device="cpu",
                                 max_deltas=4, tombstone_capacity=256)
    n = 128
    server = TableServer(
        table,
        np.arange(1, n + 1, dtype=np.uint32),
        np.arange(n, dtype=np.int32),
        policy=CompactionPolicy(max_delta_depth=2, fold_k=1, tombstone_load=0.9),
        batcher=MicroBatcher(table, min_bucket=16),
        write_bucket=16,
    )
    keys = np.arange(1, 17, dtype=np.uint32)
    # Duplicate submissions dedup keep-last at admission.
    server.submit_upsert(
        np.concatenate([keys, keys]),
        np.concatenate([np.zeros(16, np.int32), np.arange(16, dtype=np.int32) + 500]),
        ttl=4,
    )
    server.drain()
    counts, _ = server.query_many([keys])
    np.testing.assert_array_equal(_np(counts[0]), np.ones(16, np.int32))
    (vals,), _ = server.retrieve_many([keys])
    assert [int(v[0]) for v in vals] == [500 + i for i in range(16)]
    server.advance(3)
    counts, _ = server.query_many([keys])
    np.testing.assert_array_equal(_np(counts[0]), np.ones(16, np.int32))
    server.advance(4)  # the TTL deadline: the rows age out of the snapshot
    counts, _ = server.query_many([keys])
    np.testing.assert_array_equal(_np(counts[0]), np.zeros(16, np.int32))
    counts, _ = server.query_many([np.arange(17, 33, dtype=np.uint32)])
    np.testing.assert_array_equal(_np(counts[0]), np.ones(16, np.int32))
    assert server.stats().last_error is None
