"""The port's versioned table against the JAX package, step by step.

Mirrors ``tests/test_table_state.py`` for the port: the same seeded numpy
inputs go through the JAX ``DistributedHashTable`` (mesh1 / mesh8) and the
port's (D = 1 / D = 8 stacked shards, ``device="cpu"``), and after every
mutation the two states must hold the same arrays (base, every delta, every
tombstone field, ``coherent``) and give the same reads (query, plan_caps,
retrieve, inner_join, join_size).  Also: upsert keep-last dedup and TTL with
``advance``, the ring-full error and ``auto_compact``, tombstone overflow,
flat compact sizing and the exchange-call budgets by depth.  The routing
variants and the skew guard are in ``test_torch_state_routing.py``, the
depth-6 gathers and a JAX-built stack in ``test_torch_state_gather.py``
(split for the test runner's workers: each file runs whole on one).  The
helpers here are shared by those files and by the other table files.
Tolerance: none; every output is an integer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.core import hashing as jhashing
from repro.core import table as jtable
from repro_torch import DistributedHashTable, join_to_pairs
from repro_torch.core import convert, exchange, maintenance
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

HASH_RANGE = 1 << 12


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_graph(g) -> dict:
    """A reference ``DistributedHashGraph`` as ``convert.graph_from_numpy``'s
    keyword arguments (``fingerprints`` only where the graph has the lane)."""
    out = {
        "offsets": np.asarray(g.local.offsets),
        "keys": np.asarray(g.local.keys),
        "values": np.asarray(g.local.values),
        "hash_splits": np.asarray(g.hash_splits),
        "num_dropped": int(g.num_dropped),
        "hash_range": g.hash_range,
        "seed": g.seed,
        "local_range_cap": g.local_range_cap,
        "bucket_stride": g.bucket_stride,
    }
    if g.local.fingerprints is not None:
        out["fingerprints"] = np.asarray(g.local.fingerprints)
    return out


def jax_state(js) -> dict:
    """A reference ``TableState`` as ``convert.state_from_numpy``'s arguments."""
    ts = js.tombstones
    return {
        "base": jax_graph(js.base),
        "deltas": [jax_graph(g) for g in js.deltas],
        "tombstones": {
            "keys": np.asarray(ts.keys),
            "epochs": np.asarray(ts.epochs),
            "expires": np.asarray(ts.expires),
            "count": int(ts.count),
            "num_dropped": int(ts.num_dropped),
            "now": int(ts.now),
        },
        "coherent": js.coherent,
    }


def assert_same_state(ps, js):
    got, want = convert.state_to_numpy(ps), jax_state(js)
    assert got["coherent"] == want["coherent"]
    assert len(got["deltas"]) == len(want["deltas"])
    for g, w in zip([got["base"], *got["deltas"]], [want["base"], *want["deltas"]]):
        assert set(g) == set(w)
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    for name, w in want["tombstones"].items():
        np.testing.assert_array_equal(got["tombstones"][name], w, err_msg=f"tombstones.{name}")


def assert_same_reads(pt, ps, jt, js, queries):
    """Every read of the port equals the reference's on the same queries."""
    jq = jnp.asarray(queries)
    np.testing.assert_array_equal(_np(pt.query(ps, queries)), np.asarray(jt.query(js, jq)))
    assert pt.plan_caps(ps, queries) == tuple(int(c) for c in jt.plan_caps(js, jq))
    got, want = pt.retrieve(ps, queries), jt.retrieve(js, jq)
    for name in ("offsets", "values", "counts"):
        np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)))
    assert int(got.num_dropped) == int(want.num_dropped)
    np.testing.assert_array_equal(
        join_to_pairs(pt.inner_join(ps, queries)), jtable.join_to_pairs(jt.inner_join(js, jq))
    )
    assert int(pt.join_size(ps, queries)) == int(jt.join_size(js, jq))


class Pair:
    """One table per package, driven through the same operations."""

    def __init__(self, mesh, d, **kw):
        self.d = d
        self.jt = jtable.DistributedHashTable(mesh, ("d",), hash_range=HASH_RANGE, **kw)
        self.pt = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu", **kw)
        self.js = self.ps = None

    def init(self, keys, values=None):
        jv = None if values is None else jnp.asarray(values)
        self.js = self.jt.init(jnp.asarray(keys), jv)
        self.ps = self.pt.init(keys, values)
        return self

    def apply(self, op, *args, **kw):
        """Run ``state.op(*args)`` in both packages (numpy arguments)."""
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        self.js = getattr(self.js, op)(*jargs, **kw)
        self.ps = getattr(self.ps, op)(*args, **kw)
        return self

    def check(self, queries):
        assert_same_state(self.ps, self.js)
        assert_same_reads(self.pt, self.ps, self.jt, self.js, queries)


MESHES = pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])


def _mesh(request, d):
    return request.getfixturevalue("mesh1" if d == 1 else "mesh8")


def _lifecycle_inputs(d):
    rng = np.random.default_rng(42 + d)
    keys = rng.integers(0, 1 << 16, size=512, dtype=np.uint32)
    keys[30::61] = 0xFFFFFFFF  # padding sentinels in the input
    vals = np.arange(512, dtype=np.int32)
    ins = rng.integers(1 << 16, 1 << 17, size=8 * d, dtype=np.uint32)
    ins_vals = np.arange(10_000, 10_000 + 8 * d, dtype=np.int32)
    queries = np.concatenate([
        keys[: 120 - 2 * d], rng.integers(0, 1 << 14, size=2 * d, dtype=np.uint32), ins,
    ])
    return keys, vals, ins, ins_vals, queries


@MESHES
def test_mutation_lifecycle_matches_reference(d, request):
    """insert → delete (base and delta rows) → reinsert → compact, with the
    state and every read equal to the reference's after each step."""
    keys, vals, ins, ins_vals, queries = _lifecycle_inputs(d)
    p = Pair(_mesh(request, d), d).init(keys, vals)
    p.check(queries)
    p.apply("insert", ins, ins_vals).check(queries)
    p.apply("delete", np.concatenate([keys[:16], ins[: 2 * d]])).check(queries)
    re_keys = np.concatenate([keys[:8], keys[8:16]])  # deleted above
    p.apply("insert", re_keys, np.arange(20_000, 20_016, dtype=np.int32)).check(queries)
    assert (_np(p.pt.query(p.ps, keys[:8])) >= 1).all()  # visible again
    compacted = p.apply("compact")
    assert len(compacted.ps.deltas) == 0 and int(compacted.ps.num_dropped) == 0
    compacted.check(queries)


@MESHES
def test_delete_then_reinsert_is_visible_only_after(d, request):
    p = Pair(_mesh(request, d), d)
    keys = np.arange(64 * d, dtype=np.uint32) * 7
    p.init(keys).apply("delete", keys[:5]).apply("insert", keys[: 8 * d])
    p.check(keys)
    got = _np(p.pt.query(p.ps, keys[:16]))
    assert got[:5].tolist() == [1] * 5 and (got[5:8] == 2).all()


@MESHES
def test_upsert_keep_last_ttl_and_advance(d, request):
    """Upsert with in-batch duplicates (the last occurrence wins) and an
    unaligned length; a TTL'd upsert stays visible until the clock reaches
    it; a compact with a pending TTL carries it; advance makes it expire."""
    p = Pair(_mesh(request, d), d)
    keys = np.arange(128, dtype=np.uint32) * 3 + 1
    p.init(keys, np.arange(128, dtype=np.int32))
    up = np.array([4, 4, 7, 1000, 7, 1000, 1001], np.uint32)  # 7 rows, duplicates
    p.apply("upsert", up, np.arange(50, 57, dtype=np.int32))
    q = np.concatenate([keys[:16], up, np.array([5, 6, 0xFFFFFFFF], np.uint32)])
    q = np.concatenate([q, keys[16 : 16 + (-len(q)) % 8]])
    p.check(q)
    vals = p.pt.retrieve(p.ps, np.array([4] * d, np.uint32)).values
    assert _np(vals)[0] == 51  # keep-last: the second (4, 51) won
    p.apply("upsert", np.array([10, 13], np.uint32), np.array([90, 91], np.int32), ttl=3)
    assert p.ps.tombstones.count == p.js.tombstones.count > 0
    p.check(q)
    for now in (2, 3):
        p.apply("advance", now).check(q)
    p.apply("upsert", np.array([19], np.uint32), np.array([92], np.int32), ttl=5)
    p.apply("compact").check(q)  # the pending TTL survives the compact
    assert p.ps.tombstones.count >= 1
    p.apply("advance", 9).check(q)
    assert _np(p.pt.query(p.ps, np.array([19] * d, np.uint32)))[0] == 0


def test_ring_full_raises_and_auto_compact(mesh8):
    p = Pair(mesh8, 8, max_deltas=2, tombstone_capacity=16)
    rng = np.random.default_rng(43)
    p.init(rng.integers(0, 1 << 14, 256, dtype=np.uint32))
    assert not p.ps.should_compact()
    for _ in range(2):
        p.apply("insert", rng.integers(0, 1 << 14, 8, dtype=np.uint32))
    with pytest.raises(RuntimeError, match="delta ring full"):
        p.ps.insert(np.zeros(8, np.uint32))
    assert p.ps.should_compact(tombstone_load=1.1)  # ring full alone
    assert not p.ps.should_compact(tombstone_load=1.1, ring_full=False)
    p.apply("delete", rng.integers(0, 1 << 14, 8, dtype=np.uint32))
    assert p.ps.should_compact(tombstone_load=0.5) and not p.ps.should_compact(
        tombstone_load=0.9, ring_full=False
    )
    p.apply("insert", rng.integers(0, 1 << 14, 8, dtype=np.uint32), auto_compact=True)
    assert p.ps.epoch == 1  # compacted, then inserted
    p.check(rng.integers(0, 1 << 14, 64, dtype=np.uint32))


def test_tombstone_overflow_counted(mesh8):
    p = Pair(mesh8, 8, tombstone_capacity=8)
    keys = np.random.default_rng(11).integers(0, 1 << 14, 256, dtype=np.uint32)
    p.init(keys).apply("delete", keys[:24])  # 24 deletes into 8 slots
    assert p.ps.tombstones.num_dropped == 16 and int(p.ps.num_dropped) == 16
    assert p.ps.tombstones.count == 8
    p.check(keys[:64])


def test_compact_sizing_stays_flat(mesh8):
    """Steady insert/delete/compact cycles keep the base the same size, and
    the size is the reference's."""
    p = Pair(mesh8, 8)
    rng = np.random.default_rng(41)
    keys = rng.choice(np.arange(1 << 14, dtype=np.uint32), size=1024, replace=False)
    p.init(keys)
    live, sizes = list(keys), []
    for _ in range(3):
        fresh = rng.choice(
            np.setdiff1d(np.arange(1 << 14, dtype=np.uint32), np.array(live, np.uint32)),
            size=256, replace=False,
        )
        dead = np.array(live[:256], np.uint32)
        p.apply("insert", fresh).apply("delete", dead).apply("compact")
        live = live[256:] + list(fresh)
        assert int(p.ps.num_dropped) == 0
        sizes.append(int(p.ps.base.local.values.numel()))
        assert sizes[-1] == int(p.js.base.local.values.shape[0])
        q = np.concatenate([np.array(live[:32], np.uint32), dead[:8]])
        np.testing.assert_array_equal(_np(p.pt.query(p.ps, q)), [1] * 32 + [0] * 8)
    assert sizes[0] == sizes[1] == sizes[2], sizes
    p.check(np.array(live[:64], np.uint32))


def _narrow_batch(state, hash_range, seed, n):
    """Distinct keys whose hash lands in shard 0's range of ``state``'s base."""
    splits = np.asarray(state.base.hash_splits)
    cand = np.arange(1 << 16, 1 << 18, dtype=np.uint32)
    h = np.asarray(jhashing.hash_to_buckets(jnp.asarray(cand), hash_range, seed=seed))
    narrow = cand[h < splits[1]][:n]
    assert len(narrow) == n
    return narrow


def _calls(fn):
    exchange.CALLS.clear()
    out = fn()
    return dict(exchange.CALLS), out


@MESHES
def test_exchange_call_budgets_by_depth(d):
    """Coherent stack: query 2 calls at depth 0 and 4; retrieve and join 2
    plus one sizing round; insert 1; fold 0; compact 2.  Mixed-split stack:
    2 calls per layer for a query."""
    rng = np.random.default_rng(7)
    pt = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu")
    keys = rng.integers(0, 1 << 14, 512, dtype=np.uint32)
    q = rng.integers(0, 1 << 14, 128, dtype=np.uint32)
    state = pt.init(keys)
    for depth in range(5):
        if depth:
            calls, state = _calls(lambda: state.insert(rng.integers(0, 1 << 14, 64, dtype=np.uint32)))
            assert calls == {"exchange": 1}
            state = state.delete(keys[depth : depth + 3])
        if depth in (0, 4):
            assert _calls(lambda: pt.query(state, q))[0] == {"exchange": 2}
            assert _calls(lambda: pt.join_size(state, q))[0] == {"exchange": 2}
            for read in (pt.retrieve, pt.inner_join):
                assert _calls(lambda: read(state, q))[0] == {"exchange": 2, "plan_caps": 1}
    assert _calls(lambda: maintenance.fold_oldest(state, 2))[0] == {}
    calls, compacted = _calls(lambda: state.compact())
    assert calls == {"exchange": 2}
    assert len(compacted.deltas) == 0

    mixed = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu",
                                 coherent_deltas=False)
    ms = mixed.init(keys)
    for _ in range(3):
        ms = ms.insert(rng.integers(0, 1 << 14, 64, dtype=np.uint32))
    assert not ms.coherent
    assert _calls(lambda: mixed.query(ms, q))[0] == {"exchange": 2 * 4}
    assert _calls(lambda: mixed.retrieve(ms, q))[0] == {"exchange": 2 * 4, "plan_caps": 4}


def test_clock_survives_the_first_delete_after_compact():
    """A compact that spends every tombstone leaves a zero-capacity buffer;
    the port's next delete keeps the logical clock (the reference restarts
    it at 0, so a later TTL would be stamped against the wrong clock)."""
    import jax

    mesh = jax.make_mesh((1,), ("d",))
    keys = np.arange(64, dtype=np.uint32)
    p = Pair(mesh, 1).init(keys)
    p.apply("delete", keys[:2]).apply("advance", 10).apply("compact")
    assert p.ps.now == int(p.js.now) == 10
    p.apply("delete", keys[2:4])
    assert p.ps.now == 10
    assert int(p.js.now) == 0  # the reference's clock restarted
    np.testing.assert_array_equal(
        _np(p.pt.query(p.ps, keys[:8])), np.asarray(p.jt.query(p.js, jnp.asarray(keys[:8])))
    )


def test_later_slices_raise_not_implemented():
    # A loader over a mesh, hot-key replication, the plan entry points and
    # fold_oldest(metrics=) are ported now (tests/test_torch_procs_lm.py,
    # tests/test_torch_hot_keys.py, tests/test_torch_plans.py and
    # tests/test_torch_obs.py hold them against the reference); a mesh whose
    # dp axes do not divide the batch is refused.
    from repro_torch.data import ShardedLoader, SyntheticCorpus
    from repro_torch.distributed import AbstractMesh

    with pytest.raises(ValueError, match="does not divide"):
        ShardedLoader(SyntheticCorpus(100, 8, device="cpu"), 6,
                      mesh=AbstractMesh((4,), ("data",))).next_batch()
    assert DistributedHashTable(hash_range=1 << 10, device="cpu", replicate_hot_keys=2).hot_keys == {}
    pt = DistributedHashTable(hash_range=1 << 10, device="cpu")
    state = pt.init(np.arange(16, dtype=np.uint32))
    q = np.arange(8, dtype=np.uint32)
    assert pt.plan_query(num_queries=8)(state, q).tolist() == [1] * 8
    assert pt.plan_retrieve(state, q)(state, q).counts.tolist() == [1] * 8
    assert join_to_pairs(pt.plan_join(state, q)(state, q)).shape == (8, 2)
    assert int(pt.retrieve_auto(state, q).num_dropped) == 0
    assert int(pt.inner_join_auto(state, q).num_dropped) == 0
    from repro_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    maintenance.fold_oldest(state.insert(q), 1, metrics=reg)
    assert reg.snapshot().value("maintenance_folds_total", {"kind": "fold"}) == 1


def test_query_dispatch_overflow_zeroes_counts_silently_in_both(mesh8):
    """A query batch whose keys overflow a per-(source, owner) dispatch slot
    counts the overflowed rows 0, and ``query`` has no overflow report: the
    reference does so, and the port matches it.  (On a mixed-split stack every
    query is also routed by each delta's own splits, so a small delta's
    noisy splits can trip this.)"""
    p = Pair(mesh8, 8)
    keys = np.arange(4096, dtype=np.uint32)
    p.init(keys)
    owned = _narrow_batch(p.js, HASH_RANGE, p.jt.seed, 128)  # all owned by shard 0
    p.apply("insert", np.concatenate([owned, keys[: 1024 - 128]]))
    queries = np.concatenate([keys[: 7 * 128], owned])  # shard 7's slice: all to shard 0
    got = _np(p.pt.query(p.ps, queries))
    np.testing.assert_array_equal(got, np.asarray(p.jt.query(p.js, jnp.asarray(queries))))
    assert (got[: 7 * 128] >= 1).all()
    assert (got[7 * 128 :] == 0).sum() >= 16  # present keys counted 0, silently
