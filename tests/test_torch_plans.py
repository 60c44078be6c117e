"""The port's plan objects, per-layer counts and capacity retries against the
JAX package.

The same seeded numpy inputs go through the JAX ``DistributedHashTable``
(mesh1 / mesh8) and the port's (D = 1 / D = 8, ``device="cpu"``):

* ``plan_query`` / ``plan_retrieve`` / ``plan_join`` at u32×1 and at u64×4
  with the fingerprint lane, at depth 0 and at depth 3 with tombstones:
  the resolved statics, and a plan compiled on one state and called on
  another of the same structure, equal the reference's; a state or a batch
  of another structure raises in both packages;
* ``retrieve(per_layer_counts=True)``: ``layer_counts`` equal to the
  reference's, at two exchange rounds on the fused path, and the per-layer
  path of a mixed-split stack gives equal counts at two rounds a layer;
* ``retrieve_auto`` / ``inner_join_auto`` on a batch heavy with duplicates,
  from small caps: the same final caps, results and ``num_dropped``, and
  the same early stop when the drops come from the dispatch.

Tolerance: none; every output is an integer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax
import jax.numpy as jnp

from repro.core import plans as jplans
from repro.core import schema as jschema
from repro.core import table as jtable
from repro_torch import DistributedHashTable, TableSchema, join_to_pairs, retrieval_to_lists
from repro_torch import counting
from repro_torch.core import exchange, multi_hashgraph, plans
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

HASH_RANGE = 1 << 10
LAYOUTS = [
    pytest.param(("uint32", 1), id="u32x1"),
    pytest.param(("uint64", 4), id="u64x4fp"),
]
MESHES = pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    """Drop the reference's compiled programs after every test."""
    yield
    jax.clear_caches()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mesh(request, d):
    return request.getfixturevalue("mesh1" if d == 1 else "mesh8")


def _keys(rng, key_dtype, n, lo=1, hi=1 << 20):
    k = rng.integers(lo, hi, size=n, dtype=np.uint64)
    if key_dtype == "uint32":
        return k.astype(np.uint32)
    return (k << np.uint64(32)) | rng.integers(0, 1 << 32, size=n, dtype=np.uint64)


def _vals(rng, n, cols):
    v = rng.integers(-2**31, 2**31, size=(n, cols), dtype=np.int64).astype(np.int32)
    return v[:, 0].copy() if cols == 1 else v


def _jq(a):
    return a if a.dtype == np.uint64 else jnp.asarray(a)


class Pair:
    """One table per package driven through the same mutations."""

    def __init__(self, mesh, d, layout=("uint32", 1), **kw):
        key_dtype, cols = layout
        self.d, self.key_dtype, self.cols = d, key_dtype, cols
        self.jt = jtable.DistributedHashTable(
            mesh, ("d",), hash_range=HASH_RANGE, schema=jschema.TableSchema(key_dtype, cols), **kw)
        self.pt = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu",
                                       schema=TableSchema(key_dtype, cols), **kw)

    def build(self, seed: int, depth: int):
        """A state at ``depth`` (one delete among the inserts when > 0):
        ``(port state, reference state, pool)``; the same ``depth`` and a
        different ``seed`` give a state of the same structure."""
        rng = np.random.default_rng(seed)
        pool = _keys(rng, self.key_dtype, 64)
        keys = rng.choice(pool, 128 * self.d // 8 * 8 or 128)
        vals = _vals(rng, keys.shape[0], self.cols)
        ps, js = self.pt.init(keys, vals), self.jt.init(_jq(keys), jnp.asarray(vals))
        for i in range(depth):
            ins = rng.choice(pool, 8 * self.d)
            iv = _vals(rng, ins.shape[0], self.cols)
            ps, js = ps.insert(ins, iv), js.insert(_jq(ins), jnp.asarray(iv))
            if i == 0:
                ps, js = ps.delete(pool[:4]), js.delete(_jq(pool[:4]))
        return ps, js, pool

    def queries(self, pool, seed: int, n: int):
        rng = np.random.default_rng(seed)
        absent = _keys(rng, self.key_dtype, n // 4, lo=1 << 21, hi=1 << 22)
        return np.concatenate([rng.choice(pool, n - n // 4), absent])


def _same_retrieval(got, want, per_layer=False):
    for name in ("offsets", "values", "counts"):
        np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.num_dropped) == int(want.num_dropped)
    if per_layer:
        np.testing.assert_array_equal(_np(got.layer_counts), np.asarray(want.layer_counts))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("depth", [0, 3])
@MESHES
def test_plans_compile_on_one_state_and_run_on_another(layout, depth, d, request):
    p = Pair(_mesh(request, d), d, layout)
    ps_a, js_a, pool = p.build(seed=1, depth=depth)
    ps_b, js_b, pool_b = p.build(seed=2, depth=depth)
    assert plans.state_signature(ps_a) == plans.state_signature(ps_b)
    n = 32
    q = p.queries(pool_b, seed=3, n=n)

    # Query: compiled against state A, called on state B.
    qp, jqp = p.pt.plan_query(num_queries=n), p.jt.plan_query(num_queries=n)
    cq, jcq = qp.compile(ps_a), jqp.compile(js_a)
    assert (cq.kind, cq.num_queries) == (jcq.kind, jcq.num_queries) == ("query", n)
    np.testing.assert_array_equal(_np(cq(ps_b, q)), np.asarray(jcq(js_b, js_b.table.schema.pack_keys(q))))
    assert int(qp.join_size(ps_b, q)) == int(jqp.join_size(js_b, _jq(q)))

    # Retrieve and join: capacities from the counts round on a sample.
    rp, jrp = p.pt.plan_retrieve(ps_b, q), p.jt.plan_retrieve(js_b, _jq(q))
    assert (rp.num_queries, rp.out_capacity, rp.seg_capacity) == (
        jrp.num_queries, jrp.out_capacity, jrp.seg_capacity)
    cr, jcr = rp.compile(ps_a), jrp.compile(js_a)
    _same_retrieval(cr(ps_b, q), jcr(js_b, js_b.table.schema.pack_keys(q)))
    jp_, jjp = p.pt.plan_join(ps_b, q), p.jt.plan_join(js_b, _jq(q))
    assert (jp_.out_capacity, jp_.seg_capacity) == (jjp.out_capacity, jjp.seg_capacity)
    np.testing.assert_array_equal(join_to_pairs(jp_(ps_b, q)),
                                  jtable.join_to_pairs(jjp(js_b, _jq(q))))
    for g, w in zip(retrieval_to_lists(rp(ps_b, q)), jtable.retrieval_to_lists(jrp(js_b, _jq(q)))):
        np.testing.assert_array_equal(g, w)

    # Another structure, another batch size: both packages refuse.
    other_p, other_j, _ = p.build(seed=4, depth=depth + 1)
    with pytest.raises(ValueError):
        cq(other_p, q)
    with pytest.raises((TypeError, ValueError)):
        jcq(other_j, other_j.table.schema.pack_keys(q))
    with pytest.raises(ValueError):
        cr(ps_b, q[: n - 8])
    with pytest.raises((TypeError, ValueError)):
        jcr(js_b, js_b.table.schema.pack_keys(q[: n - 8]))
    with pytest.raises(ValueError):
        qp(ps_b, q[: n - 8])
    with pytest.raises(ValueError):
        jqp(js_b, _jq(q[: n - 8]))


def test_plan_statics_need_a_sample_or_both_caps():
    pt = DistributedHashTable(hash_range=HASH_RANGE, device="cpu")
    with pytest.raises(ValueError, match="sample"):
        pt.plan_retrieve(num_queries=8, out_capacity=64)
    plan = pt.plan_join(num_queries=8, out_capacity=60, seg_capacity=3)
    assert (plan.out_capacity, plan.seg_capacity) == (64, 8)
    with pytest.raises(ValueError, match="num_queries"):
        pt.plan_query().compile(pt.init(np.arange(16, dtype=np.uint32)))
    lowered = pt.plan_query(num_queries=16).lower(pt.init(np.arange(16, dtype=np.uint32)))
    assert lowered.compile().num_queries == 16


def _stack(p, coherent_seed):
    rng = np.random.default_rng(coherent_seed)
    keys = rng.integers(1, 1 << 12, 256 * p.d // 8 * 8 or 256, dtype=np.uint32)
    ps, js = p.pt.init(keys), p.jt.init(jnp.asarray(keys))
    for _ in range(3):
        ins = np.concatenate([keys[:4], rng.integers(1, 1 << 12, 8 * p.d - 4, dtype=np.uint32)])
        ps, js = ps.insert(ins), js.insert(jnp.asarray(ins))
    ps, js = ps.delete(keys[4:8]), js.delete(jnp.asarray(keys[4:8]))
    return ps, js, keys


@pytest.mark.parametrize("coherent", [True, False], ids=["fused", "mixed-splits"])
@MESHES
def test_retrieve_per_layer_counts_match_reference(coherent, d, request):
    p = Pair(_mesh(request, d), d, coherent_deltas=coherent)
    ps, js, keys = _stack(p, 7)
    assert ps.coherent == js.coherent == coherent
    q = np.concatenate([keys[:40], np.arange(1 << 13, (1 << 13) + 8, dtype=np.uint32)])
    caps = dict(out_capacity=512, seg_capacity=256)
    with counting.scoped() as scope:
        got = p.pt.retrieve(ps, q, per_layer_counts=True, **caps)
    want = p.jt.retrieve(js, jnp.asarray(q), per_layer_counts=True, **caps)
    _same_retrieval(got, want, per_layer=True)
    lc = _np(got.layer_counts)
    assert lc.shape == (q.shape[0], 4)
    np.testing.assert_array_equal(lc.sum(1), _np(got.counts))
    assert scope.exchange_rounds == (2 if coherent else 2 * 4)
    assert dict(scope.rounds) == {"exchange": scope.exchange_rounds}
    plain = p.pt.retrieve(ps, q, **caps)
    assert plain.layer_counts is None
    _same_retrieval(plain, want)
    # The per-layer path on the same coherent stack gives the same planes.
    if coherent:
        forced = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu",
                                      fused_routing=False)
        with counting.scoped() as scope:
            per = plans.global_retrieval(plans.exec_retrieve(
                forced, ps, forced._pack_queries(q), per_layer_counts=True, **caps))
        assert scope.exchange_rounds == 2 * 4
        np.testing.assert_array_equal(_np(per.layer_counts), lc)


@MESHES
def test_auto_retries_match_reference(d, request):
    """A hot key repeated 24 times a shard from 8-slot caps: the same
    doublings, final caps and results; the join too."""
    p = Pair(_mesh(request, d), d)
    rng = np.random.default_rng(11)
    keys = np.concatenate([rng.integers(1, 1 << 12, 160 * d, dtype=np.uint32),
                           np.full(24 * d, 77, np.uint32)])
    ps, js = p.pt.init(keys), p.jt.init(jnp.asarray(keys))
    q = np.concatenate([np.full(2, 77, np.uint32), keys[:8 * d - 2]])
    got = p.pt.retrieve_auto(ps, q, out_capacity=8, seg_capacity=8)
    want = p.jt.retrieve_auto(js, jnp.asarray(q), out_capacity=8, seg_capacity=8)
    assert got.values.shape == want.values.shape
    _same_retrieval(got, want)
    assert int(got.num_dropped) == 0
    gj = p.pt.inner_join_auto(ps, q, out_capacity=8, seg_capacity=8)
    wj = p.jt.inner_join_auto(js, jnp.asarray(q), out_capacity=8, seg_capacity=8)
    assert gj.values.shape == wj.values.shape
    np.testing.assert_array_equal(join_to_pairs(gj), jtable.join_to_pairs(wj))
    assert int(gj.num_dropped) == int(wj.num_dropped) == 0
    # One doubling short of the need: both stop with the same drops.
    got1 = p.pt.retrieve_auto(ps, q, out_capacity=8, seg_capacity=8, max_retries=1)
    want1 = p.jt.retrieve_auto(js, jnp.asarray(q), out_capacity=8, seg_capacity=8, max_retries=1)
    _same_retrieval(got1, want1)
    assert int(got1.num_dropped) > 0


def test_auto_retry_stops_early_on_dispatch_drops(mesh8):
    """Every query of a shard routed to one owner overflows the dispatch
    slot: doubling the output caps cannot help, so both packages stop after
    one retry with the same drops and caps."""
    p = Pair(mesh8, 8, capacity_slack=1.0)
    rng = np.random.default_rng(13)
    keys = rng.integers(1, 1 << 12, 512, dtype=np.uint32)
    ps, js = p.pt.init(keys), p.jt.init(jnp.asarray(keys))
    q = np.full(512, keys[0], np.uint32)  # 64 a shard, 16 dispatch slots
    calls = []
    real = plans.exec_retrieve

    def spy(*a, **kw):
        calls.append((kw["out_capacity"], kw["seg_capacity"]))
        return real(*a, **kw)

    plans.exec_retrieve = spy
    try:
        got = p.pt.retrieve_auto(ps, q, out_capacity=64, seg_capacity=64)
    finally:
        plans.exec_retrieve = real
    want = p.jt.retrieve_auto(js, jnp.asarray(q), out_capacity=64, seg_capacity=64)
    _same_retrieval(got, want)
    assert int(got.num_dropped) > 0
    assert calls == [(64, 64), (128, 128)]  # one retry, then the early stop
    assert got.values.shape == want.values.shape


def test_fused_retrieve_with_planes_keeps_two_rounds_and_bytes():
    """The planes ride the values' return call: the round count stays at two
    and the bytes grow by exactly the L planes of one shard."""
    pt = DistributedHashTable(num_shards=8, hash_range=HASH_RANGE, device="cpu")
    rng = np.random.default_rng(17)
    ps = pt.init(rng.integers(1, 1 << 12, 512, dtype=np.uint32))
    ps = ps.insert(rng.integers(1, 1 << 12, 64, dtype=np.uint32))
    q = rng.integers(1, 1 << 12, 64, dtype=np.uint32)
    caps = dict(out_capacity=256, seg_capacity=64)
    exchange.CALLS.clear()
    with counting.scoped() as plain:
        pt.retrieve(ps, q, **caps)
    with counting.scoped() as planes:
        pt.retrieve(ps, q, per_layer_counts=True, **caps)
    assert plain.exchange_rounds == planes.exchange_rounds == 2
    assert dict(exchange.CALLS) == {"exchange": 4}
    cap = multi_hashgraph.default_capacity(q.shape[0] // 8, 8, pt.capacity_slack)
    # L = 2 planes of D * capacity int32 counts for each shard.
    assert planes.exchange_bytes - plain.exchange_bytes == 2 * 8 * cap * 4


def test_padding_overflow_is_not_counted(mesh8):
    """A batch of 16 keys padded with EMPTY to 1024 at D = 8: every padding
    row hashes to one owner and overflows its dispatch slot.  The answers
    equal the reference's; the reference counts the padding in
    ``num_dropped``, the port does not (a deliberate difference: padding
    carries no result)."""
    p = Pair(mesh8, 8)
    keys = np.random.default_rng(19).integers(1, 1 << 12, 512, dtype=np.uint32)
    ps, js = p.pt.init(keys), p.jt.init(jnp.asarray(keys))
    q = np.full(1024, 0xFFFFFFFF, np.uint32)
    q[:16] = keys[:16]
    caps = dict(out_capacity=64, seg_capacity=64)
    got = p.pt.retrieve(ps, q, **caps)
    want = p.jt.retrieve(js, jnp.asarray(q), **caps)
    for name in ("offsets", "values", "counts"):
        np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)))
    assert int(want.num_dropped) > 0 and int(got.num_dropped) == 0
    np.testing.assert_array_equal(_np(p.pt.query(ps, q)), np.asarray(p.jt.query(js, jnp.asarray(q))))
