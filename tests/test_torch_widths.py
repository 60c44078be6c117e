"""Key widths and value columns: the port against the JAX package, bit for bit.

The same seeded numpy inputs go through the JAX ``DistributedHashTable``
(mesh1 / mesh8) and the port's (D = 1 / D = 8 stacked shards,
``device="cpu"``) for u32×1 with the fingerprint lane, u32×4, u64×1, u64×2
and u64×4 (the uint64 schemas with the lane on by default).  Every integer
output must match exactly: the hash twins, the build arrays (fingerprints
included), query, contains, retrieve CSR arrays and lists, join pairs and
join_size, then delete, upsert with TTL, the sorted and the probe query at
depth 4, ``fold_oldest(3)`` and ``compact()``; overflow is reported at
every width; a JAX-built u64×4 state with deltas and 2-lane tombstones
carried across by ``convert`` reads the same in the port.  The lifecycles
are in ``test_torch_widths_lifecycle.py`` and the full-range keys in
``test_torch_widths_full_range.py`` (split for the test runner's workers:
each file runs whole on one); the helpers and fixtures here serve them.
Tolerance: none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax
import jax.numpy as jnp

from repro.core import hashing as jhashing
from repro.core import schema as jschema
from repro.core import table as jtable
from repro_torch import DistributedHashTable, TableSchema, join_to_pairs, retrieval_to_lists
from repro_torch.core import convert, exchange, hashing, schema
from repro_torch.core.maintenance import fold_oldest
from repro_torch.kernels import murmur
from test_torch_state import assert_same_state, jax_state
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

HASH_RANGE = 1 << 10
EMPTY64 = np.uint64(2**64 - 1)

# (key dtype, value columns, fingerprint): the five layouts of this slice.
LAYOUTS = [
    pytest.param(("uint32", 1, True), id="u32x1fp"),
    pytest.param(("uint32", 4, None), id="u32x4"),
    pytest.param(("uint64", 1, None), id="u64x1"),
    pytest.param(("uint64", 2, None), id="u64x2"),
    pytest.param(("uint64", 4, None), id="u64x4"),
]
MESHES = pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pool(rng, key_dtype: str, n: int) -> np.ndarray:
    """``n`` distinct keys; the uint64 pool holds pairs sharing a low lane
    and pairs sharing a high lane, and an all-ones low lane."""
    if key_dtype == "uint32":
        return rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), n, replace=False)
    his = rng.choice(np.arange(1, 1 << 20, dtype=np.uint64), n, replace=False)
    keys = (his << np.uint64(32)) | rng.integers(0, 1 << 32, n, dtype=np.uint64)
    keys[1] = (keys[0] & np.uint64(0xFFFFFFFF)) | (np.uint64(7) << np.uint64(32))
    keys[3] = (keys[2] >> np.uint64(32) << np.uint64(32)) | np.uint64(12345)
    keys[4] = np.uint64(0x5_FFFF_FFFF)
    return np.unique(keys)


U32_EDGES = np.array([0x7FFFFFFF, 0x80000000], np.uint32)
U64_EDGES = np.array([0x7FFF_FFFF_FFFF_FFFF, 0x8000_0000_0000_0000, 0xFFFF_FFFE_FFFF_FFFF,
                      2**64 - 2], np.uint64)


def _pool_full(rng, key_dtype: str, n: int) -> np.ndarray:
    """``n`` distinct keys from the top half of the key range (uint32 keys
    at or above 2^31; uint64 keys whose high lane is), with the edge keys
    where the sign-flipped int64 view and the int32 bit patterns turn over."""
    if key_dtype == "uint32":
        keys = rng.integers(2**31, 2**32 - 1, size=n, dtype=np.uint64).astype(np.uint32)
        return np.unique(np.concatenate([keys[: n - 2], U32_EDGES]))
    his = rng.integers(2**31, 2**32, size=n, dtype=np.uint64)
    keys = (his << np.uint64(32)) | rng.integers(0, 2**32, size=n, dtype=np.uint64)
    keys = keys[keys != EMPTY64]
    return np.unique(np.concatenate([keys[: n - 4], U64_EDGES]))


def _values(rng, n: int, cols: int) -> np.ndarray:
    v = rng.integers(-2**31, 2**31, size=(n, cols), dtype=np.int64).astype(np.int32)
    return v[:, 0].copy() if cols == 1 else v


def _inputs(layout, d: int, n: int = 256, seed: int = 0):
    key_dtype, cols, _ = layout
    rng = np.random.default_rng(seed + 7 * d + cols)
    pool = _pool(rng, key_dtype, 96)
    keys = rng.choice(pool, n)
    empty = EMPTY64 if key_dtype == "uint64" else np.uint32(0xFFFFFFFF)
    keys[5::53] = empty  # capacity-padding sentinels in the input
    absent = _pool(np.random.default_rng(seed + 99), key_dtype, 24)
    queries = np.concatenate([rng.choice(pool, 64 - 22 - 2), absent[:22],
                              np.array([empty, keys[0]], keys.dtype)])
    return keys, _values(rng, n, cols), queries, pool


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    """Drop the reference's compiled programs after every test: this module
    compiles several hundred (five layouts, two meshes, states of every
    depth), more than one process's compiler state holds on some hosts."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def tables(mesh1, mesh8):
    """``tables(layout, d, **settings)``: one reference table and one port
    table per layout, mesh and settings, shared by the module's tests (the
    reference's jitted programs are keyed by the table)."""
    made = {}

    def get(layout, d: int, **kw):
        key = (layout, d, tuple(sorted(kw.items())))
        if key not in made:
            key_dtype, cols, fp = layout
            jt = jtable.DistributedHashTable(
                mesh1 if d == 1 else mesh8, ("d",), hash_range=HASH_RANGE,
                schema=jschema.TableSchema(key_dtype, cols), fingerprint=fp, **kw)
            pt = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu",
                                      schema=TableSchema(key_dtype, cols), fingerprint=fp, **kw)
            made[key] = (jt, pt)
        return made[key]

    return get


def _jq(queries):
    """Queries as the reference takes them (uint64 arrays stay numpy: its
    ``pack_keys`` splits them into lanes)."""
    return queries if queries.dtype == np.uint64 else jnp.asarray(queries)


def assert_same_reads(pt, ps, jt, js, queries, probe=None, jprobe=None, join=True):
    """query (and the probe tables' query), retrieve CSR arrays and lists;
    with ``join`` also contains, plan_caps, join pairs and join_size (each
    read is one more compiled program of the reference)."""
    jq = _jq(queries)
    want_counts = np.asarray(jt.query(js, jq))
    np.testing.assert_array_equal(_np(pt.query(ps, queries)), want_counts)
    if probe is not None:
        np.testing.assert_array_equal(_np(probe.query(ps, queries)),
                                      np.asarray(jprobe.query(js, jq)))
    got, want = pt.retrieve(ps, queries), jt.retrieve(js, jq)
    for name in ("offsets", "values", "counts"):
        np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.num_dropped) == int(want.num_dropped) == 0
    for g, w in zip(retrieval_to_lists(got), jtable.retrieval_to_lists(want)):
        np.testing.assert_array_equal(g, w)
    if not join:
        return
    np.testing.assert_array_equal(_np(pt.contains(ps, queries)), want_counts > 0)
    assert pt.plan_caps(ps, queries) == tuple(int(c) for c in jt.plan_caps(js, jq))
    pairs = join_to_pairs(pt.inner_join(ps, queries))
    np.testing.assert_array_equal(pairs, jtable.join_to_pairs(jt.inner_join(js, jq)))
    assert pairs.shape[1] == 1 + pt.schema.value_cols
    assert int(pt.join_size(ps, queries)) == int(jt.join_size(js, jq))


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------


def _u64_edge_keys(n: int) -> np.ndarray:
    rng = np.random.default_rng(3)
    edges = np.array([0, 1, 0xFFFFFFFF, 1 << 32, 2**64 - 2, 2**64 - 1, 0xDEADBEEFCAFEF00D],
                     dtype=np.uint64)
    return np.concatenate([edges, rng.integers(0, 2**63, size=n - edges.shape[0],
                                               dtype=np.uint64)])


@pytest.mark.parametrize("seed", [0, jhashing.DEFAULT_SEED, 12345])
def test_hash_twins_match_reference(seed):
    """murmur3_packed, fingerprint32 and the two-output kernel twin (an
    unaligned count: 1001 keys, EMPTY among them) equal the reference."""
    ks = _u64_edge_keys(1001)
    lanes = schema.pack_u64(ks)
    got = hashing.murmur3_packed(torch.from_numpy(lanes.view(np.int32)), seed, lanes=2)
    want = np.asarray(jhashing.murmur3_packed(jschema.pack_u64(ks), seed=seed))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for key_lanes, host in ((2, lanes), (1, lanes[:, 0])):
        t = torch.from_numpy(np.ascontiguousarray(host).view(np.int32))
        jk = jnp.asarray(host)
        fp = hashing.fingerprint32(t, key_lanes)
        np.testing.assert_array_equal(fp.numpy().view(np.uint32),
                                      np.asarray(jhashing.fingerprint32(jk)))
        b, f = murmur.murmur_hash(t, 1000003, seed, lanes=key_lanes, fingerprint=True)
        np.testing.assert_array_equal(
            b.numpy(), np.asarray(jhashing.hash_to_buckets(jk, 1000003, seed=seed)))
        assert torch.equal(f, fp)
        assert torch.equal(hashing.hash_to_buckets(t, 1000003, seed, key_lanes), b)


def test_pack_u64_roundtrip_and_schema_errors():
    ks = _u64_edge_keys(64)
    np.testing.assert_array_equal(schema.pack_u64(ks), np.asarray(jschema.pack_u64(ks)))
    np.testing.assert_array_equal(schema.unpack_u64(schema.pack_u64(ks)), ks)
    sch = TableSchema("uint64", 3)
    packed = sch.pack_keys(ks, "cpu")
    assert packed.shape == (64, 2) and packed.dtype == torch.int32
    np.testing.assert_array_equal(schema.unpack_u64(packed), ks)
    assert torch.equal(sch.pack_keys(torch.from_numpy(ks.view(np.int64)).view(torch.uint64),
                                     "cpu"), packed)
    with pytest.raises(ValueError):
        sch.pack_keys(np.array([-1], np.int64), "cpu")
    with pytest.raises(ValueError):
        sch.pack_keys(np.arange(4, dtype=np.uint32), "cpu")  # 1-D 32-bit: not packed
    with pytest.raises(ValueError):
        sch.pack_values(np.zeros((4, 2), np.int32), "cpu")
    assert sch.pack_values(np.zeros((4, 3), np.int32), "cpu").shape == (4, 3)
    with pytest.raises(ValueError, match="value columns"):
        DistributedHashTable(hash_range=64, device="cpu", schema=sch).init(ks[:8])
    t = DistributedHashTable(hash_range=64, device="cpu", schema=TableSchema("uint64"))
    assert t.use_fingerprint
    assert not DistributedHashTable(hash_range=64, device="cpu").use_fingerprint


# ---------------------------------------------------------------------------
# build and reads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@MESHES
def test_build_and_reads_match(layout, d, tables):
    keys, vals, queries, _ = _inputs(layout, d)
    jt, pt = tables(layout, d)
    js, ps = jt.init(_jq(keys), jnp.asarray(vals)), pt.init(keys, vals)
    assert ps.base.local.key_lanes == (2 if layout[0] == "uint64" else 1)
    assert ps.base.local.value_cols == layout[1]
    assert (ps.base.local.fingerprints is not None) == (layout[0] == "uint64" or bool(layout[2]))
    assert_same_state(ps, js)
    assert_same_reads(pt, ps, jt, js, queries)


@pytest.mark.parametrize("layout", LAYOUTS)
@MESHES
def test_overflow_reported_every_width(layout, d, tables):
    keys, vals, queries, _ = _inputs(layout, d, seed=2)
    jt, pt = tables(layout, d)
    js, ps = jt.init(_jq(keys), jnp.asarray(vals)), pt.init(keys, vals)
    got = pt.retrieve(ps, queries, out_capacity=8, seg_capacity=8)
    want = jt.retrieve(js, _jq(queries), out_capacity=8, seg_capacity=8)
    assert int(got.num_dropped) == int(want.num_dropped) > 0
    for name in ("offsets", "counts"):
        np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(_np(got.values)[:8], np.asarray(want.values)[:8])


def test_fold_and_retrieve_make_the_fused_budget(tables):
    """A u64×4 stack at depth 2 reads in two exchange calls and folds in none."""
    layout = ("uint64", 4, None)
    keys, vals, queries, pool = _inputs(layout, 8, seed=3)
    _, pt = tables(layout, 8)
    ps = pt.init(keys, vals).insert(pool[:8], _values(np.random.default_rng(0), 8, 4))
    ps = ps.delete(pool[8:10])
    exchange.CALLS.clear()
    pt.retrieve(ps, queries, out_capacity=512, seg_capacity=256)
    assert dict(exchange.CALLS) == {"exchange": 2}
    exchange.CALLS.clear()
    fold_oldest(ps, 1)
    assert dict(exchange.CALLS) == {}


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


@MESHES
def test_convert_round_trip_u64x4(d, tables):
    """A JAX-built u64×4 state with deltas and 2-lane tombstones, carried
    across by ``convert``, reads the same in the port and round-trips."""
    layout = ("uint64", 4, None)
    keys, vals, queries, pool = _inputs(layout, d, seed=4)
    jt, pt = tables(layout, d, tombstone_capacity=64)
    rng = np.random.default_rng(11)
    js = jt.init(keys, jnp.asarray(vals))
    js = js.insert(rng.choice(pool, 8 * d), jnp.asarray(_values(rng, 8 * d, 4)))
    js = js.delete(pool[:4])
    js = js.upsert(pool[4:7], jnp.asarray(_values(rng, 3, 4)), ttl=2)
    arrays = jax_state(js)
    assert arrays["tombstones"]["keys"].shape == (64, 2)
    assert arrays["base"]["fingerprints"].shape == (arrays["base"]["keys"].shape[0],)
    ps = convert.state_from_numpy(**arrays, table=pt, device="cpu")
    assert_same_state(ps, js)
    assert_same_reads(pt, ps, jt, js, queries)
    back = convert.state_to_numpy(ps)
    for g, w in zip([back["base"], *back["deltas"]], [arrays["base"], *arrays["deltas"]]):
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
