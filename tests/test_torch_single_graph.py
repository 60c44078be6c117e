"""The single-card HashGraph API (Alg. 1) against the JAX package, bit for bit.

The same seeded numpy keys (full range: uint32 keys at or above 2^31 and
the edge keys, uint64 keys with high lanes at or above 2^31) go through
``repro.core.hashgraph`` and ``repro_torch.core.hashgraph`` at u32×1 and
u64×2, with and without the fingerprint lane: ``build``'s CSR offsets,
keys, values and fingerprints, ``bucket_of``, ``query_count_sorted``,
``contains``, ``lookup_first``, ``retrieve`` and ``inner_join`` (exact
capacity and overflow), ``intersect_join_size``, ``num_valid`` and
``capacity``; and the ``sort_within_bucket=False`` layout with its linear
probe.  Tolerance: none; every output is an integer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import hashgraph as jhg
from repro_torch.core import hashgraph
from repro_torch.core.schema import pack_u64
from test_torch_widths import _pool_full

TABLE_SIZE = 64
SEED = 0x1234
# (key dtype, fingerprint): the lane off and on at each width.
LAYOUTS = [
    pytest.param(("uint32", None), id="u32x1"),
    pytest.param(("uint32", True), id="u32x1fp"),
    pytest.param(("uint64", None), id="u64x2fp"),
    pytest.param(("uint64", False), id="u64x2"),
]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _u32(x) -> np.ndarray:
    """Key arrays of either package as uint32 lanes."""
    return _np(x).view(np.uint32) if _np(x).dtype == np.int32 else np.asarray(x)


def _inputs(key_dtype: str, cols: int = 1):
    """``(keys, values, queries, second)`` host arrays: 300 rows drawn with
    repeats from 120 full-range keys (uint32, or uint64 as (N, 2) lanes),
    values ``(300,)`` or ``(300, cols)``, queries of the pool plus 40
    absent keys, and a second key set of 96 rows for the join size."""
    rng = np.random.default_rng(7 + cols)
    pool = _pool_full(rng, key_dtype, 160)
    present, absent = pool[:120], pool[120:]
    keys = present[rng.integers(0, 120, 300)]
    vals = np.arange(300, dtype=np.int32) * 3 + 1
    if cols > 1:
        vals = np.stack([vals] + [vals * 7 + c for c in range(1, cols)], axis=1).astype(np.int32)
    queries = np.concatenate([present, absent])
    second = pool[rng.integers(0, 160, 96)]
    if key_dtype == "uint64":
        keys, queries, second = pack_u64(keys), pack_u64(queries), pack_u64(second)
    return keys, vals, queries, second


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32) if a.dtype == np.uint32 else a)


def _builds(keys, vals, fingerprint, sort=True):
    j = jhg.build(jnp.asarray(keys), TABLE_SIZE, jnp.asarray(vals), seed=SEED,
                  sort_within_bucket=sort, fingerprint=fingerprint)
    p = hashgraph.build(_t(keys), TABLE_SIZE, _t(vals), seed=SEED, sort_within_bucket=sort,
                        fingerprint=fingerprint)
    return j, p


def _assert_same_graph(j, p):
    np.testing.assert_array_equal(_np(p.offsets)[0], np.asarray(j.offsets))
    np.testing.assert_array_equal(_u32(p.keys[0]), np.asarray(j.keys))
    np.testing.assert_array_equal(_np(p.values)[0], np.asarray(j.values))
    assert (p.fingerprints is None) == (j.fingerprints is None)
    if j.fingerprints is not None:
        np.testing.assert_array_equal(_u32(p.fingerprints[0]), np.asarray(j.fingerprints))
    assert p.sorted_within_bucket == j.sorted_within_bucket
    assert p.capacity == j.capacity and int(p.num_valid) == int(j.num_valid)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_single_graph_matches_reference(layout):
    key_dtype, fingerprint = layout
    keys, vals, queries, second = _inputs(key_dtype)
    j, p = _builds(keys, vals, fingerprint)
    _assert_same_graph(j, p)
    jq, pq = jnp.asarray(queries), _t(queries)
    np.testing.assert_array_equal(_np(p.bucket_of(pq)), np.asarray(j.bucket_of(jq)))
    np.testing.assert_array_equal(_np(hashgraph.query_count_sorted(p, pq)),
                                  np.asarray(jhg.query_count_sorted(j, jq)))
    np.testing.assert_array_equal(_np(hashgraph.contains(p, pq)), np.asarray(jhg.contains(j, jq)))
    np.testing.assert_array_equal(_np(hashgraph.lookup_first(p, pq)),
                                  np.asarray(jhg.lookup_first(j, jq)))
    total = int(jhg.query_count_sorted(j, jq).sum())
    assert total > 300 - 8  # nearly every row is matched by some query
    for cap in (total, total // 3):  # exact, and overflow reported
        got, want = hashgraph.retrieve(p, pq, capacity=cap), jhg.retrieve(j, jq, capacity=cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        got, want = hashgraph.inner_join(p, pq, capacity=cap), jhg.inner_join(j, jq, capacity=cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    j2, p2 = _builds(second, np.arange(96, dtype=np.int32), fingerprint)
    assert int(hashgraph.intersect_join_size(p, p2)) == int(jhg.intersect_join_size(j, j2))
    assert int(hashgraph.intersect_join_size(p2, p)) == int(jhg.intersect_join_size(j2, j))


@pytest.mark.parametrize("key_dtype", ["uint32", "uint64"])
def test_single_graph_value_columns_and_default_values(key_dtype):
    keys, vals, queries, _ = _inputs(key_dtype, cols=3)
    j, p = _builds(keys, vals, None)
    _assert_same_graph(j, p)
    jq, pq = jnp.asarray(queries), _t(queries)
    np.testing.assert_array_equal(_np(hashgraph.lookup_first(p, pq)),
                                  np.asarray(jhg.lookup_first(j, jq)))
    for g, w in zip(hashgraph.retrieve(p, pq, capacity=512), jhg.retrieve(j, jq, capacity=512)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    # values=None: the row ids
    j = jhg.build(jnp.asarray(keys), TABLE_SIZE, seed=SEED)
    p = hashgraph.build(_t(keys), TABLE_SIZE, seed=SEED)
    _assert_same_graph(j, p)


@pytest.mark.parametrize("key_dtype", ["uint32", "uint64"])
def test_unsorted_buckets_keep_input_order(key_dtype):
    keys, vals, queries, _ = _inputs(key_dtype)
    j, p = _builds(keys, vals, None, sort=False)
    _assert_same_graph(j, p)
    assert p.fingerprints is None
    jq, pq = jnp.asarray(queries), _t(queries)
    np.testing.assert_array_equal(_np(hashgraph.query_count_probe(p, pq, max_probe=64)),
                                  np.asarray(jhg.query_count_probe(j, jq, max_probe=64)))
    for fn in (hashgraph.query_count_sorted, hashgraph.lookup_first):
        with pytest.raises(ValueError, match="bucket-sorted"):
            fn(p, pq)


def test_stacked_graph_refuses_unstacked_queries():
    keys, vals, queries, _ = _inputs("uint32")
    p = hashgraph.build(_t(keys), TABLE_SIZE, _t(vals), seed=SEED)
    two = hashgraph.build_from_buckets(
        torch.cat([p.keys, p.keys]), torch.zeros((2, 300), dtype=torch.int32), TABLE_SIZE,
        torch.cat([p.values, p.values]),
    )
    with pytest.raises(ValueError, match="one-shard"):
        hashgraph.contains(two, _t(queries))
    with pytest.raises(ValueError, match="one-shard"):
        hashgraph.retrieve(two, _t(queries).reshape(2, -1), capacity=8)
