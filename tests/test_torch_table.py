"""The port's table path against the JAX package's, bit for bit, on mesh1 and
mesh8 (D = 1 and D = 8 stacked shards in the port).

Covers build arrays, query/contains, plan capacities, retrieve CSR arrays and
lists, inner-join pairs, join_size, a forced overflow, a JAX-built graph
carried across with ``convert``, and the port's exchange-call budget.  The
JAX side goes through its public API only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.core import table as jtable
from repro_torch import DistributedHashTable, join_to_pairs, retrieval_to_lists
from repro_torch.core import convert, exchange
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

HASH_RANGE = 1 << 12
N_KEYS = 1024
N_QUERIES = 256


def _data(d: int):
    rng = np.random.default_rng(d)
    keys = rng.integers(0, 300, size=N_KEYS, dtype=np.uint32)
    keys[5::97] = 0xFFFFFFFF  # capacity-padding sentinels in the input
    queries = np.concatenate([
        rng.integers(0, 400, size=N_QUERIES - 8, dtype=np.uint32),
        np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFF, 7, 7, 299, 300], np.uint32),
    ])
    values = rng.integers(-2**31, 2**31, size=N_KEYS, dtype=np.int64).astype(np.int32)
    return keys, queries, values


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(port, ref):
    np.testing.assert_array_equal(_np(port), np.asarray(ref))


def _graph_arrays(g) -> dict:
    """A base ``DistributedHashGraph`` of either package as numpy arrays."""
    if hasattr(g.local.keys, "numpy"):
        return convert.graph_to_numpy(g)
    return {
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


@pytest.fixture(scope="module", params=[1, 8], ids=["mesh1", "mesh8"])
def both(request):
    """The same inputs through both packages, with every read computed once."""
    d = request.param
    mesh = request.getfixturevalue("mesh1" if d == 1 else "mesh8")
    keys, queries, values = _data(d)
    jt = jtable.DistributedHashTable(mesh, ("d",), hash_range=HASH_RANGE)
    pt = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu")
    jq, js = jnp.asarray(queries), jt.init(jnp.asarray(keys))
    ps = pt.init(keys)
    out = {"d": d, "keys": keys, "queries": queries, "values": values,
           "jt": jt, "pt": pt, "js": js, "ps": ps}
    out["j_query"] = np.asarray(jt.query(js, jq))
    out["j_caps"] = jt.plan_caps(js, jq)
    out["j_retrieve"] = jt.retrieve(js, jq)
    out["j_join"] = jtable.join_to_pairs(jt.inner_join(js, jq))
    out["j_join_size"] = int(jt.join_size(js, jq))
    out["j_values_graph"] = jt.build(jnp.asarray(keys), jnp.asarray(values))
    return out


def test_build_arrays_match(both):
    want = _graph_arrays(both["js"].base)
    got = convert.graph_to_numpy(both["ps"].base)
    assert set(got) == set(want)
    for name in ("offsets", "keys", "values", "hash_splits"):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("num_dropped", "hash_range", "seed", "local_range_cap", "bucket_stride"):
        assert got[name] == want[name], name


def test_build_with_explicit_values_matches(both):
    got = convert.graph_to_numpy(both["pt"].build(both["keys"], both["values"]))
    want = _graph_arrays(both["j_values_graph"])
    for name in ("offsets", "keys", "values", "hash_splits", "num_dropped"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_query_and_contains_match(both):
    counts = both["pt"].query(both["ps"], both["queries"])
    assert counts.dtype == torch.int32
    _eq(counts, both["j_query"])
    _eq(both["pt"].contains(both["ps"], both["queries"]), both["j_query"] > 0)
    assert int(both["pt"].join_size(both["ps"], both["queries"])) == both["j_join_size"]


def test_plan_caps_match(both):
    assert both["pt"].plan_caps(both["ps"], both["queries"]) == tuple(
        int(c) for c in both["j_caps"]
    )


def test_retrieve_matches(both):
    got = both["pt"].retrieve(both["ps"], both["queries"])
    want = both["j_retrieve"]
    for name in ("offsets", "values", "counts"):
        _eq(getattr(got, name), getattr(want, name))
    assert int(got.num_dropped) == int(want.num_dropped) == 0
    lists_p, lists_j = retrieval_to_lists(got), jtable.retrieval_to_lists(want)
    assert len(lists_p) == len(lists_j) == N_QUERIES
    for a, b in zip(lists_p, lists_j):
        np.testing.assert_array_equal(a, b)


def test_inner_join_matches(both):
    pairs = join_to_pairs(both["pt"].inner_join(both["ps"], both["queries"]))
    np.testing.assert_array_equal(pairs, both["j_join"])
    assert pairs.shape[0] == both["j_join_size"]


@pytest.mark.parametrize("caps", [(64, 8), (512, 16)], ids=["out_and_seg", "seg_only"])
def test_forced_overflow_matches(both, caps):
    out_cap, seg_cap = caps
    jt, pt = both["jt"], both["pt"]
    jq = jnp.asarray(both["queries"])
    want = jt.retrieve(both["js"], jq, out_capacity=out_cap, seg_capacity=seg_cap)
    got = pt.retrieve(both["ps"], both["queries"], out_capacity=out_cap, seg_capacity=seg_cap)
    assert int(got.num_dropped) == int(want.num_dropped) > 0
    for name in ("offsets", "values", "counts"):
        _eq(getattr(got, name), getattr(want, name))
    jj = jt.inner_join(both["js"], jq, out_capacity=out_cap, seg_capacity=seg_cap)
    pj = pt.inner_join(both["ps"], both["queries"], out_capacity=out_cap, seg_capacity=seg_cap)
    assert int(pj.num_dropped) == int(jj.num_dropped) > 0
    for name in ("query_idx", "values", "num_results"):
        _eq(getattr(pj, name), getattr(jj, name))


def test_graph_built_by_jax_reads_the_same_in_the_port(both):
    graph = convert.graph_from_numpy(**_graph_arrays(both["js"].base), device="cpu")
    pt = both["pt"]
    _eq(pt.query(graph, both["queries"]), both["j_query"])
    got = pt.retrieve(graph, both["queries"])
    for name in ("offsets", "values", "counts"):
        _eq(getattr(got, name), getattr(both["j_retrieve"], name))
    back = convert.graph_to_numpy(graph)
    for name, arr in _graph_arrays(both["js"].base).items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


def test_exchange_call_budget(both):
    pt, ps, q = both["pt"], both["ps"], both["queries"]
    exchange.CALLS.clear()
    pt.build(both["keys"])
    assert dict(exchange.CALLS) == {"exchange": 1}
    for run in (
        lambda: pt.query(ps, q),
        lambda: pt.retrieve(ps, q, out_capacity=1024, seg_capacity=512),
        lambda: pt.inner_join(ps, q, out_capacity=1024, seg_capacity=512),
    ):
        exchange.CALLS.clear()
        run()
        assert dict(exchange.CALLS) == {"exchange": 2}
    exchange.CALLS.clear()
    pt.plan_caps(ps, q)
    assert dict(exchange.CALLS) == {"plan_caps": 1}
    exchange.CALLS.clear()
    pt.retrieve(ps, q)  # count-first sizing: its own round, then the two
    assert dict(exchange.CALLS) == {"exchange": 2, "plan_caps": 1}


def test_key_and_query_lengths_must_divide_into_shards():
    pt = DistributedHashTable(num_shards=8, hash_range=HASH_RANGE, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        pt.build(np.arange(12, dtype=np.uint32))
    state = pt.init(np.arange(16, dtype=np.uint32))
    with pytest.raises(ValueError, match="divisible"):
        pt.query(state, np.arange(9, dtype=np.uint32))
