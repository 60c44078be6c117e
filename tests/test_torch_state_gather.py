"""The port's versioned table against the JAX package: retrieve and join of a
depth-6 stack through the owner and querier gathers, and a stack built by
the JAX package carried across by ``convert``, as ``test_torch_state.py``
holds the rest.  Tolerance: none; every output is an integer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.core import table as jtable
from repro_torch import DistributedHashTable
from repro_torch.core import convert
from test_torch_state import (HASH_RANGE, MESHES, Pair, _mesh, _np, assert_same_reads,
                              assert_same_state, jax_state)
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)


@MESHES
def test_jax_built_stack_reads_the_same_in_the_port(d, request):
    """A stack built and mutated by the JAX package, carried across by
    ``convert.state_from_numpy``, reads the same in the port, and
    ``state_to_numpy`` gives the arrays back."""
    mesh = _mesh(request, d)
    jt = jtable.DistributedHashTable(mesh, ("d",), hash_range=HASH_RANGE, tombstone_capacity=64)
    rng = np.random.default_rng(61)
    keys = rng.integers(0, 1 << 14, 512, dtype=np.uint32)
    js = jt.init(jnp.asarray(keys))
    js = js.insert(jnp.asarray(rng.integers(0, 1 << 14, 16 * d, dtype=np.uint32)))
    js = js.delete(jnp.asarray(keys[:10]))
    js = js.upsert(jnp.asarray(keys[20:25]), jnp.arange(5, dtype=jnp.int32), ttl=4)
    js = js.advance(2)
    for pt in (
        DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu"),
        DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu",
                             paper_faithful_probe=True),
    ):
        ps = convert.state_from_numpy(**jax_state(js), table=pt, device="cpu")
        assert_same_state(ps, js)
        assert ps.now == 2 and ps.epoch == 2
        queries = np.concatenate([keys[:120], rng.integers(0, 1 << 14, 8, dtype=np.uint32)])
        assert_same_reads(pt, ps, jt, js, queries)


def _depth6(p, rng):
    """Base, four inserts, a delete, a fifth insert and an upsert: depth 6
    with tombstones; one key of the base holds 40 duplicates."""
    keys = rng.integers(0, 1 << 13, 512, dtype=np.uint32)
    keys[100:140] = keys[60]
    p.init(keys)
    for i in range(5):
        if i == 4:
            p.apply("delete", keys[:24])
        p.apply("insert", rng.integers(0, 1 << 13, 96, dtype=np.uint32),
                np.arange(1000 * (i + 1), 1000 * (i + 1) + 96, dtype=np.int32))
    p.apply("upsert", keys[30:46], np.arange(9000, 9016, dtype=np.int32))
    assert p.ps.epoch == 6
    return keys


@MESHES
@pytest.mark.parametrize("stack", ["coherent", "mixed-splits"])
def test_retrieve_and_join_through_one_gather_launch_a_side_match_reference(d, stack, request):
    """Retrieve and inner join of a depth-6 stack with tombstones and a
    40-fold duplicate key, through the owner and querier gathers (one launch
    per side per routing round on the card), equal the reference's: at the
    planned capacities, and with capacities too small (truncated segments
    and results, the same ``num_dropped``)."""
    kw = {} if stack == "coherent" else {"coherent_deltas": False}
    p = Pair(_mesh(request, d), d, **kw)
    keys = _depth6(p, np.random.default_rng(61 + d))
    assert p.ps.coherent == (stack == "coherent")
    rng = np.random.default_rng(62)
    q = np.concatenate([keys[:64], rng.integers(0, 1 << 13, 136, dtype=np.uint32)])
    p.check(q)
    jq = jnp.asarray(q)
    for caps in ({"out_capacity": 6, "seg_capacity": 3}, {"out_capacity": 8}):
        got, want = p.pt.retrieve(p.ps, q, **caps), p.jt.retrieve(p.js, jq, **caps)
        for name in ("offsets", "values", "counts"):
            np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)))
        assert int(got.num_dropped) == int(want.num_dropped) > 0
        gj, wj = p.pt.inner_join(p.ps, q, **caps), p.jt.inner_join(p.js, jq, **caps)
        for name in ("query_idx", "values", "num_results"):
            np.testing.assert_array_equal(_np(getattr(gj, name)), np.asarray(getattr(wj, name)))
        assert int(gj.num_dropped) == int(wj.num_dropped) > 0
