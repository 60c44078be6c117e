"""Key widths and value columns: keys from the top of the key range (the top
bit of the key or of its high lane set, and the edge keys) through the
build, the reads and the versioned lifecycle, in the port against the JAX
package, bit for bit, as ``test_torch_widths.py`` holds the rest.
Tolerance: none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.core.maintenance import fold_oldest as jfold_oldest
from repro_torch.core.maintenance import fold_oldest
from test_torch_state import assert_same_state
from test_torch_widths import (  # noqa: F401  (the fixtures are used by name)
    U32_EDGES, U64_EDGES, _jq, _pool_full, _release_compiled_programs, _values,
    assert_same_reads, tables)
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)


# ---------------------------------------------------------------------------
# full-range keys
# ---------------------------------------------------------------------------

FULL_RANGE = [
    pytest.param(("uint32", 1, True), 1, id="mesh1-u32x1fp"),
    pytest.param(("uint32", 1, True), 8, id="mesh8-u32x1fp"),
    pytest.param(("uint64", 2, None), 1, id="mesh1-u64x2"),
    pytest.param(("uint64", 2, None), 8, id="mesh8-u64x2"),
]


@pytest.mark.parametrize("layout, d", FULL_RANGE)
def test_full_range_keys_match(layout, d, tables):
    """Keys from ``_pool_full`` (the top bit of the key or of its high lane
    set, and the edge keys): the build, the reads (every edge key among the
    queries), delete, upsert with TTL, inserts to depth 4 read by the sorted
    and the probe query, ``fold_oldest(3)`` and ``compact()`` give the
    reference's arrays and reads."""
    key_dtype, cols, _ = layout
    rng = np.random.default_rng(6 + d)
    pool = _pool_full(rng, key_dtype, 96)
    edges = U32_EDGES if key_dtype == "uint32" else U64_EDGES
    keys = np.concatenate([rng.choice(pool, 256 - edges.shape[0]), edges])
    vals = _values(rng, keys.shape[0], cols)
    absent = _pool_full(np.random.default_rng(99), key_dtype, 16)
    absent = absent[~np.isin(absent, pool)]
    queries = np.concatenate([rng.choice(pool, 40), absent[:16], edges])
    queries = np.concatenate([queries, pool[: 64 - queries.shape[0]]])
    jt, pt = tables(layout, d, tombstone_capacity=64)
    jp, pp = tables(layout, d, paper_faithful_probe=True)
    js, ps = jt.init(_jq(keys), jnp.asarray(vals)), pt.init(keys, vals)
    assert_same_state(ps, js)
    assert_same_reads(pt, ps, jt, js, queries)

    def both(op, *args, **kw):
        nonlocal js, ps
        jargs = [_jq(a) if isinstance(a, np.ndarray) and a.dtype.kind == "u" else
                 jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        js = getattr(js, op)(*jargs, **kw)
        ps = getattr(ps, op)(*args, **kw)
        assert_same_state(ps, js)

    both("insert", rng.choice(pool, 8 * d), _values(rng, 8 * d, cols))
    both("delete", np.concatenate([edges[:1], pool[:5]]))
    both("upsert", np.concatenate([edges[1:], pool[6:9]]), _values(rng, edges.shape[0] + 2, cols),
         ttl=3)
    both("insert", edges[:1].repeat(8 * d), _values(rng, 8 * d, cols))  # reinsert a deleted edge
    both("advance", 3)
    both("insert", rng.choice(pool, 8 * d), _values(rng, 8 * d, cols))
    assert ps.epoch == js.epoch == 4
    assert_same_reads(pt, ps, jt, js, queries, pp, jp, join=False)
    pf = fold_oldest(ps, 3)
    jf = jfold_oldest(js, 3)
    assert_same_state(pf, jf)
    assert_same_state(pf.compact(), jf.compact())
