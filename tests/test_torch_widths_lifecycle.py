"""Key widths and value columns: each layout's versioned lifecycle in the port
against the JAX package, bit for bit (delete, upsert with TTL, inserts to
depth 4 read by the sorted and the probe query, ``fold_oldest(3)`` and
``compact()``), as ``test_torch_widths.py`` holds the builds and reads.
Tolerance: none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.core.maintenance import fold_oldest as jfold_oldest
from repro_torch import retrieval_to_lists
from repro_torch.core.maintenance import fold_oldest
from test_torch_state import assert_same_state
from test_torch_widths import (  # noqa: F401  (the fixtures are used by name)
    _inputs, _jq, _np, _release_compiled_programs, _values, assert_same_reads, tables)
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)


def _multisets(pt, ps, queries):
    """Counts and each query's sorted value rows: what a fold or a
    compaction must leave as it was."""
    r = pt.retrieve(ps, queries)
    cols = pt.schema.value_cols
    lists = [sorted(map(tuple, np.asarray(v).reshape(len(v), cols).tolist()))
             for v in retrieval_to_lists(r)]
    return _np(pt.query(ps, queries)), _np(r.counts), lists


# Each layout once against the reference's whole lifecycle, u64×4 on both
# meshes (the reference compiles a program per state and read, ~15 s a case).
LIFECYCLES = [
    pytest.param(("uint32", 1, True), 8, id="mesh8-u32x1fp"),
    pytest.param(("uint32", 4, None), 1, id="mesh1-u32x4"),
    pytest.param(("uint64", 1, None), 8, id="mesh8-u64x1"),
    pytest.param(("uint64", 2, None), 1, id="mesh1-u64x2"),
    pytest.param(("uint64", 4, None), 1, id="mesh1-u64x4"),
    pytest.param(("uint64", 4, None), 8, id="mesh8-u64x4"),
]


@pytest.mark.parametrize("layout, d", LIFECYCLES)
def test_lifecycle_matches(layout, d, tables):
    """delete, upsert with TTL, inserts to depth 4 read by the sorted and the
    probe query, ``fold_oldest(3)`` and ``compact()``: the same state arrays
    after every step, the same reads at depth 4, and after the fold and the
    compaction the same counts and value multisets as at depth 4."""
    keys, vals, queries, pool = _inputs(layout, d, seed=1)
    jt, pt = tables(layout, d, tombstone_capacity=64)
    jp, pp = tables(layout, d, paper_faithful_probe=True)
    js, ps = jt.init(_jq(keys), jnp.asarray(vals)), pt.init(keys, vals)
    rng = np.random.default_rng(5 + d)
    cols = layout[1]

    def both(op, *args, **kw):
        nonlocal js, ps
        jargs = [_jq(a) if isinstance(a, np.ndarray) and a.dtype.kind == "u" else
                 jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        js = getattr(js, op)(*jargs, **kw)
        ps = getattr(ps, op)(*args, **kw)
        assert_same_state(ps, js)

    both("insert", rng.choice(pool, 8 * d), _values(rng, 8 * d, cols))
    both("delete", pool[:6])
    both("upsert", pool[6:11], _values(rng, 5, cols), ttl=3)
    both("insert", pool[:2].repeat(4 * d), _values(rng, 8 * d, cols))  # reinsert deleted keys
    both("advance", 3)  # the TTL entries take effect
    both("insert", rng.choice(pool, 8 * d), _values(rng, 8 * d, cols))
    assert ps.epoch == js.epoch == 4
    assert_same_reads(pt, ps, jt, js, queries, pp, jp)
    live = _multisets(pt, ps, queries)
    probe_counts = _np(pp.query(ps, queries))
    jf, pf = jfold_oldest(js, 3), fold_oldest(ps, 3)
    assert pf.epoch == jf.epoch == 1
    assert_same_state(pf, jf)
    pc = pf.compact()
    assert_same_state(pc, jf.compact())
    for st in (pf, pc):
        got = _multisets(pt, st, queries)
        np.testing.assert_array_equal(got[0], live[0])
        np.testing.assert_array_equal(got[1], live[1])
        assert got[2] == live[2]
        np.testing.assert_array_equal(_np(pp.query(st, queries)), probe_counts)
