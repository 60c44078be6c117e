"""Hot-key replication against the JAX package, bit for bit.

The reference's ``test_hot_key_replication_zipf`` (a base of 256 keys, one
zipfian batch of 512 rows over 64 key ids, ``capacity_slack = 2.0``,
``replicate_hot_keys = 4``) goes through both packages at D = 8 for theta
0.99 and 1.2, and at u64×2: the ``hot_keys`` registries, the states (the
delta's arrays included), ``skew_fallbacks``, the merged counts against a
numpy tally, the counts, retrieves and states after ``fold_oldest(1)`` and
after ``compact()``, and every read of ``assert_same_reads`` after the
insert (``retrieve``, ``inner_join`` and ``join_size`` see replica 0 only,
in both).  A query
makes one routed round per replica rank.  At D = 1 no key can exceed the
dispatch slot at a slack of 2.0; at 0.1 the head goes hot, R clamps to 2 and
both packages count every key on both rounds (both reach shard 0).  The
per-row offsets (occurrence rank mod R over the whole batch) are held
directly.  Tolerance: none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.cache import ZipfianGenerator as JZipf
from repro.core.maintenance import fold_oldest as jfold_oldest
from repro.core.schema import TableSchema as JSchema
from repro.core.table import DistributedHashTable as JTable
from repro_torch import DistributedHashTable, TableSchema, counting
from repro_torch.cache import ZipfianGenerator
from repro_torch.core.maintenance import fold_oldest
from repro_torch.core.schema import pack_u64
from test_torch_state import HASH_RANGE, Pair, _mesh, _np, assert_same_reads, assert_same_state
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

EMPTY = np.uint32(0xFFFFFFFF)


def _zipf_batch(theta: float, wide: bool):
    """The reference test's batch: 512 zipfian rows over 64 key ids, keys
    disjoint from the base's; for u64×2 the same ids with a high lane at or
    above 2^31.  Returns ``(batch, ids)``: table keys and the key ids."""
    ranks = JZipf(64, theta=theta, seed=5).sample(512)
    np.testing.assert_array_equal(ZipfianGenerator(64, theta=theta, seed=5).sample(512), ranks)
    ids = (ranks + 1).astype(np.uint32) * np.uint32(3) + np.uint32(1 << 14)
    if not wide:
        return ids, ids
    keys = ((np.uint64(0x8000_0000) + ids.astype(np.uint64)) << np.uint64(32)) | ids
    return pack_u64(keys), ids


def _base(wide: bool):
    base = np.arange(1, 257, dtype=np.uint32)
    return (pack_u64(base.astype(np.uint64)) if wide else base), base


# One table pair per configuration, its registries cleared for each case:
# the reference compiles its programs once per table.
_PAIRS = {}


def _pair(request, d: int, wide: bool, slack: float) -> Pair:
    key = (d, wide, slack)
    if key not in _PAIRS:
        kw = dict(capacity_slack=slack, replicate_hot_keys=4)
        mesh = _mesh(request, d)
        p = Pair(mesh, d, **kw)
        if wide:
            p.jt = JTable(mesh, ("d",), hash_range=HASH_RANGE, schema=JSchema("uint64", 1), **kw)
            p.pt = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu",
                                        schema=TableSchema("uint64", 1), **kw)
        _PAIRS[key] = p
    p = _PAIRS[key]
    for t in (p.jt, p.pt):
        t.hot_keys.clear()
        t.skew_fallbacks = 0
    return p


CASES = [
    pytest.param(8, 0.99, False, 2.0, id="mesh8-theta0.99"),
    pytest.param(8, 1.2, False, 2.0, id="mesh8-theta1.2"),
    pytest.param(8, 1.2, True, 2.0, id="mesh8-theta1.2-u64x2"),
    pytest.param(1, 1.2, False, 2.0, id="mesh1-theta1.2"),
    pytest.param(1, 1.2, False, 0.1, id="mesh1-theta1.2-slack0.1"),
]


@pytest.mark.parametrize("d,theta,wide,slack", CASES)
def test_hot_key_replication_zipf(request, d, theta, wide, slack):
    p = _pair(request, d, wide, slack)
    base_keys, base_ids = _base(wide)
    p.init(base_keys, np.arange(256, dtype=np.int32))
    batch, ids = _zipf_batch(theta, wide)
    p.apply("insert", batch, np.arange(512, dtype=np.int32))

    assert p.pt.hot_keys == p.jt.hot_keys
    assert p.pt.skew_fallbacks == p.jt.skew_fallbacks
    assert int(p.ps.num_dropped) == int(p.js.num_dropped)
    uniq, first, want = np.unique(ids, return_index=True, return_counts=True)
    if d == 8:
        assert p.pt.hot_keys, "the zipf head never went hot"
        assert set(p.pt.hot_keys.values()) == {4}
        assert p.pt.skew_fallbacks == 0 and int(p.ps.num_dropped) == 0
    elif slack == 2.0:
        assert p.pt.hot_keys == {}
    else:
        assert set(p.pt.hot_keys.values()) == {2}  # R = max(2, min(4, D))
    rounds = max(p.pt.hot_keys.values(), default=1)

    # Unique keys padded with base keys (no EMPTY padding: the packages
    # count an EMPTY query's dispatch overflow differently).
    uq = batch[first]
    pad = (-len(uq)) % 8
    queries = np.concatenate([uq, base_keys[200: 200 + pad]])
    others = base_keys[200:232]
    assert_same_reads(p.pt, p.ps, p.jt, p.js, queries)
    for st_p, st_j in ((p.ps, p.js),
                       (fold_oldest(p.ps, 1), jfold_oldest(p.js, 1)),
                       (p.ps.compact(), p.js.compact())):
        assert_same_state(st_p, st_j)
        got = _np(p.pt.query(st_p, queries))
        np.testing.assert_array_equal(got, np.asarray(p.jt.query(st_j, jnp.asarray(queries))))
        got_r, want_r = p.pt.retrieve(st_p, queries), p.jt.retrieve(st_j, jnp.asarray(queries))
        np.testing.assert_array_equal(_np(got_r.values), np.asarray(want_r.values))
        np.testing.assert_array_equal(_np(got_r.offsets), np.asarray(want_r.offsets))
        got = got[: len(uq)]
        if d == 8:
            np.testing.assert_array_equal(got, want.astype(np.int32))
            np.testing.assert_array_equal(_np(p.pt.query(st_p, others)), np.ones(32, np.int32))
        else:  # every round reaches the one shard
            assert int(got.sum()) <= rounds * 512
    # A dispatch and a combine per replica rank (per layer on a stack the
    # skew guard left mixed-split).
    per_rank = 2 if p.ps.coherent else 2 * len(p.ps.layers)
    with counting.scoped() as scope:
        p.pt.contains(p.ps, others[:8])
    assert scope.exchange_rounds == per_rank * rounds


@pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])
def test_hot_key_offsets_are_occurrence_ranks(request, d):
    p = Pair(_mesh(request, d), d, capacity_slack=0.1, replicate_hot_keys=3)
    rng = np.random.default_rng(3 + d)
    n = 256
    keys = rng.integers(1, 1 << 20, n, dtype=np.uint32)
    keys[rng.random(n) < 0.5] = 77  # hot
    keys[rng.random(n) < 0.3] = 0xFFFF_FFF0  # hot, top bit set
    keys[rng.random(n) < 0.05] = EMPTY  # never hot
    want = p.jt._hot_key_offsets(jnp.asarray(keys))
    got = p.pt._hot_key_offsets(torch.from_numpy(keys.view(np.int32)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert p.pt.hot_keys == p.jt.hot_keys
    assert set(p.pt.hot_keys) == {(77,), (0xFFFF_FFF0,)}
    r = max(2, min(3, d))
    for key in (77, 0xFFFF_FFF0):
        rows = np.nonzero(keys == key)[0]
        np.testing.assert_array_equal(_np(got)[rows], np.arange(len(rows)) % r)
    cold = p.pt._hot_key_offsets(torch.arange(n, dtype=torch.int32))
    assert cold is None and p.jt._hot_key_offsets(jnp.arange(n, dtype=jnp.uint32)) is None
