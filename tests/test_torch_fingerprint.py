"""The fingerprint probe lane: engineered collisions, the port against the JAX
package, bit for bit.

Mirrors ``tests/test_fingerprint.py`` for the port.  For 2-lane keys the
suite mines a true fingerprint collision (two uint64 keys differing in both
lanes with one 32-bit fingerprint) from a seeded pool with the port's plain
``fingerprint32`` and checks the reference agrees; it adds a pair sharing
the low lane and a pair sharing the high lane (distinct fingerprints, one
lane all that separates them inside a sorted bucket).  For 1-lane keys the
fingerprint is a bijection of the key, so the pairs are plain distinct keys
(the u32×1 layout with ``fingerprint=True``).  Each case runs at D = 1 and
D = 8 (``mesh1`` / ``mesh8``): the same build arrays (fingerprints
included), counts, retrieve CSR arrays and value multisets as the reference
and a dict oracle, the forced full-key path giving the same answers, then a
delete, a ``fold_oldest`` across the deleted epoch, a reinsert and a
compaction.  Tolerance: none.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax
import jax.numpy as jnp

from repro.core import hashing as jhashing
from repro.core import schema as jschema
from repro.core import table as jtable
from repro.core.maintenance import fold_oldest as jfold_oldest
from repro_torch import DistributedHashTable, TableSchema, retrieval_to_lists
from repro_torch.core import convert, hashing, schema
from repro_torch.core.maintenance import fold_oldest
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

KEY_DTYPES = pytest.mark.parametrize("key_dtype", ["uint32", "uint64"], ids=["u32x1", "u64x2"])
MESHES = pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    """Drop the reference's compiled programs after every test (see
    ``test_torch_widths``)."""
    yield
    jax.clear_caches()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _adversarial_pairs(key_dtype: str):
    """(collision pair, equal-low-lane pair, equal-high-lane pair)."""
    if key_dtype == "uint32":
        return ((0x0000BEEF, 0x0001BEEF), (3, 0x10003), (5, 0x20005))
    rng = np.random.default_rng(0xF1D0)
    raw = np.unique(rng.integers(0, 1 << 63, size=1 << 19, dtype=np.uint64))
    lanes = torch.from_numpy(schema.pack_u64(raw).view(np.int32))
    fp = hashing.fingerprint32(lanes, 2).numpy()
    order = np.argsort(fp, kind="stable")
    dup = np.flatnonzero(fp[order][1:] == fp[order][:-1])
    assert dup.shape[0] > 0, "collision mining failed: widen the pool"
    k1, k2 = sorted((int(raw[order[dup[0]]]), int(raw[order[dup[0] + 1]])))
    pair = jschema.pack_u64(np.array([k1, k2], np.uint64))
    jfp = np.asarray(jhashing.fingerprint32(pair))
    assert k1 != k2 and jfp[0] == jfp[1] == np.uint32(fp[order[dup[0]]])
    return ((k1, k2), (0x7_0000_1111, 0xBAD_0000_1111),
            (0x7777_0000_0000_0003, 0x7777_0000_0000_0009))


def _values(start: int, n: int, cols: int) -> np.ndarray:
    v = (start + np.arange(n * cols, dtype=np.int32)).reshape(n, cols)
    return v[:, 0].copy() if cols == 1 else v


def _rows(v) -> list:
    v = np.asarray(v)
    return [tuple(np.atleast_1d(r).tolist()) for r in v]


def _pair(key_dtype: str, d: int, request, fingerprint=True, **kw):
    cols = 1 if key_dtype == "uint32" else 2
    mesh = request.getfixturevalue("mesh1" if d == 1 else "mesh8")
    # A multiplicity-700 key routes every copy to one owner: generous slack.
    kw = dict(hash_range=1 << 12, capacity_slack=6.0, fingerprint=fingerprint, **kw)
    jt = jtable.DistributedHashTable(mesh, ("d",), schema=jschema.TableSchema(key_dtype, cols),
                                     **kw)
    pt = DistributedHashTable(num_shards=d, device="cpu", schema=TableSchema(key_dtype, cols),
                              **kw)
    return jt, pt, cols


def _jkeys(a: np.ndarray):
    return a if a.dtype == np.uint64 else jnp.asarray(a)


def _graph(g) -> dict:
    return {"offsets": g.local.offsets, "keys": g.local.keys, "values": g.local.values,
            "fingerprints": g.local.fingerprints, "hash_splits": g.hash_splits}


def _same_graph(pg, jg):
    got = convert.graph_to_numpy(pg)
    for name, want in _graph(jg).items():
        np.testing.assert_array_equal(got[name], np.asarray(want), err_msg=name)


@KEY_DTYPES
@MESHES
def test_engineered_collisions_match(key_dtype, d, request):
    """Adversarial keys at multiplicity up to 1000: the reference's build
    arrays, counts and retrieve, the dict oracle's value multisets, and the
    forced full-key path answering the same."""
    (k1, k2), (la, lb), (ha, hb) = _adversarial_pairs(key_dtype)
    special = [(k1, 700), (k2, 300), (la, 17), (lb, 9), (ha, 5), (hb, 3)]
    rng = np.random.default_rng(3)
    lo, hi = (1 << 33, 1 << 34) if key_dtype == "uint64" else (1 << 20, 1 << 31)
    noise = rng.integers(lo, hi, size=2048 - sum(m for _, m in special)).astype(np.uint64)
    host = np.concatenate([
        np.repeat(np.asarray([k for k, _ in special], np.uint64), [m for _, m in special]),
        noise,
    ]).astype(key_dtype)
    jt, pt, cols = _pair(key_dtype, d, request)
    values = _values(0, host.shape[0], cols)
    perm = np.random.default_rng(7).permutation(host.shape[0])  # spread hot copies over senders
    host, values = host[perm], values[perm]
    expect: dict = {}
    for k, v in zip(host.tolist(), _rows(values)):
        expect.setdefault(int(k), []).append(v)
    queries = np.asarray([k1, k2, la, lb, ha, hb, k1 + 5, noise[0]], dtype=key_dtype)
    want = np.asarray([len(expect.get(int(q), [])) for q in queries], np.int32)
    assert want[0] == 700 and want[1] == 300

    js = jt.init(_jkeys(host), jnp.asarray(values))
    ps = pt.init(host, values)
    assert int(ps.num_dropped) == 0 and ps.base.local.fingerprints is not None
    _same_graph(ps.base, js.base)
    counts = _np(pt.query(ps, queries))
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(counts, np.asarray(jt.query(js, _jkeys(queries))))
    r, jr = pt.retrieve(ps, queries), jt.retrieve(js, _jkeys(queries))
    for name in ("offsets", "values", "counts"):
        np.testing.assert_array_equal(_np(getattr(r, name)), np.asarray(getattr(jr, name)))
    for i, got in enumerate(retrieval_to_lists(r)):
        assert sorted(_rows(got)) == sorted(expect.get(int(queries[i]), [])), f"query {i}"

    _, plain, _ = _pair(key_dtype, d, request, fingerprint=False)
    pst = plain.init(host, values)
    assert pst.base.local.fingerprints is None
    np.testing.assert_array_equal(_np(plain.query(pst, queries)), want)
    r_plain = plain.retrieve(pst, queries)
    for name in ("offsets", "values", "counts"):
        np.testing.assert_array_equal(_np(getattr(r_plain, name)), _np(getattr(r, name)),
                                      err_msg=f"the fingerprint path diverged on {name}")


@KEY_DTYPES
@MESHES
def test_collision_delete_reinsert_across_fold(key_dtype, d, request):
    """Tombstone one colliding key, fold its epoch away, reinsert it and
    compact: the same state arrays as the reference after every step, and
    the collision partner intact throughout."""
    (k1, k2), (la, lb), (ha, hb) = _adversarial_pairs(key_dtype)
    jt, pt, cols = _pair(key_dtype, d, request, max_deltas=6)

    def keys(ks, reps):
        return np.repeat(np.asarray(ks, np.uint64), reps).astype(key_dtype)

    base = keys([k1, k2, la, lb, ha, hb], [8, 8, 4, 4, 4, 4])
    v0 = _values(0, base.shape[0], cols)
    js, ps = jt.init(_jkeys(base), jnp.asarray(v0)), pt.init(base, v0)
    v1 = _values(100, 8, cols)
    steps = [
        ("insert", keys([k1, k2], [4, 4]), v1),
        ("insert", keys([k1 + 7], [8]), _values(200, 8, cols)),
        ("delete", np.asarray([k1, lb, hb] + [k1 + i for i in range(100, 105)], np.uint64)
         .astype(key_dtype)),
    ]
    for op, *args in steps:
        js = getattr(js, op)(*[_jkeys(a) if a.dtype.kind == "u" else jnp.asarray(a) for a in args])
        ps = getattr(ps, op)(*args)
    js, ps = jfold_oldest(js, 2), fold_oldest(ps, 2)
    assert ps.epoch == js.epoch == 0 and ps.base.local.fingerprints is not None
    _same_graph(ps.base, js.base)
    q = np.asarray([k1, k2, k1 + 7, la, lb, ha, hb, k1 + 100], np.uint64).astype(key_dtype)
    want0 = [0, 12, 8, 4, 0, 4, 0, 0]
    np.testing.assert_array_equal(_np(pt.query(ps, q)), want0)
    np.testing.assert_array_equal(np.asarray(jt.query(js, _jkeys(q))), want0)

    v9 = _values(900, 8, cols)
    js, ps = js.insert(_jkeys(keys([k1], [8])), jnp.asarray(v9)), ps.insert(keys([k1], [8]), v9)
    want1 = [8, 12, 8, 4, 0, 4, 0, 0]
    np.testing.assert_array_equal(_np(pt.query(ps, q)), want1)
    r, jr = pt.retrieve(ps, q), jt.retrieve(js, _jkeys(q))
    for name in ("offsets", "values", "counts"):
        np.testing.assert_array_equal(_np(getattr(r, name)), np.asarray(getattr(jr, name)))
    lists = retrieval_to_lists(r)
    assert sorted(_rows(lists[0])) == sorted(_rows(v9))
    assert sorted(_rows(lists[1])) == sorted(_rows(v0)[8:16] + _rows(v1)[4:8])
    pc = ps.compact()
    assert pc.base.local.fingerprints is not None
    _same_graph(pc.base, js.compact().base)
    np.testing.assert_array_equal(_np(pt.query(pc, q)), want1)
