"""The reference's public names in the port, bit for bit.

``repro_torch.core`` and ``repro_torch.models`` export every name that
``repro.core`` and ``repro.models`` export; three names of other packages are
not ported, by design (``UNPORTED``).  The one-layer entry points of the
multi-shard HashGraph (``contains_sharded``, ``retrieve_sharded``,
``inner_join_sharded``, ``plan_seg_capacity_sharded``,
``plan_out_capacity_sharded``, ``join_size_sharded``) and the paper's query
phase 1 (``build_query_hashgraph_sharded``: its offsets, keys, values and
fingerprints) take the same seeded numpy inputs as the reference's, run
under ``shard_map`` on mesh1 / mesh8, and give the same integers;
``hashgraph.rows_equal`` and ``maintenance.exec_fold`` likewise.
Tolerance: none; every output is an integer.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import repro.core as jcore
import repro.models as jmodels
from repro.core import hashgraph as jhashgraph
from repro.core import maintenance as jmaintenance
from repro.core import multi_hashgraph as jmhg
from repro.core import plans as jplans
from repro.core import table as jtable
from repro.utils.compat import shard_map
import repro_torch.core as pcore
import repro_torch.models as pmodels
from repro_torch import DistributedHashTable
from repro_torch.core import hashgraph, maintenance, multi_hashgraph
from test_torch_state import assert_same_state, jax_graph
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

HASH_RANGE = 1 << 10
# Public names of the reference that the port does not carry, and why:
# the first two walk a jaxpr (the port counts collectives at run time,
# ``repro_torch.counting``); the third switches Pallas's interpreter.
UNPORTED = {
    "repro.obs": ("collective_profile", "count_primitive"),
    "repro.kernels": ("use_interpret_mode",),
}
# (layout, D): uint32 keys at D = 1 and 8; uint64 keys (the fingerprint lane
# on) at D = 8.
CASES = [
    pytest.param(("uint32", None), 1, id="mesh1-u32"),
    pytest.param(("uint32", None), 8, id="mesh8-u32"),
    pytest.param(("uint64", None), 8, id="mesh8-u64fp"),
]
MESHES = pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])


@pytest.mark.parametrize("pkg", ["core", "models"])
def test_package_exports_match_reference(pkg):
    want = importlib.import_module(f"repro.{pkg}").__all__
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert sorted(set(want) - set(port.__all__)) == []
    assert [n for n in want if not hasattr(port, n)] == []


def test_unported_names_are_the_stated_exceptions():
    for ref_pkg, names in UNPORTED.items():
        ref = importlib.import_module(ref_pkg)
        port = importlib.import_module(ref_pkg.replace("repro", "repro_torch", 1))
        for name in names:
            assert name in ref.__all__ and not hasattr(port, name), name
    assert jcore is not None and jmodels.build_model is not None
    assert pcore.build_query_hashgraph_sharded is multi_hashgraph.build_query_hashgraph_sharded
    assert pmodels.ModelBundle.__name__ == "ModelBundle"


def test_rows_equal_matches_reference():
    rng = np.random.default_rng(3)
    one = rng.integers(0, 4, size=64, dtype=np.uint32)
    two = rng.integers(0, 4, size=(64, 2), dtype=np.uint32)
    other = two.copy()
    other[::3, 1] ^= 1
    as_t = lambda a: torch.from_numpy(a.view(np.int32))
    for a, b in ((one, one[::-1].copy()), (two, other), (two[:, None], other[None, :8])):
        got = hashgraph.rows_equal(as_t(np.ascontiguousarray(a)), as_t(np.ascontiguousarray(b)))
        want = jhashgraph.rows_equal(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for bad in ((one, two), (two, one)):
        with pytest.raises(ValueError, match="1-lane"):
            jhashgraph.rows_equal(*map(jnp.asarray, bad))
        with pytest.raises(ValueError, match="1-lane"):
            hashgraph.rows_equal(*map(as_t, bad))


def _inputs(key_dtype: str, d: int):
    rng = np.random.default_rng(17 + d)
    if key_dtype == "uint32":
        pool = rng.choice(np.arange(1, 1 << 16, dtype=np.uint32), 160, replace=False)
        empty = np.uint32(0xFFFFFFFF)
    else:
        pool = (rng.choice(np.arange(1, 1 << 16, dtype=np.uint64), 160, replace=False)
                << np.uint64(32)) | rng.integers(0, 1 << 32, 160, dtype=np.uint64)
        empty = np.uint64(2**64 - 1)
    keys = rng.choice(pool[:128], 512)
    keys[7::61] = empty
    vals = np.arange(512, dtype=np.int32)
    queries = np.concatenate([rng.choice(pool, 120), np.array([empty] * 8, keys.dtype)])
    return keys, vals, queries


def _jq(a):
    return a if a.dtype == np.uint64 else jnp.asarray(a)


def _sharded(mesh, fn, dhg, q, out_specs):
    """``fn(dhg, local queries)`` under the reference's ``shard_map``."""
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(jplans.dhg_specs(dhg), P("d")),
                             out_specs=out_specs, check_vma=False))(dhg, q)


@pytest.fixture(scope="module")
def runs(mesh1, mesh8):
    """Per (layout, d): the reference's outputs of every one-layer entry
    point on its base graph, and the port's table, base graph and packed
    queries (one reference run per input, shared by the cases)."""
    made = {}

    def get(layout, d):
        if (layout, d) in made:
            return made[layout, d]
        key_dtype, fp = layout
        from repro.core import schema as jschema
        from repro_torch import TableSchema

        mesh = mesh1 if d == 1 else mesh8
        keys, vals, queries = _inputs(key_dtype, d)
        jt = jtable.DistributedHashTable(mesh, ("d",), hash_range=HASH_RANGE,
                                         schema=jschema.TableSchema(key_dtype), fingerprint=fp)
        pt = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu",
                                  schema=TableSchema(key_dtype), fingerprint=fp)
        js, ps = jt.init(_jq(keys), jnp.asarray(vals)), pt.init(keys, vals)
        assert_same_state(ps, js)
        dhg, jq = js.base, jt._pack_queries(_jq(queries))
        sh, rep = P("d"), P()
        # The count-only entry points in one program (fewer compiles).
        seg, out, contains, size = _sharded(
            mesh, lambda g, q: (jmhg.plan_seg_capacity_sharded(g, q),
                                jmhg.plan_out_capacity_sharded(g, q),
                                jmhg.contains_sharded(g, q), jmhg.join_size_sharded(g, q)),
            dhg, jq, (rep, rep, sh, rep))
        seg, out = int(seg), int(out)
        caps = dict(seg_capacity=max(seg, 1), out_capacity=max(out, 1))
        qg_spec = jhashgraph.HashGraph(
            offsets=sh, keys=sh, values=sh, table_size=dhg.local_range_cap, seed=dhg.seed,
            sorted_within_bucket=True,
            fingerprints=sh if dhg.local.fingerprints is not None else None)
        ref = {
            "plan_seg_capacity_sharded": seg,
            "plan_out_capacity_sharded": out,
            "contains_sharded": contains,
            "join_size_sharded": size,
        }
        ref["retrieve_sharded"], ref["inner_join_sharded"], ref["build_query_hashgraph_sharded"] = (
            _sharded(mesh, lambda g, q: (jmhg.retrieve_sharded(g, q, **caps),
                                         jmhg.inner_join_sharded(g, q, **caps),
                                         jmhg.build_query_hashgraph_sharded(g, q)), dhg, jq,
                     (jmhg.ShardRetrieval(offsets=sh, values=sh, counts=sh, num_dropped=rep,
                                          layer_counts=None),
                      jmhg.ShardJoin(query_idx=sh, values=sh, num_results=sh, num_dropped=rep),
                      qg_spec)))
        made[layout, d] = (ref, caps, ps.base, pt._pack_queries(queries), d)
        return made[layout, d]

    return get


def _rows(a, d: int) -> np.ndarray:
    """A reference output concatenated over devices, as the port's
    ``(D, ...)`` rows."""
    a = np.asarray(a)
    return a.reshape(d, -1, *a.shape[1:])


ENTRY_POINTS = ["contains_sharded", "join_size_sharded", "plan_seg_capacity_sharded",
                "plan_out_capacity_sharded", "retrieve_sharded", "inner_join_sharded",
                "build_query_hashgraph_sharded"]


@pytest.mark.parametrize("layout, d", CASES)
@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_one_layer_entry_points_match_reference(name, d, layout, runs):
    ref, caps, base, q, d = runs(layout, d)
    want = ref[name]
    fn = getattr(multi_hashgraph, name)
    if name in ("retrieve_sharded", "inner_join_sharded"):
        got = fn(base, q, **caps)
        fields = (("offsets", "values", "counts") if name == "retrieve_sharded"
                  else ("query_idx", "values", "num_results"))
        for f in fields:
            w = _rows(getattr(want, f), d)
            np.testing.assert_array_equal(getattr(got, f).numpy(), w.reshape(-1)
                                          if f == "num_results" else w, err_msg=f)
        assert int(got.num_dropped) == int(want.num_dropped) == 0
        return
    got = fn(base, q)
    if name == "build_query_hashgraph_sharded":
        assert got.table_size == want.table_size and got.sorted_within_bucket
        assert (got.fingerprints is None) == (want.fingerprints is None)
        for f in ("offsets", "keys", "values", "fingerprints"):
            if getattr(want, f) is None:
                continue
            w = _rows(getattr(want, f), d)
            g = getattr(got, f).numpy()
            np.testing.assert_array_equal(g, w.view(g.dtype).reshape(g.shape), err_msg=f)
        assert int((~hashgraph.is_empty_key(got.keys, got.key_lanes)).sum()) == int(
            (~hashgraph.is_empty_key(q, got.key_lanes)).sum())  # every query, once
        return
    if name == "contains_sharded":
        np.testing.assert_array_equal(got.numpy(), _rows(want, d))
        assert got.dtype == torch.bool
        return
    assert int(got) == int(want)


@MESHES
def test_exec_fold_matches_reference(d, request):
    """The layer-local fold executor of a depth-3 coherent stack with
    tombstones: the same folded base and remapped tombstones."""
    mesh = request.getfixturevalue("mesh1" if d == 1 else "mesh8")
    rng = np.random.default_rng(29 + d)
    keys = rng.integers(0, 1 << 13, 256, dtype=np.uint32)
    jt = jtable.DistributedHashTable(mesh, ("d",), hash_range=HASH_RANGE, tombstone_capacity=32)
    pt = DistributedHashTable(num_shards=d, hash_range=HASH_RANGE, device="cpu",
                              tombstone_capacity=32)
    js, ps = jt.init(jnp.asarray(keys)), pt.init(keys)
    for i in range(3):
        batch = rng.integers(0, 1 << 13, 16 * d, dtype=np.uint32)
        js, ps = js.insert(jnp.asarray(batch)), ps.insert(batch)
        if i == 1:
            js, ps = js.delete(jnp.asarray(keys[:5])), ps.delete(keys[:5])
    assert_same_state(ps, js)
    for k in (1, 2):
        jbase, jts = jmaintenance.exec_fold(jt, js, k=k)
        pbase, pts = maintenance.exec_fold(pt, ps, k=k)
        want, got = jax_graph(jbase), jax_graph_port(pbase)
        for f in ("offsets", "keys", "values"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert got["num_dropped"] == want["num_dropped"]
        for f in ("keys", "epochs", "expires"):
            np.testing.assert_array_equal(getattr(pts, f).numpy().view(np.uint32 if f == "keys"
                                                                         else np.int32),
                                          np.asarray(getattr(jts, f)), err_msg=f)
        assert int(pts.count) == int(jts.count)


def jax_graph_port(g) -> dict:
    """The port's graph as the reference's concatenated arrays."""
    return {
        "offsets": g.local.offsets.reshape(-1).numpy(),
        "keys": g.local.keys.reshape(-1).numpy().view(np.uint32),
        "values": g.local.values.reshape(-1).numpy(),
        "num_dropped": int(g.num_dropped),
    }
