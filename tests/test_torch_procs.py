"""The table across processes: one shard per rank of a ``torch.distributed``
group (gloo on the CPU), against the stacked run and the JAX package.

``repro_torch.launch.table_run.run_slice`` drives the table's path (build,
query / contains / join_size, plan_caps, retrieve with and without
per-layer counts, inner_join, the auto retries, coherent inserts, delete,
upsert with TTL, the sorted and the probe query at depth, the clock past
the TTL, fold_oldest, a skewed insert that takes the skew guard's fallback,
reads of the mixed-split stack, compact).  Every output of rank ``r`` must
equal block ``r`` of the stacked run at D = world size, bit for bit, at
u32×1 and u64×2 with the fingerprint lane, with the same exchange rounds
per entry point; the stacked D = 4 run must equal the JAX package on a
4-device mesh and on a (2, 2) mesh (the flat all-to-all against the
reference's one hop per axis).  The ranks also read a JAX-built state
converted per rank, run the distributed dedup, and hit the divergence
guards, which must raise on every rank within the group's timeout.

One spawn per world size (4 and 2; ``file://`` stores under ``tmp_path``,
so parallel workers share no port), plus a gloo group of one inside the
test process.  The rank jobs live in this module and import no JAX (it is
imported inside the fixtures that run the reference).  Tolerance: none.
"""
import os
import time
from typing import Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

from repro_torch import DistributedHashTable, TableSchema  # noqa: E402
from repro_torch.core import convert, exchange  # noqa: E402
from repro_torch.data import dedup  # noqa: E402
from repro_torch.distributed import AbstractMesh  # noqa: E402
from repro_torch.launch import mesh, table_run  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

TIMEOUT_S = 120.0
GUARD_TIMEOUT_S = 30.0
CFGS = {
    "u32x1": table_run.SliceConfig(n_keys=1 << 12),
    "u64x2fp": table_run.SliceConfig(n_keys=1 << 12, wide=True),
}
CONVERT_RANGE = 1 << 10
DEDUP_ROWS, DEDUP_SEQ, DEDUP_RANGE = 512, 16, 1 << 10


def _stacked(cfg, d: int) -> dict:
    sink = table_run.Sink()
    out = table_run.run_slice(cfg, sink, num_shards=d, device="cpu")
    return {"blocks": sink.blocks, "scalars": sink.scalars, "steps": out["steps"]}


def _convert_queries() -> np.ndarray:
    rng = np.random.default_rng(11)
    return rng.integers(0, 300, size=256, dtype=np.uint32)


def _dedup_tokens() -> np.ndarray:
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 50, size=(DEDUP_ROWS, DEDUP_SEQ), dtype=np.int64).astype(np.int32)
    tokens[1::7] = tokens[0::7][: tokens[1::7].shape[0]]  # duplicated rows
    return tokens


def _reads(table, state, queries) -> dict:
    """Query, retrieve and join of ``queries`` as ``(local, ...)`` blocks."""
    local = table.group.local
    r, j = table.retrieve(state, queries), table.inner_join(state, queries)
    out = {
        "query": table.query(state, queries).reshape(local, -1),
        "offsets": r.offsets.reshape(local, -1),
        "values": r.values.reshape(local, -1),
        "counts": r.counts.reshape(local, -1),
        "query_idx": j.query_idx.reshape(local, -1),
        "join_values": j.values.reshape(local, -1),
        "num_results": j.num_results.reshape(local, 1),
    }
    out = {k: v.numpy() for k, v in out.items()}
    out["join_size"] = int(table.join_size(state, queries))
    return out


def _timed_error(fn):
    """The exception type ``fn`` raised on this rank and the seconds it took."""
    t0 = time.perf_counter()
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the result
        return type(e).__name__, time.perf_counter() - t0
    return None, time.perf_counter() - t0


def _guards(group) -> dict:
    """The divergence guards, seen from one rank of a world of 4."""
    table = DistributedHashTable(hash_range=1 << 10, group=group, device="cpu")
    keys = np.arange(64, dtype=np.uint32) + 64 * group.rank
    out = {}
    # Rank 0 passes 8 more keys than the others.
    mine = np.concatenate([keys, keys[:8]]) if group.rank == 0 else keys
    out["unequal_lengths"] = _timed_error(lambda: table.init(mine))
    state = table.init(keys)
    batch = np.arange(16, dtype=np.uint32)
    if group.rank == 1:
        batch = batch + 1  # rank 1's delete batch differs
    out["delete_differs"] = _timed_error(lambda: table.delete(state, batch))
    out["upsert_differs"] = _timed_error(
        lambda: table.upsert(state, batch, np.zeros(16, np.int32)))
    # The ranks stay in step after the guards: a read still agrees.
    out["after"] = table.query(state, keys).numpy()
    return out


def rank_job(group, cfgs: dict, convert_state, guards: bool) -> dict:
    """One rank's work (no JAX): the slice pass of each layout, reads of a
    reference-built state converted to this rank, the distributed dedup,
    and (world 4) the guards."""
    out = {"rank": group.rank}
    for name, cfg in cfgs.items():
        sink = table_run.Sink()
        res = table_run.run_slice(cfg, sink, group=group, device="cpu")
        out[name] = {"blocks": sink.blocks, "scalars": sink.scalars, "steps": res["steps"]}
    if convert_state is not None:
        stacked = DistributedHashTable(num_shards=group.size, hash_range=CONVERT_RANGE,
                                       device="cpu")
        st = convert.state_from_numpy(**convert_state, table=stacked, device="cpu")
        table = DistributedHashTable(hash_range=CONVERT_RANGE, group=group, device="cpu")
        q = _convert_queries()
        n = q.shape[0] // group.size
        out["convert"] = _reads(table, convert.state_for_rank(st, table),
                                q[group.rank * n : (group.rank + 1) * n])
        tokens = _dedup_tokens()
        m = DEDUP_ROWS // group.size
        dt = DistributedHashTable(hash_range=DEDUP_RANGE, group=group, device="cpu")
        out["dedup"] = dedup.dedup_mask_distributed(
            dt, torch.from_numpy(tokens[group.rank * m : (group.rank + 1) * m])).numpy()
    if guards:
        out["guards"] = _guards(group)
    return out


# ---------------------------------------------------------------------------
# The reference: the same pass through the JAX package (global arrays)
# ---------------------------------------------------------------------------


def _jax_pass(cfg, mesh_, axes, skew: Optional[np.ndarray]) -> dict:
    """The pass of ``run_slice`` through the JAX package, outputs named as
    the sink names them, each as ``(D, ...)`` blocks of the global arrays
    (the probe query is left out: the reference's probe runs in Pallas
    interpret mode, and ``tests/test_torch_probe.py`` holds it).  Without
    ``skew`` the pass stops after the base's reads and compacts the base
    (``compact0``): the two exchanges of a build and a compaction."""
    import jax.numpy as jnp

    from repro.core import schema as jschema
    from repro.core import table as jtable
    from repro.core.maintenance import fold_oldest as jfold

    d = int(np.prod([mesh_.shape[a] for a in axes]))
    schema = jschema.TableSchema("uint64", 2) if cfg.wide else jschema.TableSchema()
    jt = jtable.DistributedHashTable(
        mesh_, axes, hash_range=cfg.hash_range or cfg.n_keys, schema=schema,
        tombstone_capacity=cfg.tombstone_capacity or 4 * (cfg.replicated or max(8, cfg.n_keys // 32)))
    data = table_run.make_data(cfg, d)

    def arr(a):
        return a if a.dtype == np.uint64 else jnp.asarray(a)

    out = {}

    def blocks(name, x, rows=None):
        a = np.asarray(x)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = a.reshape(d, -1, *a.shape[1:]) if rows is None else a.reshape(d, rows)

    def graph(tag, g):
        blocks(f"{tag}.offsets", g.local.offsets)
        blocks(f"{tag}.keys", g.local.keys)
        blocks(f"{tag}.values", g.local.values)
        if g.local.fingerprints is not None:
            blocks(f"{tag}.fingerprints", g.local.fingerprints)
        out[f"{tag}.hash_splits"] = np.asarray(g.hash_splits).tolist()
        out[f"{tag}.num_dropped"] = int(g.num_dropped)

    def retrieval(tag, r):
        for f in ("offsets", "values", "counts"):
            blocks(f"{tag}.{f}", getattr(r, f))
        if getattr(r, "layer_counts", None) is not None:
            blocks(f"{tag}.layer_counts", r.layer_counts)
        out[f"{tag}.num_dropped"] = int(r.num_dropped)

    def join(tag, j):
        blocks(f"{tag}.query_idx", j.query_idx)
        blocks(f"{tag}.values", j.values)
        blocks(f"{tag}.num_results", j.num_results, rows=1)
        out[f"{tag}.num_dropped"] = int(j.num_dropped)

    q = arr(data["queries"])

    def reads(tag, st, full):
        blocks(f"{tag}.query", jt.query(st, q))
        if full:
            blocks(f"{tag}.contains", jt.contains(st, q))
            out[f"{tag}.join_size"] = int(jt.join_size(st, q))
            out[f"{tag}.plan_caps"] = [int(c) for c in jt.plan_caps(st, q)]
        retrieval(f"{tag}.retrieve", jt.retrieve(st, q))
        if full:
            retrieval(f"{tag}.retrieve_layers", jt.retrieve(st, q, per_layer_counts=True))
            join(f"{tag}.inner_join", jt.inner_join(st, q))

    state = jt.init(arr(data["keys"]), arr(data["values"]))
    graph("base", state.base)
    reads("r0", state, True)
    if skew is None:
        graph("compact0", jt.compact(state).base)
        return out
    seg_cap, out_cap = (max(8, int(c) // 4) for c in jt.plan_caps(state, q))
    retrieval("r0.retrieve_auto", jt.retrieve_auto(state, q, out_capacity=out_cap,
                                                   seg_capacity=seg_cap))
    join("r0.inner_join_auto", jt.inner_join_auto(state, q, out_capacity=out_cap,
                                                  seg_capacity=seg_cap))
    for i in range(2):
        vals = data.get(f"ins{i}_values")
        state = jt.insert(state, arr(data[f"ins{i}"]), None if vals is None else jnp.asarray(vals))
    state = jt.delete(state, arr(data["dels"]))
    state = jt.upsert(state, arr(data["ups"]), jnp.asarray(data["ups_values"]),
                      ttl=table_run.UPSERT_TTL)
    ts = state.tombstones
    out["upsert.tombstones"] = [int(ts.count), int(ts.num_dropped), int(ts.now)]
    graph("delta2", state.deltas[-1])
    reads("r3", state, True)
    state = state.advance(int(state.tombstones.now) + table_run.UPSERT_TTL)
    reads("r3_expired", state, False)
    state = jfold(state, 2)
    graph("folded", state.base)
    reads("r_fold", state, False)
    fallbacks = jt.skew_fallbacks
    state = jt.insert(state, arr(skew), None if not cfg.wide
                      else jnp.zeros((skew.shape[0], 2), jnp.int32))
    out["skew.fallback"] = jt.skew_fallbacks - fallbacks
    out["skew.coherent"] = bool(state.coherent)
    reads("r_mixed", state, True)
    state = jt.compact(state)
    graph("compacted", state.base)
    reads("r_compact", state, False)
    out["state.num_dropped"] = int(state.num_dropped)
    return out


def _skew_of(cfg, d: int) -> np.ndarray:
    """The skewed batch the port's pass inserts (drawn from the base's splits)."""
    table = DistributedHashTable(num_shards=d, hash_range=cfg.hash_range or cfg.n_keys,
                                 device="cpu",
                                 schema=TableSchema("uint64", 2) if cfg.wide else TableSchema())
    data = table_run.make_data(cfg, d)
    state = table.init(data["keys"], data["values"])
    return table_run.skewed_batch(table, state, cfg.batch or cfg.n_keys // 8, cfg.seed)


def _jax_convert_state(mesh4):
    """A JAX-built D = 4 state with two deltas and tombstones, as numpy."""
    import jax.numpy as jnp

    from repro.core import table as jtable

    rng = np.random.default_rng(3)
    jt = jtable.DistributedHashTable(mesh4, ("d",), hash_range=CONVERT_RANGE,
                                     tombstone_capacity=64)
    js = jt.init(jnp.asarray(rng.integers(0, 300, size=512, dtype=np.uint32)))
    js = jt.insert(js, jnp.asarray(rng.integers(0, 300, size=128, dtype=np.uint32)))
    js = jt.delete(js, jnp.asarray(np.arange(0, 40, dtype=np.uint32)))
    js = jt.insert(js, jnp.asarray(rng.integers(0, 300, size=64, dtype=np.uint32)))
    ts = js.tombstones

    def g(x):
        return {
            "offsets": np.asarray(x.local.offsets), "keys": np.asarray(x.local.keys),
            "values": np.asarray(x.local.values), "hash_splits": np.asarray(x.hash_splits),
            "num_dropped": int(x.num_dropped), "hash_range": x.hash_range, "seed": x.seed,
            "local_range_cap": x.local_range_cap, "bucket_stride": x.bucket_stride,
        }

    state = {
        "base": g(js.base), "deltas": [g(x) for x in js.deltas],
        "tombstones": {"keys": np.asarray(ts.keys), "epochs": np.asarray(ts.epochs),
                       "expires": np.asarray(ts.expires), "count": int(ts.count),
                       "num_dropped": int(ts.num_dropped), "now": int(ts.now)},
        "coherent": js.coherent,
    }
    jq = jnp.asarray(_convert_queries())
    r, j = jt.retrieve(js, jq), jt.inner_join(js, jq)
    want = {
        "query": np.asarray(jt.query(js, jq)), "offsets": np.asarray(r.offsets),
        "values": np.asarray(r.values), "counts": np.asarray(r.counts),
        "query_idx": np.asarray(j.query_idx), "join_values": np.asarray(j.values),
        "num_results": np.asarray(j.num_results), "join_size": int(jt.join_size(js, jq)),
    }
    return state, want


# ---------------------------------------------------------------------------
# Fixtures: one spawn per world size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh4():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (fake) devices; XLA_FLAGS was overridden")
    return jax.make_mesh((4,), ("d",))


@pytest.fixture(scope="module")
def reference_state(mesh4):
    return _jax_convert_state(mesh4)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, reference_state):
    t0 = time.perf_counter()
    ranks = mesh.spawn(rank_job, 4, "gloo", "cpu", args=(CFGS, reference_state[0], True),
                       timeout_s=TIMEOUT_S, store_dir=str(tmp_path_factory.mktemp("world4")))
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return mesh.spawn(rank_job, 2, "gloo", "cpu", args=({"u32x1": CFGS["u32x1"]}, None, False),
                      timeout_s=TIMEOUT_S, store_dir=str(tmp_path_factory.mktemp("world2")))


@pytest.fixture(scope="module")
def stacked4():
    return {name: _stacked(cfg, 4) for name, cfg in CFGS.items()}


def _assert_rank_equals_row(ranks, stacked, name):
    """Every output of every rank equals its row of the stacked run."""
    want = stacked
    for res in ranks:
        r, got = res["rank"], res[name]
        assert set(got["blocks"]) == set(want["blocks"])
        for key, arr in want["blocks"].items():
            g = got["blocks"][key]
            assert g.shape == (1,) + arr.shape[1:], (r, key)
            if not np.array_equal(g[0], arr[r]):
                first = int(np.argmax((g[0] != arr[r]).reshape(-1)))
                pytest.fail(f"rank {r}: {key} differs from the stacked row, first at flat {first}")
        assert got["scalars"] == want["scalars"], r


# ---------------------------------------------------------------------------
# World 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(CFGS))
def test_world4_ranks_equal_stacked_rows(world4, stacked4, layout):
    _assert_rank_equals_row(world4["ranks"], stacked4[layout], layout)
    s = stacked4[layout]["scalars"]
    assert s["state.num_dropped"] == 0 and s["r0.retrieve.num_dropped"] == 0
    assert s["skew.fallback"] == 1 and s["skew.coherent"] is False
    assert s["r0.retrieve_auto.num_dropped"] == 0


@pytest.mark.parametrize("layout", list(CFGS))
def test_world4_rounds_per_entry_point_equal_stacked(world4, stacked4, layout):
    want = stacked4[layout]["steps"]
    for res in world4["ranks"]:
        got = res[layout]["steps"]
        assert set(got) == set(want)
        for step, w in want.items():
            g = got[step]
            assert (g["rounds"], g["plan_rounds"], g["bytes"]) == (
                w["rounds"], w["plan_rounds"], w["bytes"]), (res["rank"], step)
            assert g["launches"] == w["launches"], (res["rank"], step)
            assert not w["collectives"]  # a stacked run reduces nothing
    steps = world4["ranks"][0][layout]["steps"]
    assert steps["init"]["rounds"] == 1
    assert steps["r0.query"]["rounds"] == 2
    assert steps["r0.retrieve"]["rounds"] == 2 and steps["r0.retrieve"]["plan_rounds"] == 1
    assert steps["r3.query"]["rounds"] == 2  # one fused round trip at depth 3
    assert steps["fold_oldest"]["rounds"] == 0 and not steps["fold_oldest"]["collectives"]
    # The host agreements count apart: one length check a read.
    assert steps["r0.query"]["collectives"] == {"agree": 1}


# The u32x1 pass runs whole on the 4-device mesh; the u64x2fp one and the
# (2, 2) mesh stop after the base's reads and compact the base (the other
# layouts' versioned paths are held at D = 1 and 8 by test_torch_widths).
@pytest.mark.parametrize("layout,mesh_shape", [("u32x1", (4,)), ("u64x2fp", (4,)),
                                               ("u32x1", (2, 2))],
                         ids=["u32x1-mesh4", "u64x2fp-mesh4", "u32x1-mesh2x2"])
def test_stacked4_equals_reference(stacked4, mesh4, layout, mesh_shape):
    import jax

    cfg = CFGS[layout]
    got = stacked4[layout]
    if (layout, mesh_shape) == ("u32x1", (4,)):
        want = _jax_pass(cfg, jax.make_mesh((4,), ("d",)), ("d",), _skew_of(cfg, 4))
    else:
        mesh_, axes = (jax.make_mesh((4,), ("d",)), ("d",)) if mesh_shape == (4,) else (
            jax.make_mesh((2, 2), ("x", "y")), ("x", "y"))
        want = _jax_pass(cfg, mesh_, axes, None)
        table = DistributedHashTable(
            num_shards=4, hash_range=cfg.n_keys, device="cpu",
            schema=TableSchema("uint64", 2) if cfg.wide else TableSchema())
        data = table_run.make_data(cfg, 4)
        compacted = table.compact(table.init(data["keys"], data["values"])).base
        sink = table_run.Sink()
        for f in ("offsets", "keys", "values", "fingerprints"):
            if getattr(compacted.local, f) is not None:
                sink.put(f"compact0.{f}", getattr(compacted.local, f))
        got = {"blocks": {**got["blocks"], **sink.blocks}, "scalars": {
            **got["scalars"], "compact0.hash_splits": compacted.hash_splits.tolist(),
            "compact0.num_dropped": int(compacted.num_dropped)}}
    for name, w in want.items():
        if isinstance(w, np.ndarray):
            g = got["blocks"][name]
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert got["scalars"][name] == w, name
    jax.clear_caches()


def test_world4_reads_of_a_converted_reference_state(world4, reference_state):
    _, want = reference_state
    for res in world4["ranks"]:
        r, got = res["rank"], res["convert"]
        assert got["join_size"] == want["join_size"]
        for name in ("query", "offsets", "values", "counts", "query_idx", "join_values",
                     "num_results"):
            w = want[name]
            w = w.reshape(4, -1)[r] if name != "num_results" else w.reshape(4, 1)[r]
            np.testing.assert_array_equal(got[name][0], w, err_msg=f"rank {r} {name}")


def test_world4_dedup_mask_equals_reference(world4, mesh4):
    import jax.numpy as jnp

    from repro.core import table as jtable
    from repro.data import dedup as jdedup

    jt = jtable.DistributedHashTable(mesh4, ("d",), hash_range=DEDUP_RANGE)
    want = np.asarray(jdedup.dedup_mask_distributed(jt, jnp.asarray(_dedup_tokens())))
    got = np.concatenate([res["dedup"] for res in world4["ranks"]])
    np.testing.assert_array_equal(got, want)
    assert not got.all() and got.any()


@pytest.mark.parametrize("guard", ["unequal_lengths", "delete_differs", "upsert_differs"])
def test_world4_divergence_guards_raise_on_every_rank(world4, guard):
    for res in world4["ranks"]:
        kind, seconds = res["guards"][guard]
        assert kind == "ValueError", (res["rank"], guard, kind)
        assert seconds < GUARD_TIMEOUT_S, (res["rank"], guard, seconds)


def test_world4_ranks_stay_in_step_after_the_guards(world4):
    after = [res["guards"]["after"] for res in world4["ranks"]]
    for r, a in enumerate(after):
        np.testing.assert_array_equal(a, np.ones(64, np.int32), err_msg=f"rank {r}")


def test_world4_spawn_stays_in_budget(world4):
    assert world4["seconds"] < TIMEOUT_S


# ---------------------------------------------------------------------------
# World 2 and world 1
# ---------------------------------------------------------------------------


def test_world2_ranks_equal_stacked_rows(world2):
    stacked = _stacked(CFGS["u32x1"], 2)
    _assert_rank_equals_row(world2, stacked, "u32x1")
    for res in world2:
        for step, w in stacked["steps"].items():
            assert res["u32x1"]["steps"][step]["rounds"] == w["rounds"], step


def test_mesh_entry_point_runs_a_world_of_two(tmp_path):
    """``launch.mesh.run_reads``, the ``torchrun`` entry's body (the read part
    of ``table_run.run_slice``): its numpy oracle passes on every rank, with
    the read budget per rank and the rank's device beside its walls."""
    ranks = mesh.spawn(mesh.run_reads, 2, "gloo", "cpu", args=(1 << 12, 0, "cpu"),
                       timeout_s=TIMEOUT_S, store_dir=str(tmp_path))
    for r, res in enumerate(ranks):
        assert res["rank"] == r and res["world"] == 2
        assert res["device"] == "cpu" and res["device_name"] == "cpu"
        assert res["oracle"]["rows"] > 0 and res["oracle"]["bad"] == 0
        assert res["oracle"]["present"] > 0
        want = {"init": (1, 0), "r0.query": (2, 0), "r0.retrieve": (2, 1),
                "r0.inner_join": (2, 1)}
        got = {k: (res["rounds"][k], res["plan_rounds"][k]) for k in want}
        assert got == want
        assert "insert0" not in res["rounds"]  # the read pass only
        assert set(res["walls_s"]) == set(res["rounds"])


def test_entry_points_take_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``device=None`` means the (rank's) card in every entry point, and
    raises where there is none; the CPU runs only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init_shard_group("gloo", "file:///nonexistent/store", rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.spawn(mesh.run_reads, 2, "gloo", args=(1 << 10,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table_run.run_slice(table_run.SliceConfig(n_keys=1 << 10), table_run.Sink(),
                            num_shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.main(["--keys", "1024"])


def test_world1_in_process_gloo_equals_stacked(tmp_path):
    import torch.distributed as dist

    cfg = table_run.SliceConfig(n_keys=1 << 10)
    group = mesh.init_shard_group("gloo", "file://" + os.path.join(tmp_path, "store"),
                                  timeout_s=TIMEOUT_S, rank=0, world_size=1, device="cpu")
    try:
        sink = table_run.Sink()
        steps = table_run.run_slice(cfg, sink, group=group, device="cpu")["steps"]
    finally:
        dist.destroy_process_group()
    want = _stacked(cfg, 1)
    assert set(sink.blocks) == set(want["blocks"])
    for key, arr in want["blocks"].items():
        np.testing.assert_array_equal(sink.blocks[key], arr, err_msg=key)
    assert sink.scalars == want["scalars"]
    assert {k: v["rounds"] for k, v in steps.items()} == {
        k: v["rounds"] for k, v in want["steps"].items()}


def test_groups_share_one_vocabulary():
    g = exchange.StackedGroup(4)
    x = torch.arange(4 * 4 * 3).reshape(4, 4, 3)
    assert torch.equal(g.all_to_all(x), x.transpose(0, 1))
    assert g.rank == 0 and g.local == g.size == 4 and torch.equal(g.ranks("cpu"), torch.arange(4, dtype=torch.int32))
    t = torch.tensor(7)
    assert g.psum(t) is t and g.pmax(t) is t and g.agree([3, 5]) == (3, 5) and g.same([1])
    assert exchange.as_group(None, 3) == exchange.StackedGroup(3)
    with pytest.raises(ValueError, match="256"):
        mesh.make_production_mesh()  # a DeviceMesh over a group of 256 ranks
    par = mesh.production_parallel(AbstractMesh((16, 16), ("data", "model")))
    assert (par.dp_axes, par.tp_axis, par.seq_parallel) == (("data",), "model", True)
