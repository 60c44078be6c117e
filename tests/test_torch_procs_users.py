"""The table's users across processes: hot-key replication, the KV cache
and the table server with one shard per rank of a gloo group.

* ``launch.users_run.run_users`` (a zipfian hot-key insert at theta 1.2,
  R = 4, its offsets, reads, fold and compaction; a ``KVCache`` over YCSB A
  and F with TTL puts, the policy's folds and two evictions) on every rank
  of a world of 4 and of 2: every output equals the rank's row of the
  stacked run at D = world size, bit for bit, with the same exchange
  rounds per call.
* The stacked D = 4 pass equals the JAX package on the 4-device mesh: the
  hot-key insert (registry, offsets, delta, reads), and the KV part on a
  stream whose batches are multiples of 4 (the reference's ``KVCache`` at
  D = 4 refuses others on jax 0.9) and whose policy only evicts (its put
  after an incremental fold fails on jax 0.9; the folds are held against
  the reference in ``test_torch_kvcache.py`` and
  ``test_torch_maintenance.py``).
* ``launch.serve_run.run_server`` across 4 ranks: rank 0's front end
  answers 4 reader threads and a retrieve thread while inserts, a
  background fold, a delete, an upsert with a TTL and the clock past it
  apply; every response equals the numpy oracle at its seqno, every read
  makes its 2 exchange rounds, reads run during the fold; every follower
  ran the leader's read batches, writes and folds and ends at its seqno,
  its shadow equal to its row of a stacked server replaying the leader's
  log.  A write that fails on one rank fails on all of them, idle roles
  outlive their communicators' timeout (the heartbeat), and a follower
  that leaves makes rank 0 raise within the group's timeout.

One spawn a world size (``file://`` stores under ``tmp_path``).  The rank
jobs import no JAX.  Tolerance: none.
"""
import dataclasses
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

from repro_torch.launch import mesh, serve_run, table_run, users_run  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

TIMEOUT_S = 60.0
ROLE_TIMEOUT_S = 2.0  # the idle case's role communicators
USERS = users_run.UsersConfig(n_keys=1 << 12, hot_batch=1 << 10, kv_batch=256, kv_ops=512,
                              kv_ttl_keys=256, kv_max_deltas=3)
# Fixed shapes (reads and distinct writes a batch, multiples of 4: the
# reference compiles one program a shape) and a ring the stream never fills:
# on jax 0.9 the reference's put after an incremental fold fails in its
# tombstone push (ROADMAP §3); the ranks' stream above folds.
USERS_FIXED = dataclasses.replace(USERS, kv_ops=256, kv_fixed=(64, 64), kv_max_deltas=8,
                                  kv_ttl_keys=64)
SERVE = serve_run.ServeConfig(n_keys=1 << 12, write_bucket=256, tombstones=1024,
                              buckets=(64, 128, 256), readers=4, requests=32, req_sizes=(4, 32),
                              retrieves=4, inserts=4, hot_repeats=16, deletes=128, upserts=128,
                              fold_pause_s=0.3)
SMALL = serve_run.ServeConfig(n_keys=1 << 10, write_bucket=64, tombstones=256, buckets=(16,),
                              readers=1, requests=4, req_sizes=(1, 8), retrieves=1, inserts=1,
                              hot_repeats=4, deletes=16, upserts=16)


def _users(group, cfg) -> dict:
    sink = table_run.Sink()
    out = users_run.run_users(cfg, sink, group=group, device="cpu")
    return {"blocks": sink.blocks, "scalars": sink.scalars, "steps": out["steps"]}


def _stacked_users(cfg, d: int, keep_state: bool = False) -> dict:
    sink = table_run.Sink()
    out = users_run.run_users(cfg, sink, num_shards=d, device="cpu", keep_state=keep_state)
    return {"blocks": sink.blocks, "scalars": sink.scalars, "steps": out["steps"], "run": out}


def _failed_writes(group) -> dict:
    """The agreed verdict: an insert that fails on rank 2 alone (after its
    collectives) fails on every rank and is retried; then a ring-full
    insert fails on every rank."""
    from repro_torch.serve_table import CompactionPolicy

    never = CompactionPolicy(max_delta_depth=None, tombstone_load=2.0, tombstone_overflow=False)
    server = serve_run.make_server(SMALL, group=group, device="cpu")
    server.table.max_deltas = 2
    server.policy = never
    out = {}
    if group.rank == 2:
        real = server.table.insert
        calls = {"n": 0}

        def flaky(state, keys, values=None, **kw):
            st = real(state, keys, values, **kw)
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected failure on rank 2")
            return st

        server.table.insert = flaky
    if group.rank != 0:
        server.follow()
    else:
        rng = np.random.default_rng(1)
        server.submit_insert(rng.integers(0, 1 << 10, 64, dtype=np.uint32))
        out["first"] = server.step()
        server.submit_insert(rng.integers(0, 1 << 10, 64, dtype=np.uint32))
        try:
            server.step()
        except RuntimeError as e:
            out["rank2_failure"] = str(e)
        out["pending_after_rank2"] = server.pending()
        out["retry"] = server.step()
        server.submit_insert(rng.integers(0, 1 << 10, 64, dtype=np.uint32))
        try:
            server.step()
        except RuntimeError as e:
            out["ring_full"] = str(e)
        out["pending_after_ring_full"] = server.pending()
        server.stop()
    out.update(seqno=server.registry.seqno, depth=len(server._shadow.deltas),
               writes=server.stats().writes_applied)
    return out


def world4_job(group) -> dict:
    out = {"rank": group.rank, "users": _users(group, USERS)}
    sink = table_run.Sink()
    out["serve"] = serve_run.run_server(SERVE, sink, group=group, device="cpu")
    out["shadow"] = {"blocks": sink.blocks, "scalars": sink.scalars}
    out["failed_writes"] = _failed_writes(group)
    return out


def _idle_server(group) -> dict:
    """Role communicators with a short timeout and rank 0 idle for longer:
    the heartbeat keeps every follower's waits inside it."""
    group.timeout_s = ROLE_TIMEOUT_S  # the roles are created with the server
    server = serve_run.make_server(SMALL, group=group, device="cpu")
    if group.rank != 0:
        server.follow()
        return {"followed": True}
    time.sleep(ROLE_TIMEOUT_S + 2)
    counts, _ = server.query_many([np.arange(1, 9, dtype=np.uint32)])
    server.stop()
    return {"counts": counts[0].tolist()}


def world2_job(group) -> dict:
    out = {"rank": group.rank, "users": _users(group, USERS), "idle": _idle_server(group)}
    server = serve_run.make_server(SMALL, group=group, device="cpu")
    if group.rank == 1:
        return out  # leaves the group: its process ends
    t0 = time.perf_counter()
    try:
        time.sleep(0.5)
        for _ in range(3):
            server.query_many([np.arange(10, dtype=np.uint32)])
        out["dead"] = (None, time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001 - the outcome under test
        out["dead"] = (type(e).__name__, time.perf_counter() - t0 - 0.5)
    return out


@pytest.fixture(scope="module")
def mesh4():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (fake) devices; XLA_FLAGS was overridden")
    return jax.make_mesh((4,), ("d",))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    t0 = time.perf_counter()
    ranks = mesh.spawn(world4_job, 4, "gloo", "cpu", timeout_s=TIMEOUT_S,
                       store_dir=str(tmp_path_factory.mktemp("users4")))
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return mesh.spawn(world2_job, 2, "gloo", "cpu", timeout_s=TIMEOUT_S,
                      store_dir=str(tmp_path_factory.mktemp("users2")))


@pytest.fixture(scope="module")
def stacked4():
    return _stacked_users(USERS, 4)


@pytest.fixture(scope="module")
def stacked4_fixed():
    return _stacked_users(USERS_FIXED, 4)


def _assert_rows(ranks, stacked, part: str):
    """Every ``part.*`` output of every rank equals its stacked row, with
    equal rounds per call."""
    names = [k for k in stacked["blocks"] if k.startswith(part + ".")]
    assert names
    for res in ranks:
        r, got = res["rank"], res["users"]
        for key in names:
            g, w = got["blocks"][key], stacked["blocks"][key]
            assert g.shape == (1,) + w.shape[1:], (r, key)
            np.testing.assert_array_equal(g[0], w[r], err_msg=f"rank {r} {key}")
        for key, w in stacked["scalars"].items():
            if key.startswith(part + "."):
                assert got["scalars"][key] == w, (r, key)
        for step, w in stacked["steps"].items():
            if step.startswith(part + "."):
                assert got["steps"][step]["rounds"] == w["rounds"], (r, step)
                assert not w["collectives"]  # a stacked run reduces nothing


@pytest.mark.parametrize("part", ["hot", "kv"])
def test_world4_users_equal_stacked_rows(world4, stacked4, part):
    _assert_rows(world4["ranks"], stacked4, part)


def test_world4_users_rounds_and_reductions(world4, stacked4):
    s = stacked4["scalars"]
    assert s["hot.keys"] and {r for _, r in s["hot.keys"]} == {4}
    assert s["hot.skew_fallbacks"] == 0 and s["hot.num_dropped"] == 0
    assert s["kv.skew_fallbacks"] == 0
    folds = [v for k, v in s.items() if k.endswith(".folds")]
    assert folds[-1][0] >= 1 and folds[-1][1] >= 2  # the policy's folds, the evictions
    steps = world4["ranks"][0]["users"]["steps"]
    assert steps["hot.insert.query"]["rounds"] == 2 * 4  # one routed round trip a replica
    assert steps["hot.insert"]["collectives"]["all_gather"] == 1  # the batch's keys, once
    gets = [v for k, v in steps.items() if k.endswith(".get")]
    assert gets and all(v["collectives"].get("agree", 0) >= 1 for v in gets)


@pytest.fixture(scope="module")
def stacked2():
    return _stacked_users(USERS, 2)


@pytest.mark.parametrize("part", ["hot", "kv"])
def test_world2_users_equal_stacked_rows(world2, stacked2, part):
    _assert_rows(world2, stacked2, part)


def _jax_blocks(a, d: int) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return a.reshape(d, -1, *a.shape[1:])


def test_stacked4_hot_keys_equal_reference(mesh4, stacked4_fixed):
    import jax
    import jax.numpy as jnp

    from repro.core.table import DistributedHashTable as JTable

    cfg, got = USERS_FIXED, stacked4_fixed
    h = users_run.hot_data(cfg)
    jt = JTable(mesh4, ("d",), hash_range=cfg.n_keys, capacity_slack=users_run.HOT_SLACK,
                replicate_hot_keys=users_run.HOT_REPLICAS)
    js = jt.init(jnp.asarray(h["base"]))
    js = jt.insert(js, jnp.asarray(h["batch"]), jnp.asarray(h["values"]))
    want = {"hot.offsets": _jax_blocks(jt._hot_key_offsets(jnp.asarray(h["batch"])), 4)}
    assert got["scalars"]["hot.keys"] == sorted([list(k), r] for k, r in jt.hot_keys.items())
    assert got["scalars"]["hot.skew_fallbacks"] == jt.skew_fallbacks

    def graph(tag, g):
        for f in ("offsets", "keys", "values"):
            want[f"{tag}.{f}"] = _jax_blocks(getattr(g.local, f), 4)

    uniq = np.unique(h["batch"])
    q = np.concatenate([uniq, h["others"]])
    q = jnp.asarray(np.concatenate([q, h["others"][: (-q.shape[0]) % 4]]))
    graph("hot.delta", js.deltas[0])
    # The fold and the compaction of a replicated stack are held against
    # the reference at D = 8 in test_torch_hot_keys.py.
    want["hot.insert.query"] = _jax_blocks(jt.query(js, q), 4)
    want["hot.contains"] = want["hot.insert.query"] > 0
    hot = np.array(sorted(k[0] for k in jt.hot_keys), np.uint32)
    hq = np.concatenate([hot, h["others"]])[: max(4, -(-hot.shape[0] // 4) * 4)]
    r = jt.retrieve(js, jnp.asarray(hq))
    want["hot.retrieve.offsets"] = _jax_blocks(r.offsets, 4)
    want["hot.retrieve.values"] = _jax_blocks(r.values, 4)
    for name, w in want.items():
        np.testing.assert_array_equal(got["blocks"][name], w, err_msg=name)
    jax.clear_caches()


def test_stacked4_kv_cache_equals_reference(mesh4, stacked4_fixed):
    import jax
    import jax.numpy as jnp

    from repro.cache import WORKLOADS as JWORKLOADS
    from repro.cache import KVCache as JKVCache
    from repro.cache import YCSBWorkload as JYCSB
    from repro.core.table import DistributedHashTable as JTable

    cfg, got = USERS_FIXED, stacked4_fixed
    jt = JTable(mesh4, ("d",), hash_range=cfg.n_keys, capacity_slack=users_run.KV_SLACK,
                tombstone_capacity=16 * cfg.kv_batch, max_deltas=cfg.kv_max_deltas)
    w = JYCSB(JWORKLOADS["A"], cfg.n_keys, seed=cfg.seed)
    jc = JKVCache(jt, jnp.asarray(w.load_keys()), jnp.asarray(w.load_values()))
    script = users_run.kv_script(cfg)
    assert all(op[1].shape[0] % 4 == 0 for op in script if op[0] in ("get", "contains", "put"))
    for i, op in enumerate(script):
        kind, name = op[0], f"kv.{i}.{op[0]}"
        if kind in ("get", "contains"):
            np.testing.assert_array_equal(got["blocks"][name].reshape(-1),
                                          np.asarray(getattr(jc, kind)(op[1])), err_msg=name)
        elif kind == "put":
            jc.put(op[1], op[2], ttl=op[3])
        elif kind == "tick":
            jc.tick()
        elif kind == "live":
            assert got["scalars"][name] == jc.live_count(), name
            assert got["scalars"][f"kv.{i}.folds"] == [jc.folds, jc.evictions, jc.now], name
            assert got["scalars"][f"kv.{i}.stats"] == dataclasses.astuple(jc.stats()), name
        else:
            assert got["scalars"][name] == jc.evict_expired(), name
    assert jc.evictions >= 2
    jax.clear_caches()


def test_world4_server_answers_equal_oracle(world4):
    lead = world4["ranks"][0]["serve"]
    assert not lead["errors"], lead["errors"]
    assert lead["responses"] == lead["requests"] == lead["completed"] and lead["failed"] == 0
    assert lead["retrieved"] == SERVE.retrieves and lead["bad"] == 0
    assert lead["applied_final"] == lead["writes"]  # every write, the expiry last
    assert lead["rounds"] == [(2, 2)] and lead["budget_misses"] == 0
    assert lead["fold_rounds"] == [("fold", 0)] and lead["fold_budget_misses"] == 0
    assert lead["reads_during_folds"] > 0  # reads flowed while the fold ran
    assert lead["aot_misses"] == 0 and lead["num_dropped"] == 0 and lead["last_error"] is None


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_world4_follower_ran_the_leaders_work(world4, rank):
    lead = world4["ranks"][0]["serve"]
    kinds = [rec["kind"] for rec in lead["log"]]
    assert kinds.count("fold") == 1 and kinds.count("advance") == 1 and "ops" in kinds
    f = world4["ranks"][rank]["serve"]
    for field in ("seqno", "read_batches", "writes_applied", "folds", "full_compacts",
                  "grid_entries"):
        assert f[field] == lead[field], field
    assert [rec["kind"] for rec in f["log"]] == kinds
    assert f["reads"] == lead["reads"]  # the same batches against the same states
    assert f["last_error"] is None and f["budget_misses"] == 0 and f["fold_budget_misses"] == 0


@pytest.fixture(scope="module")
def replayed4(world4):
    sink = table_run.Sink()
    serve_run.replay(SERVE, world4["ranks"][0]["serve"]["log"], 4, "cpu", sink)
    return sink


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_world4_shadow_equals_stacked_replay_row(world4, replayed4, rank):
    got = world4["ranks"][rank]["shadow"]
    assert set(got["blocks"]) == set(replayed4.blocks)
    for key, w in replayed4.blocks.items():
        np.testing.assert_array_equal(got["blocks"][key][0], w[rank], err_msg=key)
    assert got["scalars"] == replayed4.scalars


def test_world4_failed_write_is_agreed(world4):
    lead = world4["ranks"][0]["failed_writes"]
    assert lead["first"] == 1 and lead["retry"] == 1
    assert "another rank" in lead["rank2_failure"] and lead["pending_after_rank2"] == 1
    assert "delta ring full" in lead["ring_full"] and lead["pending_after_ring_full"] == 1
    for res in world4["ranks"]:
        fw = res["failed_writes"]
        # Two inserts landed everywhere; the failed attempts on no rank.
        assert (fw["seqno"], fw["depth"], fw["writes"]) == (lead["seqno"], 2, 2), res["rank"]


def test_world2_heartbeat_keeps_idle_followers(world2):
    from repro_torch.core.table import DistributedHashTable

    want = DistributedHashTable(num_shards=2, hash_range=SMALL.n_keys, device="cpu")
    keys = serve_run.make_data(SMALL)["keys"]
    expected = want.query(want.init(keys), np.arange(1, 9, dtype=np.uint32)).tolist()
    assert world2[0]["idle"] == {"counts": expected}
    assert world2[1]["idle"] == {"followed": True}


def test_world2_dead_follower_makes_rank0_raise(world2):
    kind, seconds = world2[0]["dead"]
    assert kind == "RuntimeError" and seconds < TIMEOUT_S


def test_world4_spawn_stays_in_budget(world4):
    assert world4["seconds"] < TIMEOUT_S


def test_users_entry_points_take_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``device=None`` means the card in both passes, and raises where there
    is none; the CPU runs only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        users_run.run_users(USERS, table_run.Sink(), num_shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_run.run_server(SMALL, table_run.Sink(), num_shards=2)


class _Event:
    """A CUDA event's ``query`` for the CPU: complete once ``done``."""

    done = False

    def query(self) -> bool:
        return self.done


def test_dispatched_read_holds_its_seqno_until_gathered():
    """A dispatched read batch keeps its seqno the oldest a read may ask for
    (the followers keep that snapshot) until its gathered answers are
    complete, not merely until the dispatch returns."""
    server = serve_run.make_server(SMALL, device="cpu")
    gathered = _Event()
    server._dispatched.append((0, gathered))
    server.submit_insert(np.arange(8, dtype=np.uint32) + (1 << 20))
    server.drain()
    assert server.registry.seqno == 1 and server._floor() == 0
    gathered.done = True
    assert server._floor() == 1 and not server._dispatched


def test_bind_device_skips_a_card_without_an_index(monkeypatch):
    """A server thread binds the table's card only where the device names an
    index: ``torch.cuda.set_device`` refuses ``torch.device("cuda")``, and a
    background fold's thread would die at its first line."""
    from repro_torch.serve_table.server import TableServer

    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    for dev in (torch.device("cuda"), torch.device("cuda", 0), torch.device("cpu")):
        TableServer._bind_device(types.SimpleNamespace(table=types.SimpleNamespace(device=dev)))
    assert calls == [torch.device("cuda", 0)]
