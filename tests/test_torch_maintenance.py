"""The port's incremental compaction against the JAX package.

Mirrors ``tests/test_maintenance.py``: ``fold_oldest(state, k)`` for
k in {1, 2, depth} on a stack whose tombstone epochs straddle every fold
point must give the reference's arrays and reads, and read like a full
``compact()``; ``_remap_tombstones`` with pending TTLs; k = 0 and clamping;
no exchange call on a coherent stack (``exchange.CALLS``); the incoherent
fallback; ``CompactionPolicy`` triggers and ``TableStats`` against the
reference's.  Tolerance: none; every output is an integer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.core import maintenance as jmaintenance
from repro.core import state as jstate
from repro_torch.core import exchange, maintenance
from repro_torch.core.maintenance import CompactionPolicy, TableStats, fold_oldest
from repro_torch.core.state import Tombstones
from test_torch_state import Pair, _mesh, assert_same_reads, assert_same_state
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)


def _deep(p, d, rng):
    """base + 4 deltas with tombstones at epochs 1, 3 and 4, and a reinsert
    of epoch-1-deleted keys in the last delta."""
    keys = rng.integers(0, 1 << 16, size=256, dtype=np.uint32)
    p.init(keys, np.arange(256, dtype=np.int32))
    batches = [
        rng.integers((1 << 16) + i * 4096, (1 << 16) + (i + 1) * 4096, size=8 * d, dtype=np.uint32)
        for i in range(4)
    ]
    vals = [np.arange(10_000 + 1000 * i, 10_000 + 1000 * i + 8 * d, dtype=np.int32) for i in range(4)]
    p.apply("insert", batches[0], vals[0]).apply("delete", keys[:16])
    p.apply("insert", batches[1], vals[1])
    p.apply("insert", batches[2], vals[2])
    p.apply("delete", np.concatenate([keys[16:24], batches[0][: 2 * d]]))
    re_keys = np.concatenate([keys[:8], batches[3][: 8 * d - 8]])
    p.apply("insert", re_keys, vals[3]).apply("delete", batches[2][: 2 * d])
    queries = np.concatenate(
        [keys[:48], batches[0][: 2 * d], batches[2][: 4 * d], batches[3][: 2 * d],
         rng.integers(0, 1 << 16, size=2 * d, dtype=np.uint32)]
    )
    queries = np.concatenate([queries, keys[48 : 48 + (-len(queries)) % (8 * d)]])
    return queries


@pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_fold_oldest_matches_reference_and_compact(d, k, request):
    mesh = _mesh(request, d)
    p = Pair(mesh, d)
    queries = _deep(p, d, np.random.default_rng(3 + d + k))
    assert len(p.ps.deltas) == 4
    unfolded = p.pt.query(p.ps, queries)
    js, ps = p.js, p.ps
    p.js, p.ps = jmaintenance.fold_oldest(js, k), fold_oldest(ps, k)
    assert len(p.ps.deltas) == 4 - k and p.ps.coherent
    p.check(queries)
    np.testing.assert_array_equal(p.pt.query(p.ps, queries).numpy(), unfolded.numpy())
    compacted = ps.compact()
    got, want = p.pt.retrieve(p.ps, queries), p.pt.retrieve(compacted, queries)
    np.testing.assert_array_equal(got.counts.numpy(), want.counts.numpy())
    for a, b in zip(_lists(got), _lists(want)):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    refolded = fold_oldest(p.ps, 4 - k)  # folds compose
    assert len(refolded.deltas) == 0
    np.testing.assert_array_equal(p.pt.query(refolded, queries).numpy(), unfolded.numpy())


def _lists(result):
    from repro_torch import retrieval_to_lists

    return retrieval_to_lists(result)


def _buffer(keys, epochs, expires, now):
    """The same tombstone buffer in both packages."""
    j = jstate.Tombstones(
        keys=jnp.asarray(np.asarray(keys, np.uint32)),
        epochs=jnp.asarray(np.asarray(epochs, np.int32)),
        expires=jnp.asarray(np.asarray(expires, np.int32)),
        count=jnp.int32(int((np.asarray(epochs) >= 0).sum())),
        num_dropped=jnp.int32(3),
        now=jnp.int32(now),
    )
    p = Tombstones(
        keys=torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32).copy()),
        epochs=torch.tensor(epochs, dtype=torch.int32),
        expires=torch.tensor(expires, dtype=torch.int32),
        count=int((np.asarray(epochs) >= 0).sum()),
        num_dropped=3,
        now=now,
    )
    return j, p


@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("now", [0, 4, 9])
def test_remap_tombstones_with_pending_ttls(k, now):
    """Spent entries inside the folded prefix go, later ones shift down by k,
    pending TTL entries survive clamped to 0; the same buffer as the
    reference's, field by field, and the same sorted index."""
    never = jstate.NEVER_EXPIRES
    keys = [5, 6, 7, 0xFFFFFFF0, 9, 10, 11, 0xFFFFFFFF, 0xFFFFFFFF]
    epochs = [1, 2, 3, 3, 1, 2, 4, -1, -1]
    expires = [0, 0, 0, 5, 4, 8, 5, never, never]
    j, p = _buffer(keys, epochs, expires, now)
    jr, pr = jmaintenance._remap_tombstones(j, k), maintenance._remap_tombstones(p, k)
    np.testing.assert_array_equal(pr.keys.numpy().view(np.uint32), np.asarray(jr.keys))
    for name in ("epochs", "expires"):
        np.testing.assert_array_equal(getattr(pr, name).numpy(), np.asarray(getattr(jr, name)))
    assert (pr.count, pr.num_dropped, pr.now) == (int(jr.count), int(jr.num_dropped), int(jr.now))
    jk, je = jr.index()
    pk, pe = pr.index()
    np.testing.assert_array_equal(pk.numpy().view(np.uint32), np.asarray(jk))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    probe = torch.tensor([5, 6, 7, -16, 9, 10, 11, 12], dtype=torch.int32)
    np.testing.assert_array_equal(
        pr.epoch_of(probe).numpy(), np.asarray(jr.epoch_of(jnp.asarray(probe.numpy().view(np.uint32))))
    )


def test_fold_zero_and_clamp(mesh8):
    p = Pair(mesh8, 8)
    rng = np.random.default_rng(11)
    p.init(rng.integers(0, 1 << 14, 256, dtype=np.uint32))
    assert fold_oldest(p.ps, 0) is p.ps
    assert fold_oldest(p.ps, 3) is p.ps  # no deltas: the identity
    p.apply("insert", rng.integers(0, 1 << 14, 8, dtype=np.uint32))
    p.js, p.ps = jmaintenance.fold_oldest(p.js, 99), fold_oldest(p.ps, 99)
    assert len(p.ps.deltas) == 0  # clamped to the depth
    p.check(rng.integers(0, 1 << 14, 64, dtype=np.uint32))


def test_fold_makes_no_exchange_call_on_a_coherent_stack(mesh8):
    p = Pair(mesh8, 8)
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 1 << 14, 512, dtype=np.uint32)
    p.init(keys)
    for _ in range(3):
        p.apply("insert", rng.integers(0, 1 << 14, 64, dtype=np.uint32))
    p.apply("delete", keys[:16])
    exchange.CALLS.clear()
    folded = fold_oldest(p.ps, 2)
    assert dict(exchange.CALLS) == {}
    exchange.CALLS.clear()
    p.ps.compact()  # the full rebuild does exchange: the deal and the build
    assert dict(exchange.CALLS) == {"exchange": 2}
    p.js, p.ps = jmaintenance.fold_oldest(p.js, 2), folded
    p.check(keys[:128])


def test_fold_incoherent_falls_back_to_full_compact(mesh8):
    p = Pair(mesh8, 8, coherent_deltas=False)
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 1 << 14, 256, dtype=np.uint32)
    p.init(keys)
    for _ in range(2):
        p.apply("insert", rng.integers(0, 1 << 14, 16, dtype=np.uint32))
    assert not p.ps.coherent
    before = p.pt.query(p.ps, keys[:64])
    exchange.CALLS.clear()
    p.js, p.ps = jmaintenance.fold_oldest(p.js, 1), fold_oldest(p.ps, 1)
    assert dict(exchange.CALLS) == {"exchange": 2}  # a full compact
    assert len(p.ps.deltas) == 0
    np.testing.assert_array_equal(p.pt.query(p.ps, keys[:64]).numpy(), before.numpy())
    p.check(keys[:64])


def _stats(**kw):
    base = dict(delta_depth=0, base_rows=1024, delta_rows=0, tombstone_count=0,
                tombstone_capacity=64, tombstone_dropped=0, num_dropped=0)
    base.update(kw)
    return base


STATS = [
    {}, {"delta_depth": 4}, {"delta_depth": 3}, {"delta_depth": 8}, {"delta_depth": 1},
    {"tombstone_count": 32}, {"tombstone_count": 31}, {"tombstone_dropped": 1},
    {"num_dropped": 11}, {"num_dropped": 10}, {"delta_depth": 8, "tombstone_count": 40},
    {"delta_depth": 8, "tombstone_dropped": 1}, {"delta_depth": 4, "num_dropped": 11},
    {"tombstone_capacity": 0}, {"tombstone_expired": 40}, {"delta_depth": 5, "tombstone_expired": 10},
]
POLICIES = [
    {}, {"max_delta_depth": 4, "tombstone_load": 0.5, "max_dropped": 10},
    {"max_delta_depth": 8, "fold_k": 2}, {"max_dropped": 10},
    {"max_delta_depth": None, "tombstone_load": 2.0, "max_dropped": None, "tombstone_overflow": False},
    {"fold_k": None, "cold_live_ratio": 0.5}, {"expired_load": 0.5},
]
LAYER_LIVE = [None, ((900, 1024), (3, 80), (2, 80), (40, 80), (1, 80)), ((900, 1024), (0, 80), (0, 80))]


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: ",".join(f"{k}={v}" for k, v in p.items()) or "default")
def test_policy_triggers_match_reference(policy):
    for kw in STATS:
        got, want = CompactionPolicy(**policy), jmaintenance.CompactionPolicy(**policy)
        ps, js = TableStats(**_stats(**kw)), jmaintenance.TableStats(**_stats(**kw))
        assert (ps.tombstone_load, ps.expired_load) == (js.tombstone_load, js.expired_load)
        assert got.due(ps) == want.due(js), kw
        assert got.escalates(ps) == want.escalates(js), kw
        for live in LAYER_LIVE:
            assert got.fold_amount(ps, live) == want.fold_amount(js, live), (kw, live)


def test_policy_fixed_points():
    p = CompactionPolicy(max_delta_depth=8, fold_k=2)
    assert p.fold_amount(TableStats(**_stats(delta_depth=8))) == 2
    assert p.fold_amount(TableStats(**_stats(delta_depth=8, tombstone_dropped=1))) == 8
    assert p.escalates(TableStats(**_stats(delta_depth=0, tombstone_count=40)))
    assert not p.escalates(TableStats(**_stats(delta_depth=8)))


def test_stats_and_layer_live_match_reference(mesh8):
    p = Pair(mesh8, 8, max_deltas=2, tombstone_capacity=16)
    rng = np.random.default_rng(19)
    keys = rng.integers(0, 1 << 14, 256, dtype=np.uint32)
    p.init(keys)
    assert dataclasses.asdict(p.ps.stats()) == dataclasses.asdict(p.js.stats())
    p.apply("insert", rng.integers(0, 1 << 14, 8, dtype=np.uint32)).apply("delete", keys[:8])
    p.apply("upsert", keys[8:11], np.arange(3, dtype=np.int32), ttl=2)
    p.apply("advance", 1)
    got, want = p.ps.stats(), p.js.stats()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert maintenance.collect_layer_live(p.ps) == jmaintenance.collect_layer_live(p.js)
    assert maintenance.allocated_rows(p.ps) == jmaintenance.allocated_rows(p.js)
    p.apply("advance", 2)
    assert dataclasses.asdict(p.ps.stats()) == dataclasses.asdict(p.js.stats())
    assert maintenance.collect_layer_live(p.ps) == jmaintenance.collect_layer_live(p.js)
    assert_same_state(p.ps, p.js)
    assert_same_reads(p.pt, p.ps, p.jt, p.js, keys[:64])
