"""Parity of the port's linear bucket probe (kernel 5 and the paper-faithful
query path) with the JAX package.

The plain twin is held against the Pallas ``bucket_probe_2d`` in interpret
mode and against its oracle ``ref.bucket_probe_ref``, with windows longer
than ``max_probe`` so the under-count is exercised; ``query_count_probe``
against the reference's on one CSR; the layer entry's plain twin
(``bucket_probe_layer_plain``: rebase, windows, probe, mask and running
total in one call) against the composition of the table's plain steps and
against the reference's ``_rebase_buckets`` / ``query_count_probe`` /
``_mask_counts``; and ``paper_faithful_probe=True`` table queries against
the reference's and against the sorted path at D = 1 and D = 8, on a
base-only table and on a versioned stack, with one layer call per layer.
All comparisons are exact: every output is an integer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.core import hashgraph as jhashgraph
from repro.core import multi_hashgraph as jmh
from repro.core import table as jtable
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import DistributedHashTable
from repro_torch.core import hashgraph, hashing
from repro_torch.core import multi_hashgraph as mh
from repro_torch.core.schema import u32_bits
from repro_torch.kernels import bucket_probe, build, ops
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)


def _windows(rng, n_q: int, table_len: int, max_len: int):
    starts = rng.integers(0, table_len, size=n_q).astype(np.int32)
    lens = rng.integers(0, max_len + 1, size=n_q)
    lens[::5] = 0  # empty windows
    ends = np.minimum(starts + lens, table_len).astype(np.int32)
    return starts, ends


# (n_q, table_len, distinct keys, longest window, max_probe)
CASES = [
    (300, 1000, 7, 12, 64),   # every window fits
    (300, 1000, 3, 40, 16),   # windows past max_probe: under-count
    (257, 129, 2, 129, 5),    # tiny probe cap, one window spans the table
    (64, 50, 1, 50, 0),       # max_probe 0 counts nothing
]


@pytest.mark.parametrize("n_q,table_len,distinct,max_len,max_probe", CASES)
def test_plain_probe_matches_pallas_and_oracle(n_q, table_len, distinct, max_len, max_probe):
    rng = np.random.default_rng(n_q + max_probe)
    table = rng.integers(0, distinct, size=table_len).astype(np.uint32)
    table[::11] = 0xFFFFFFFF  # high-bit keys compare as uint32 bit patterns
    starts, ends = _windows(rng, n_q, table_len, max_len)
    q = rng.integers(0, distinct, size=n_q).astype(np.uint32)
    q[::13] = 0xFFFFFFFF
    want = np.asarray(jref.bucket_probe_ref(
        jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(q), jnp.asarray(table), max_probe
    ))
    pallas = np.asarray(jops.bucket_probe(
        jnp.asarray(table), jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(q),
        max_probe=max_probe, interpret=True,
    ))
    np.testing.assert_array_equal(pallas, want)
    got = bucket_probe.bucket_probe_plain(
        torch.from_numpy(starts), torch.from_numpy(ends), u32_bits(q), u32_bits(table), max_probe
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    full = np.asarray(jref.bucket_probe_ref(
        jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(q), jnp.asarray(table), 4 * table_len
    ))
    if max_len > max_probe:
        assert (want < full).any()  # the cap really bit


def test_shard_axis_and_entry_point_match_per_shard_oracle():
    """``(S, N)`` slots over ``(S, M)`` tables equal S separate probes; the
    ``ops`` entry point takes the reference's argument order and uint32."""
    rng = np.random.default_rng(5)
    s, n, m, max_probe = 4, 200, 300, 8
    tables = rng.integers(0, 4, size=(s, m)).astype(np.uint32)
    starts, ends = _windows(rng, s * n, m, 20)
    starts, ends = starts.reshape(s, n), ends.reshape(s, n)
    q = rng.integers(0, 4, size=(s, n)).astype(np.uint32)
    want = np.stack([
        np.asarray(jref.bucket_probe_ref(
            jnp.asarray(starts[i]), jnp.asarray(ends[i]), jnp.asarray(q[i]),
            jnp.asarray(tables[i]), max_probe,
        ))
        for i in range(s)
    ])
    got = ops.bucket_probe(
        torch.from_numpy(tables).view(torch.int32).reshape(s, m).contiguous(),
        torch.from_numpy(starts.astype(np.int64)),
        torch.from_numpy(ends.astype(np.int64)),
        torch.from_numpy(q.view(np.int32)),
        max_probe=max_probe,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    table_u32 = torch.from_numpy(tables[0].copy())
    assert table_u32.dtype == torch.uint32
    flat = ops.bucket_probe(
        table_u32, torch.from_numpy(starts[0]), torch.from_numpy(ends[0]),
        torch.from_numpy(q[0].copy()), max_probe=max_probe,
    )
    np.testing.assert_array_equal(flat.numpy(), want[0])
    with pytest.raises(ValueError):
        bucket_probe.bucket_probe(
            torch.from_numpy(starts), torch.from_numpy(ends), u32_bits(q[0]),
            u32_bits(tables[0]), max_probe,
        )


@pytest.mark.parametrize("dup,max_probe", [(1, 64), (4, 64), (16, 8)], ids=["unique", "dup4", "undercount"])
def test_query_count_probe_matches_reference(dup, max_probe):
    rng = np.random.default_rng(dup)
    base = rng.integers(0, 1 << 24, size=max(1, 1024 // dup), dtype=np.uint32)
    keys = np.repeat(base, dup)[:1024]
    hg = jhashgraph.build(jnp.asarray(keys), table_size=64)
    queries = np.concatenate([base[:64], rng.integers(0, 1 << 24, size=64, dtype=np.uint32)])
    want = np.asarray(jhashgraph.query_count_probe(hg, jnp.asarray(queries), max_probe=max_probe))
    port_hg = hashgraph.HashGraph(
        offsets=torch.from_numpy(np.asarray(hg.offsets)).unsqueeze(0),
        keys=u32_bits(np.asarray(hg.keys)).unsqueeze(0),
        values=torch.from_numpy(np.asarray(hg.values)).unsqueeze(0),
        table_size=64,
        seed=hg.seed,
    )
    got = hashgraph.query_count_probe(port_hg, u32_bits(queries).unsqueeze(0), max_probe=max_probe)
    np.testing.assert_array_equal(got[0].numpy(), want)
    if max_probe < 64:  # buckets of ~16 rows: the cap under-counts in both
        sorted_counts = np.asarray(jhashgraph.query_count_sorted(hg, jnp.asarray(queries)))
        assert (want <= sorted_counts).all() and (want < sorted_counts).any()


def _stack(table, keys, rng, d):
    """base + 3 deltas with deletes at epochs 1 and 3 and a reinsert."""
    state = table.init(keys)
    ins = [rng.integers(0, 600, size=16 * d, dtype=np.uint32) for _ in range(3)]
    state = state.insert(ins[0])
    state = state.delete(keys[:12])
    state = state.insert(ins[1])
    state = state.insert(np.concatenate([keys[:4], ins[2][: 16 * d - 4]]))
    return state.delete(ins[0][:3])


@pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])
@pytest.mark.parametrize("depth", [0, 3])
def test_probe_table_matches_reference_and_sorted_path(d, depth, request):
    mesh = request.getfixturevalue("mesh1" if d == 1 else "mesh8")
    rng = np.random.default_rng(100 + d)
    keys = rng.integers(0, 500, size=1024, dtype=np.uint32)
    keys[7::101] = 0xFFFFFFFF
    queries = np.concatenate([
        keys[:120], rng.integers(0, 700, size=128 - 8, dtype=np.uint32),
        np.array([0xFFFFFFFE, 0xFFFFFFFF, 1, 2, 3, 499, 500, 12345], np.uint32),
    ])
    results = {}
    for probe, max_probe in ((False, 64), (True, 64), (True, 2)):
        jt = jtable.DistributedHashTable(
            mesh, ("d",), hash_range=1 << 10, paper_faithful_probe=probe, max_probe=max_probe
        )
        pt = DistributedHashTable(
            num_shards=d, hash_range=1 << 10, device="cpu",
            paper_faithful_probe=probe, max_probe=max_probe,
        )
        if depth:
            js = _stack(jt, jnp.asarray(keys), np.random.default_rng(d), d)
            ps = _stack(pt, keys, np.random.default_rng(d), d)
        else:
            js, ps = jt.init(jnp.asarray(keys)), pt.init(keys)
        want = np.asarray(jt.query(js, jnp.asarray(queries)))
        got = pt.query(ps, queries)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(pt.join_size(ps, queries)) == int(jt.join_size(js, jnp.asarray(queries)))
        results[(probe, max_probe)] = want
    np.testing.assert_array_equal(results[(True, 64)], results[(False, 64)])
    # buckets of 1024 keys over ~1.5 × 2^10 / d slots hold more than 2 rows
    assert (results[(True, 2)] <= results[(False, 64)]).all()


def test_cpu_probe_counts_no_launch():
    before = dict(build.LAUNCHES)
    z = torch.zeros(8, dtype=torch.int32)
    bucket_probe.bucket_probe(z, z + 1, z, z, 4)
    assert dict(build.LAUNCHES) == before


def _probe_layer_inputs(seed: int, d: int, stride: int):
    """A routed batch and one layer of ``d`` shards built the table's way.

    Keys come from a narrow range (so windows hold several rows and
    ``max_probe`` 2 bites), every 9th stored key is EMPTY (the trash
    bucket's rows), the split bases lie above some hashes (negative
    ``rh - lo``, clamped to bucket 0) and the bucket space is small (high
    hashes clamp into bucket ``V - 1``).  The routed batch mixes stored
    keys, absent keys and EMPTY padding.
    """
    rng = np.random.default_rng(seed)
    hash_range, table_size, m, n = 1 << 10, 40, 300, 203
    lo = torch.from_numpy(rng.integers(0, hash_range // 2, size=d).astype(np.int32))
    keys = rng.integers(0, 90, size=(d, m)).astype(np.uint32)
    keys[:, ::9] = 0xFFFFFFFF
    keys_t = u32_bits(keys)
    h = hashing.hash_to_buckets_plain(keys_t, hash_range)
    buckets = mh._rebase_buckets(h, keys_t == -1, lo.reshape(-1, 1), table_size, stride)
    values = torch.arange(d * m, dtype=torch.int32).reshape(d, m)
    layer = hashgraph.build_from_buckets(keys_t, buckets, table_size, values)
    rq = rng.integers(0, 120, size=(d, n)).astype(np.uint32)
    rq[:, ::7] = 0xFFFFFFFF
    rq_t = u32_bits(rq)
    rh = hashing.hash_to_buckets_plain(rq_t, hash_range)
    match_e = torch.from_numpy(rng.integers(-1, 4, size=(d, n)).astype(np.int32))
    prev = torch.from_numpy(rng.integers(0, 5, size=(d, n)).astype(np.int32))
    return dict(rq=rq_t, rh=rh, lo=lo, match_e=match_e, offsets=layer.offsets,
                keys=layer.keys, table_size=table_size, prev=prev)


@pytest.mark.parametrize("accumulate", [False, True], ids=["first", "accumulate"])
@pytest.mark.parametrize("masked", [True, False], ids=["match_e", "no_tombstones"])
@pytest.mark.parametrize("max_probe", [0, 2, 64])
@pytest.mark.parametrize("stride", [1, 3])
def test_layer_plain_equals_composed_steps_and_reference(stride, max_probe, masked, accumulate):
    """``bucket_probe_layer`` on the CPU (its plain twin) equals rebase ->
    windows -> window probe -> mask -> add, and the JAX package's
    ``_rebase_buckets`` -> ``query_count_probe`` -> ``_mask_counts`` per
    shard; it writes ``total`` for the first layer and adds to it after."""
    d, epoch = 3, 1
    a = _probe_layer_inputs(stride * 100 + max_probe, d, stride)
    match_e = a["match_e"] if masked else None
    total = a["prev"].clone() if accumulate else torch.full_like(a["prev"], 12345)
    got = bucket_probe.bucket_probe_layer(
        a["rq"], a["rh"], a["lo"], match_e, a["offsets"], a["keys"],
        table_size=a["table_size"], stride=stride, epoch=epoch, max_probe=max_probe,
        total=total, accumulate=accumulate,
    )
    assert got is total and got.dtype == torch.int32

    rb = mh._rebase_buckets(a["rh"], a["rq"] == -1, a["lo"].reshape(-1, 1), a["table_size"], stride)
    starts, ends = hashgraph.bucket_windows(a["offsets"], a["table_size"], rb)
    c = ops.bucket_probe(a["keys"], starts, ends, a["rq"], max_probe=max_probe)
    c = mh._mask_counts(c, a["rq"], layer_epoch=epoch, match_e=match_e)
    composed = a["prev"] + c if accumulate else c
    assert torch.equal(got, composed)

    rq_u = a["rq"].numpy().view(np.uint32)
    for s in range(d):
        jhg = jhashgraph.HashGraph(
            offsets=jnp.asarray(a["offsets"][s].numpy()),
            keys=jnp.asarray(a["keys"][s].numpy().view(np.uint32)),
            values=jnp.zeros(a["keys"].shape[1], jnp.int32),
            table_size=a["table_size"], seed=hashing.DEFAULT_SEED, sorted_within_bucket=True,
        )
        q = jnp.asarray(rq_u[s])
        jb = jmh._rebase_buckets(jnp.asarray(a["rh"][s].numpy()), jhashgraph.is_empty_key(q),
                                 jnp.int32(int(a["lo"][s])), a["table_size"], stride)
        jc = jhashgraph.query_count_probe(jhg, q, max_probe=max_probe, buckets=jb)
        jc = jmh._mask_counts(jc, q, None, epoch,
                              None if match_e is None else jnp.asarray(match_e[s].numpy()))
        want = np.asarray(jc) + (a["prev"][s].numpy() if accumulate else 0)
        np.testing.assert_array_equal(got[s].numpy(), want)
    if max_probe == 64:
        assert int(c.max()) > 2  # windows of several matching rows were counted


def test_layer_probe_refuses_what_it_does_not_take():
    a = _probe_layer_inputs(1, 2, 1)
    kw = dict(table_size=a["table_size"], stride=1, epoch=0, max_probe=8, accumulate=False)
    args = (a["rq"], a["rh"], a["lo"], None, a["offsets"], a["keys"])
    total = torch.zeros_like(a["rq"])
    with pytest.raises(TypeError):
        bucket_probe.bucket_probe_layer(*args, total=total.to(torch.int64), **kw)
    with pytest.raises(ValueError):  # offsets of another table size
        bucket_probe.bucket_probe_layer(*args, **{**kw, "table_size": 7}, total=total)
    with pytest.raises(ValueError):
        bucket_probe.bucket_probe_layer(a["rq"], a["rh"][:, 1:], *args[2:], total=total, **kw)
    with pytest.raises(ValueError):
        bucket_probe.bucket_probe_layer(*args, total=total, **{**kw, "stride": 0})
    with pytest.raises(ValueError):  # one split base per shard
        bucket_probe.bucket_probe_layer(a["rq"], a["rh"], a["lo"][:1], *args[3:], total=total, **kw)
    before = dict(build.LAUNCHES)
    bucket_probe.bucket_probe_layer(*args, total=total, **kw)
    assert dict(build.LAUNCHES) == before  # the CPU path launches nothing


@pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])
def test_probe_query_takes_one_layer_call_per_layer(d, monkeypatch):
    """A probe table's query over a coherent stack of 4 layers makes one
    layer call per layer, in epoch order, the first writing and the others
    adding, and no call of the window entry; a mixed-split read makes one
    per layer too."""
    calls, windows = [], []
    layer_plain = bucket_probe.bucket_probe_layer_plain
    window_entry = bucket_probe.bucket_probe

    def spy(*args, **kw):
        calls.append((kw["epoch"], kw["accumulate"]))
        return layer_plain(*args, **kw)

    def spy_windows(*args, **kw):
        windows.append(1)
        return window_entry(*args, **kw)

    monkeypatch.setattr(bucket_probe, "bucket_probe_layer_plain", spy)
    monkeypatch.setattr(bucket_probe, "bucket_probe", spy_windows)
    rng = np.random.default_rng(d)
    keys = rng.integers(0, 500, size=1024, dtype=np.uint32)
    queries = rng.integers(0, 700, size=256, dtype=np.uint32)
    probe = DistributedHashTable(num_shards=d, hash_range=1 << 10, device="cpu",
                                 paper_faithful_probe=True)
    state = _stack(probe, keys, np.random.default_rng(d), d)
    assert len(state.layers) == 4 and state.coherent
    probe.query(state, queries)
    assert calls == [(0, False), (1, True), (2, True), (3, True)]
    assert windows == []
    calls.clear()
    mixed = mh.query_layers_sharded(
        state.layers, torch.from_numpy(queries.view(np.int32)).reshape(d, -1),
        tombstones=state.tombstones.index(), fused=False, paper_faithful_probe=True,
    )
    assert calls == [(0, False), (1, False), (2, False), (3, False)]
    want = probe.query(state, queries)
    assert torch.equal(mixed.reshape(-1), want.reshape(-1))
