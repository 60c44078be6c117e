"""Parity of the port's linear bucket probe (kernel 5 and the paper-faithful
query path) with the JAX package.

The plain twin is held against the Pallas ``bucket_probe_2d`` in interpret
mode and against its oracle ``ref.bucket_probe_ref``, with windows longer
than ``max_probe`` so the under-count is exercised; ``query_count_probe``
against the reference's on one CSR; and ``paper_faithful_probe=True`` table
queries against the reference's and against the sorted path at D = 1 and
D = 8, on a base-only table and on a versioned stack.  All comparisons are
exact: every output is an integer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import hashgraph as jhashgraph
from repro.core import table as jtable
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import DistributedHashTable
from repro_torch.core import hashgraph
from repro_torch.core.schema import u32_bits
from repro_torch.kernels import bucket_probe, build, ops


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
