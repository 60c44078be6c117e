"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither jax nor the JAX package, so it also runs on a machine that has only
PyTorch, skipping the repo's JAX conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The table kernels' comparisons are exact: every output is an integer.
Kernel 6 (flash attention) is held against its plain twin at 2e-5 in f32
(the same f32 arithmetic in another summation order) and 2e-2 in bf16 (the
output is rounded to 8 significant bits, so a different f32 sum can land
one bf16 step away; |o| < 2 here).  Kernel 7 (the sLSTM recurrence) is held
at 2e-5 on the JAX kernel tests' shapes (f32 throughout; its hd-term dot
products are summed in another order) and at 1e-4 where hundreds of steps
at hd = 512 carry that difference forward.  Matrix products run with TF32 off and
without reduced-precision bf16 reductions (set by the ``card`` fixture).
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import DistributedHashTable, join_to_pairs
from repro_torch.core import convert, exchange
from repro_torch.core.hashing import DEFAULT_SEED, FINGERPRINT_SEED
from repro_torch.core.schema import u32_bits
from repro_torch.core import maintenance
from repro_torch.core import multi_hashgraph as mh
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import bucket_probe, build, csr_gather, histogram, murmur, ops
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import slstm
from repro_torch.models.api import build_model
from repro_torch.serve import ContinuousBatcher, Request, make_prefill_step, make_serve_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def test_murmur_and_histogram_kernels_match_plain(card):
    rng = np.random.default_rng(0)
    for n in (1, 5, 4099, 1 << 20):
        keys = u32_bits(rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32))
        for seed in (DEFAULT_SEED, FINGERPRINT_SEED):
            got = murmur.murmur_bucket(keys.to(card), 1 << 27, seed)
            assert torch.equal(got.cpu(), murmur.murmur_bucket_plain(keys, 1 << 27, seed))
        bins = torch.from_numpy(rng.integers(-3, 11648 + 3, size=n, dtype=np.int32))
        for num_bins in (128, 11648, 50000):
            got = histogram.bin_histogram(bins.to(card), num_bins)
            assert torch.equal(got.cpu(), histogram.bin_histogram_plain(bins, num_bins))


@pytest.mark.parametrize(
    "n_rows,table_len,capacity",
    [(40, 300, 512), (200, 1000, 256), (1, 8, 16), (0, 16, 64), (5000, 20000, 30000)],
)
def test_gather_kernels_match_plain(card, n_rows, table_len, capacity):
    rng = np.random.default_rng(n_rows)
    counts = rng.integers(0, 5, size=(2, n_rows)).astype(np.int32)
    counts[:, ::3] = 0  # zero-count rows share an offset
    starts = rng.integers(0, max(1, table_len - 5), size=(2, n_rows)).astype(np.int32)
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    table = torch.from_numpy(rng.integers(-99, 99, size=table_len, dtype=np.int32))
    before = dict(build.LAUNCHES)
    for fn, args in ((ops.csr_gather, (st[0], ct[0])), (ops.csr_gather_batched, (st, ct))):
        want = fn(*args, table, capacity=capacity)
        got = fn(*(a.to(card) for a in args), table.to(card), capacity=capacity)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert build.LAUNCHES["csr_gather"] == before.get("csr_gather", 0) + 1
    assert build.LAUNCHES["csr_gather_batched"] == before.get("csr_gather_batched", 0) + 1


def _gather_runs(rng, shape, width, zero_frac, max_count):
    """Run descriptors inside a table row of ``width`` words."""
    if width == 0:
        return np.zeros(shape, np.int32), np.zeros(shape, np.int32)
    counts = rng.integers(0, max_count, size=shape).astype(np.int32)
    counts[rng.random(shape) < zero_frac] = 0
    starts = rng.integers(0, width, size=shape).astype(np.int32)
    return starts, np.minimum(counts, width - starts).astype(np.int32)


# (L, D, R, layer widths, seg_capacity, zero_frac, max_count, one long run)
OWNER_CARD_CASES = {
    "small": (3, 2, 300, (200, 50, 80), 700, 0.4, 5, None),
    "deep-d4": (7, 4, 500, (900, 200, 200, 200, 200, 200, 60), 3001, 0.4, 5, None),
    "2^22 slots": (7, 1, 1 << 19, (1 << 21, 1 << 19, 1 << 19, 1 << 19, 1 << 19, 1 << 19, 1 << 14),
                   1 << 22, 0.3, 4, None),
    "empty rows past the stage": (3, 1, 60000, (4000, 300, 300), 512, 0.999, 4, None),
    "2^16-long run": (2, 1, 1000, (1 << 17, 500), 1 << 17, 0.5, 3, 1 << 16),
    "total 0": (3, 2, 100, (100, 100, 100), 64, 1.0, 3, None),
    "total above capacity": (3, 2, 400, (300, 300, 300), 257, 0.4, 5, None),
    "depth 70": (70, 2, 300, (400,) * 35 + (90,) * 35, 3000, 0.6, 3, None),
}


@pytest.mark.parametrize("case", list(OWNER_CARD_CASES))
def test_owner_entry_matches_plain(card, case):
    nl, d, r, widths, cap, zero_frac, max_count, long_run = OWNER_CARD_CASES[case]
    rng = np.random.default_rng(len(case))
    tables = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(d, w), dtype=np.int32))
              for w in widths]
    runs = [_gather_runs(rng, (d, d, r), w, zero_frac, max_count) for w in widths]
    starts = torch.from_numpy(np.stack([s for s, _ in runs]))
    counts = torch.from_numpy(np.stack([c for _, c in runs]))
    if long_run is not None:
        starts[0, 0, 0, r // 2], counts[0, 0, 0, r // 2] = 0, long_run
    slot = counts.sum(0, dtype=torch.int32)
    args = [starts, counts, tables]
    card_args = [starts.to(card), counts.to(card), [t.to(card) for t in tables]]
    before = dict(build.LAUNCHES)
    got = csr_gather.csr_gather_owners(*card_args, cap)
    torch.cuda.synchronize()
    assert build.LAUNCHES["csr_gather_owners"] == before.get("csr_gather_owners", 0) + 1
    want = csr_gather.csr_gather_owners_plain(*card_args, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[2].cpu(), slot)
    totals = slot.to(torch.int64).sum(-1)
    if case == "total 0":
        assert int(totals.max()) == 0
    elif case == "total above capacity":
        assert int(got[1].sum()) > 0
    elif case == "2^22 slots":
        assert int(totals.max()) > 3 << 20
    # The slot totals equal to the capacity: the segment is exactly full.
    exact = int(totals.max())
    if 0 < exact <= csr_gather.MAX_CAPACITY and case == "small":
        g = csr_gather.csr_gather_owners(*card_args, exact)
        w = csr_gather.csr_gather_owners_plain(*args, exact)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(g, w))
        assert int(g[1].sum()) == 0


# (D, rows, table width, capacity, zero_frac, max_count, one long run)
QUERIER_CARD_CASES = {
    "small": (2, 300, 900, 700, 0.4, 5, None),
    "d4": (4, 5000, 16000, 12001, 0.4, 5, None),
    "2^22 slots": (1, 1 << 21, 1 << 23, 1 << 22, 0.2, 4, None),
    "empty rows past the stage": (2, 200000, 3000, 300, 0.9995, 4, None),
    "2^16-long run": (2, 4000, 1 << 17, 1 << 17, 0.5, 3, 1 << 16),
    "total 0": (2, 100, 100, 64, 1.0, 3, None),
    "total above capacity": (4, 600, 1000, 333, 0.4, 5, None),
}


@pytest.mark.parametrize("case", list(QUERIER_CARD_CASES))
def test_querier_entry_matches_plain(card, case):
    d, n, width, cap, zero_frac, max_count, long_run = QUERIER_CARD_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    table = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(d, width), dtype=np.int32))
    starts, counts = (torch.from_numpy(a) for a in _gather_runs(rng, (d, n), width, zero_frac,
                                                              max_count))
    if long_run is not None:
        starts[0, n // 3], counts[0, n // 3] = 0, long_run
    args = [starts.to(card), counts.to(card), table.to(card)]
    before = dict(build.LAUNCHES)
    got = csr_gather.csr_gather_queriers(*args, cap)
    torch.cuda.synchronize()
    assert build.LAUNCHES["csr_gather_queriers"] == before.get("csr_gather_queriers", 0) + 1
    want = csr_gather.csr_gather_queriers_plain(*args, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    totals = counts.to(torch.int64).sum(-1)
    if case == "total above capacity":
        assert int(got[3].sum()) > 0
    exact = int(totals.max())
    if case == "small":  # a capacity equal to the largest total
        g = csr_gather.csr_gather_queriers(*args, exact)
        w = csr_gather.csr_gather_queriers_plain(starts, counts, table, exact)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(g, w))
        assert int(g[3].sum()) == 0


def test_gather_entries_rebase_flat_sums_past_2_31(card):
    """Both entries scan every block's rows in one flat int32 sum and rebase
    each block: where that sum passes 2^31 (every row a 2^20-word run of one
    table, 2^28-2^29 words a block, 2^32 in all) each block's overflow and
    segment still equal the twin's."""
    width, run = 1 << 20, 1 << 20
    table = torch.arange(8 * width, dtype=torch.int32).reshape(8, width)
    starts = torch.zeros((8, 512), dtype=torch.int32)
    counts = torch.full((8, 512), run, dtype=torch.int32)
    got = csr_gather.csr_gather_queriers(starts.to(card), counts.to(card), table.to(card), 4096)
    want = csr_gather.csr_gather_queriers_plain(starts, counts, table, 4096)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(got[3][0]) == 512 * run - 4096
    tables = [table[:4]]
    st = torch.zeros((1, 4, 4, 256), dtype=torch.int32)
    ct = torch.full((1, 4, 4, 256), run, dtype=torch.int32)
    got = csr_gather.csr_gather_owners(st.to(card), ct.to(card), [t.to(card) for t in tables],
                                       4096)
    want = csr_gather.csr_gather_owners_plain(st, ct, tables, 4096)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(got[1][3, 3]) == 256 * run - 4096


def _deep_stack(t, d, rng):
    keys = rng.integers(0, 3000, size=4096, dtype=np.uint32)
    keys[1000:1300] = keys[5]  # one key, 300 duplicates
    s = t.init(keys)
    for i in range(3):
        s = s.insert(rng.integers(0, 3000, size=256, dtype=np.uint32))
        s = s.delete(keys[40 * i + 100: 40 * i + 124])
    return s.upsert(keys[200:216], np.arange(16, dtype=np.int32))


@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "mixed-splits"])
def test_retrieve_and_join_on_card_match_cpu_through_a_deep_stack(card, d, coherent):
    """Retrieve and inner join over base + 4 deltas with tombstones (depth 4)
    equal the CPU's; each makes one owner launch per routing round (one on a
    coherent stack, one a layer on a mixed-split one) and one querier
    launch, and no launch of the Pallas-interface gathers."""
    queries = np.random.default_rng(d).integers(0, 3500, size=1024, dtype=np.uint32)
    out = {}
    for where in (card, "cpu"):
        t = DistributedHashTable(num_shards=d, hash_range=1 << 12, device=where,
                                 coherent_deltas=coherent)
        s = _deep_stack(t, d, np.random.default_rng(7 + d))
        assert s.epoch == 4 and s.coherent == coherent
        caps = t.plan_caps(s, queries)
        before = dict(build.LAUNCHES)
        r = t.retrieve(s, queries)
        j = t.inner_join(s, queries)
        small = t.retrieve(s, queries, out_capacity=caps[1] // 3, seg_capacity=caps[0] // 2)
        if where == card:
            torch.cuda.synchronize()
            rounds = 1 if coherent else len(s.layers)
            got = {k: build.LAUNCHES[k] - before.get(k, 0) for k in (
                "csr_gather_owners", "csr_gather_queriers", "csr_gather", "csr_gather_batched")}
            assert got == {"csr_gather_owners": 3 * rounds, "csr_gather_queriers": 3,
                           "csr_gather": 0, "csr_gather_batched": 0}
        out[str(where)] = [r.offsets.cpu(), r.values.cpu(), r.counts.cpu(), r.num_dropped.cpu(),
                           torch.from_numpy(join_to_pairs(j)), small.offsets.cpu(),
                           small.values.cpu(), small.num_dropped.cpu()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    # Truncated at the small capacities; at the planned ones only a
    # mixed-split stack's small deltas may overflow the query dispatch.
    assert int(out["cpu"][7]) > 0 and (int(out["cpu"][3]) == 0 or not coherent)


def test_retrieve_and_join_on_card_match_cpu_through_a_70_layer_deep_stack(card):
    """A coherent stack of 70 layers (base + 69 inserts, a delete among
    them): retrieve and inner join equal the CPU's, one owner launch each."""
    rng = np.random.default_rng(70)
    keys = rng.integers(0, 2000, size=2048, dtype=np.uint32)
    batches = [rng.integers(0, 2000, size=32, dtype=np.uint32) for _ in range(69)]
    queries = rng.integers(0, 2100, size=512, dtype=np.uint32)
    out = {}
    for where in (card, "cpu"):
        t = DistributedHashTable(num_shards=2, hash_range=1 << 11, device=where, max_deltas=80)
        s = t.init(keys)
        for i, b in enumerate(batches):
            if i == 30:
                s = s.delete(keys[:16])
            s = s.insert(b, np.arange(100 * i, 100 * i + 32, dtype=np.int32))
        assert len(s.layers) == 70 and s.coherent
        before = build.LAUNCHES.get("csr_gather_owners", 0)
        r = t.retrieve(s, queries)
        j = t.inner_join(s, queries)
        if where == card:
            torch.cuda.synchronize()
            assert build.LAUNCHES["csr_gather_owners"] - before == 2
        out[str(where)] = [r.offsets.cpu(), r.values.cpu(), r.counts.cpu(), r.num_dropped.cpu(),
                           torch.from_numpy(join_to_pairs(j))]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    assert int(out["cpu"][3]) == 0 and int(out["cpu"][2].sum()) > 0


@pytest.mark.parametrize("d", [1, 8])
def test_card_path_matches_cpu_path(card, d):
    rng = np.random.default_rng(d)
    keys = rng.integers(0, 300, size=1024, dtype=np.uint32)
    keys[5::97] = 0xFFFFFFFF
    queries = rng.integers(0, 400, size=256, dtype=np.uint32)
    on_card = DistributedHashTable(num_shards=d, hash_range=1 << 12, device=card)
    on_cpu = DistributedHashTable(num_shards=d, hash_range=1 << 12, device="cpu")
    sg, sc = on_card.init(keys), on_cpu.init(keys)
    got, want = convert.graph_to_numpy(sg.base), convert.graph_to_numpy(sc.base)
    for name in ("offsets", "keys", "values", "hash_splits", "num_dropped"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert torch.equal(on_card.query(sg, queries).cpu(), on_cpu.query(sc, queries))
    rg, rc = on_card.retrieve(sg, queries), on_cpu.retrieve(sc, queries)
    for name in ("offsets", "values", "counts"):
        assert torch.equal(getattr(rg, name).cpu(), getattr(rc, name)), name
    np.testing.assert_array_equal(
        join_to_pairs(on_card.inner_join(sg, queries)),
        join_to_pairs(on_cpu.inner_join(sc, queries)),
    )


@pytest.mark.parametrize("shards,n,table_len,max_len,max_probe", [
    (1, 5000, 20000, 12, 64), (8, 3000, 4000, 90, 64), (3, 257, 129, 129, 5), (2, 0, 16, 4, 8),
])
def test_bucket_probe_kernel_matches_plain(card, shards, n, table_len, max_len, max_probe):
    rng = np.random.default_rng(n + shards)
    table = torch.from_numpy(rng.integers(-3, 3, size=(shards, table_len), dtype=np.int32))
    starts = rng.integers(-2, table_len, size=(shards, n))
    ends = starts + rng.integers(-1, max_len + 1, size=(shards, n))
    st = torch.from_numpy(starts.astype(np.int32))
    en = torch.from_numpy(np.minimum(ends, table_len + 3).astype(np.int32))
    q = torch.from_numpy(rng.integers(-3, 3, size=(shards, n), dtype=np.int32))
    want = bucket_probe.bucket_probe_plain(st, en, q, table, max_probe)
    before = build.LAUNCHES["bucket_probe"]
    got = bucket_probe.bucket_probe(st.to(card), en.to(card), q.to(card), table.to(card), max_probe)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert build.LAUNCHES["bucket_probe"] == before + (1 if n else 0)
    flat = bucket_probe.bucket_probe(st[0].to(card), en[0].to(card), q[0].to(card),
                                     table[0].to(card), max_probe)
    assert torch.equal(flat.cpu(), want[0])


def _layer_case(seed, d, n, table_size):
    """A routed batch and a CSR layer for the layer probe: bucket sizes of
    mean 0.7, keys and queries from 4 values (so windows match), every 7th
    slot EMPTY padding, split bases above some hashes, tombstone epochs in
    [-1, 3] and a running total to add to."""
    rng = np.random.default_rng(seed)
    sizes = rng.poisson(0.7, size=(d, table_size + 1))
    offsets = np.zeros((d, table_size + 2), np.int64)
    offsets[:, 1:] = np.cumsum(sizes, axis=1)
    m = int(offsets[:, -1].max())
    offsets[:, -1] = m  # every row ends at M (the trash bucket takes the rest)
    keys = rng.integers(0, 4, size=(d, m), dtype=np.int32)
    rq = rng.integers(0, 4, size=(d, n), dtype=np.int32)
    rq[:, ::7] = -1
    hash_range = 2 * table_size
    rh = rng.integers(0, hash_range, size=(d, n), dtype=np.int32)
    lo = rng.integers(0, hash_range // 4 + 1, size=d, dtype=np.int32)
    match_e = rng.integers(-1, 4, size=(d, n), dtype=np.int32)
    prev = rng.integers(0, 9, size=(d, n), dtype=np.int32)
    return {name: torch.from_numpy(np.ascontiguousarray(a)) for name, a in (
        ("rq", rq), ("rh", rh), ("lo", lo), ("match_e", match_e), ("prev", prev),
        ("offsets", offsets.astype(np.int32)), ("keys", keys))}


# (d, n, table_size, stride, max_probe, tombstones, accumulate): n not a
# multiple of the kernel's 4 slots a thread, n < 4, n = 0, odd and even
# table sizes (8-byte and split offsets pairs), and 2^22 slots over a
# table beyond the 50 MB L2 (2^24 buckets: 67 MB of offsets, 47 MB of keys).
LAYER_CASES = [
    (1, 4097, 1000, 1, 64, True, False),
    (4, 4097, 1001, 3, 64, False, True),
    (4, 4101, 999, 2, 2, True, True),
    (1, 5, 33, 2, 64, True, True),
    (4, 0, 64, 1, 64, True, True),
    (1, 3000, 500, 1, 0, False, False),
    (1, 1 << 22, (1 << 24) + 3, 1, 64, True, False),
    (4, 1 << 22, (1 << 22) + 1, 2, 64, True, True),
]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_bucket_probe_layer_kernel_matches_plain(card, case):
    d, n, table_size, stride, max_probe, masked, accumulate = case
    a = _layer_case(LAYER_CASES.index(case), d, n, table_size)
    match_e = a["match_e"] if masked else None
    kw = dict(table_size=table_size, stride=stride, epoch=1, max_probe=max_probe,
              accumulate=accumulate)
    want = bucket_probe.bucket_probe_layer(
        a["rq"], a["rh"], a["lo"], match_e, a["offsets"], a["keys"], total=a["prev"].clone(), **kw)
    on = {k: v.to(card) for k, v in a.items()}
    total = on["prev"].clone() if accumulate else torch.full_like(on["prev"], -7)
    before = dict(build.LAUNCHES)
    got = bucket_probe.bucket_probe_layer(
        on["rq"], on["rh"], on["lo"], on["match_e"] if masked else None, on["offsets"],
        on["keys"], total=total, **kw)
    torch.cuda.synchronize()
    assert got is total
    assert torch.equal(got.cpu(), want)
    assert build.LAUNCHES["bucket_probe_layer"] == before.get("bucket_probe_layer", 0) + (1 if n else 0)
    assert build.LAUNCHES["bucket_probe"] == before.get("bucket_probe", 0)
    if n >= 4096 and max_probe:
        assert int(want.max()) > 1  # windows of several matching words were read


@pytest.mark.parametrize("d", [1, 8])
def test_probe_table_on_card_matches_cpu_through_a_deep_stack(card, d):
    """A probe table's query over base + 4 deltas with tombstones (depth 5),
    fused and routed layer by layer, equals the CPU's; the card makes one
    layer launch per layer and never launches the window entry."""
    rng = np.random.default_rng(10 + d)
    keys = rng.integers(0, 3000, size=4096, dtype=np.uint32)
    queries = rng.integers(0, 3500, size=1024, dtype=np.uint32)
    out = {}
    for where in (card, "cpu"):
        t = DistributedHashTable(num_shards=d, hash_range=1 << 12, device=where,
                                 paper_faithful_probe=True)
        rs = np.random.default_rng(d)
        s = t.init(keys)
        for i in range(3):
            s = s.insert(rs.integers(0, 3000, size=256, dtype=np.uint32))
            s = s.delete(keys[40 * i: 40 * i + 24])
        s = s.upsert(keys[200:216], np.arange(16, dtype=np.int32))
        assert s.epoch == 4 and s.coherent
        before = dict(build.LAUNCHES)
        fused = t.query(s, queries).cpu()
        q = torch.from_numpy(queries.view(np.int32)).to(where).reshape(d, -1)
        layered = mh.query_layers_sharded(
            s.layers, q, tombstones=s.tombstones.index(), fused=False,
            paper_faithful_probe=True).cpu()
        if where == card:
            torch.cuda.synchronize()
            assert build.LAUNCHES["bucket_probe_layer"] == before.get("bucket_probe_layer", 0) + 10
            assert build.LAUNCHES["bucket_probe"] == before.get("bucket_probe", 0)
        out[str(where)] = (fused, layered.reshape(-1))
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert torch.equal(out["cpu"][0], out["cpu"][1])


@pytest.mark.parametrize("d", [1, 8])
def test_card_update_path_matches_cpu_path(card, d):
    """Insert, delete, upsert, fold and compact on the card and on the CPU
    give the same arrays and the same sorted and probe reads."""
    rng = np.random.default_rng(d)
    keys = rng.integers(0, 4000, size=2048, dtype=np.uint32)
    queries = rng.integers(0, 5000, size=512, dtype=np.uint32)
    batch = rng.integers(0, 5000, size=256, dtype=np.uint32)
    states, reads = {}, {}
    for where in (card, "cpu"):
        t = DistributedHashTable(num_shards=d, hash_range=1 << 12, device=where)
        probe = DistributedHashTable(num_shards=d, hash_range=1 << 12, device=where,
                                     paper_faithful_probe=True)
        s = t.init(keys)
        s = s.insert(batch)
        s = s.delete(keys[:40]).insert(keys[:16])
        s = s.upsert(keys[40:50], np.arange(10, dtype=np.int32))
        out = []
        for st in (s, maintenance.fold_oldest(s, 2), s.compact()):
            out.append(t.query(st, queries).cpu())
            out.append(probe.query(st, queries).cpu())
            r = t.retrieve(st, queries)
            out += [r.offsets.cpu(), r.values.cpu(), r.counts.cpu()]
        states[str(where)], reads[str(where)] = convert.state_to_numpy(s), out
    for a, b in zip(reads["cuda"], reads["cpu"]):
        assert torch.equal(a, b)
    for name in ("offsets", "keys", "values", "hash_splits"):
        np.testing.assert_array_equal(states["cuda"]["base"][name], states["cpu"]["base"][name])


# ---------------------------------------------------------------------------
# Key lanes and value columns: kernel 1 at 2 lanes with both outputs,
# kernels 3-4 with C value columns, kernel 5 at 2 lanes, a u64x4 table.
# ---------------------------------------------------------------------------


def _u64_lanes(rng, n, empty_every=0):
    """(n, 2) int32 lanes of random uint64 keys, every ``empty_every``-th row
    EMPTY (all ones), one row with only its low lane all ones."""
    k = rng.integers(0, 2**64 - 1, size=n, dtype=np.uint64)
    if empty_every:
        k[::empty_every] = np.uint64(2**64 - 1)
    if n > 3:
        k[3] = np.uint64(0x1234_FFFF_FFFF)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    return torch.from_numpy(np.stack([lo, hi], -1).view(np.int32))


@pytest.mark.parametrize("n", [1, 5, 1001, 4099, 1 << 20])
def test_murmur_hash_kernel_takes_lanes_and_the_fingerprint(card, n):
    """Kernel 1's two-output entry at 2 lanes (and at 1 lane with the
    fingerprint) equals its twin in every output mode, EMPTY keys and a
    tail of n % 2 keys included, and on a misaligned view."""
    keys = _u64_lanes(np.random.default_rng(n), n, empty_every=7)
    for lanes, k in ((2, keys), (1, keys[:, 0].contiguous())):
        for bk, fp in ((True, True), (True, False), (False, True)):
            if lanes == 1 and not fp:
                continue
            want = murmur.murmur_hash_plain(k, 1 << 27, DEFAULT_SEED, lanes=lanes,
                                            fingerprint=fp, buckets=bk)
            before = build.LAUNCHES["murmur_hash"]
            got = murmur.murmur_hash(k.to(card), 1 << 27, DEFAULT_SEED, lanes=lanes,
                                     fingerprint=fp, buckets=bk)
            torch.cuda.synchronize()
            assert build.LAUNCHES["murmur_hash"] == before + 1
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    assert torch.equal(g.cpu(), w)
    if n > 2:  # a view starting 8 bytes into its storage
        view = keys.to(card)[1:]
        got = murmur.murmur_hash(view, 1000003, FINGERPRINT_SEED, lanes=2, fingerprint=True)
        want = murmur.murmur_hash_plain(keys[1:], 1000003, FINGERPRINT_SEED, lanes=2,
                                        fingerprint=True)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


COLS = [1, 2, 4, 5]


@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("case", ["small", "deep-d4", "total above capacity", "depth 70"])
def test_owner_entry_takes_value_columns(card, case, cols):
    nl, d, r, widths, cap, zero_frac, max_count, _ = OWNER_CARD_CASES[case]
    rng = np.random.default_rng(len(case) + cols)
    tables = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(d, w, cols),
                                            dtype=np.int32)) for w in widths]
    if cols == 1:
        tables = [t[..., 0].contiguous() for t in tables]
    runs = [_gather_runs(rng, (d, d, r), w, zero_frac, max_count) for w in widths]
    starts = torch.from_numpy(np.stack([s for s, _ in runs]))
    counts = torch.from_numpy(np.stack([c for _, c in runs]))
    card_args = [starts.to(card), counts.to(card), [t.to(card) for t in tables]]
    got = csr_gather.csr_gather_owners(*card_args, cap)
    want = csr_gather.csr_gather_owners_plain(starts, counts, tables, cap)
    assert got[0].shape == (d, d, cap) + (() if cols == 1 else (cols,))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if cols == 4:  # each layer a strided view: 4 of 5 columns, rows not 16-byte aligned
        wide = [torch.cat([t, t[..., :1]], -1).to(card) for t in tables]
        got = csr_gather.csr_gather_owners(starts.to(card), counts.to(card),
                                           [t[..., 1:] for t in wide], cap)
        want = csr_gather.csr_gather_owners_plain(
            starts, counts, [t[..., 1:].cpu() for t in wide], cap)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("case", ["small", "d4", "total above capacity", "2^16-long run"])
def test_querier_and_pallas_entries_take_value_columns(card, case, cols):
    d, n, width, cap, zero_frac, max_count, long_run = QUERIER_CARD_CASES[case]
    rng = np.random.default_rng(len(case) + 10 * cols)
    table = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(d, width, cols),
                                          dtype=np.int32))
    if cols == 1:
        table = table[..., 0].contiguous()
    starts, counts = (torch.from_numpy(a) for a in _gather_runs(rng, (d, n), width, zero_frac,
                                                              max_count))
    if long_run is not None:
        starts[0, n // 3], counts[0, n // 3] = 0, long_run
    got = csr_gather.csr_gather_queriers(starts.to(card), counts.to(card), table.to(card), cap)
    want = csr_gather.csr_gather_queriers_plain(starts, counts, table, cap)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    # The Pallas-interface entries on querier 0's CSR and on every querier's
    # runs over querier 0's table: one row search, the columns reused.
    for fn, args in ((ops.csr_gather, (starts[0], counts[0])),
                     (ops.csr_gather_batched, (starts, counts))):
        want = fn(*args, table[0], capacity=cap)
        got = fn(*(a.to(card) for a in args), table[0].to(card), capacity=cap)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def _lane_layer_case(seed, d, n, table_size):
    """``_layer_case`` with 2-lane keys: lane 0 from 4 values and lane 1
    from 2, so windows hold keys equal in one lane only; EMPTY pads and a
    key with only its low lane all ones."""
    a = _layer_case(seed, d, n, table_size)
    rng = np.random.default_rng(seed + 1)
    m = a["keys"].shape[1]
    hi_k = rng.integers(0, 2, size=(d, m), dtype=np.int32)
    hi_q = rng.integers(0, 2, size=(d, n), dtype=np.int32)
    rq = torch.stack([a["rq"], torch.from_numpy(hi_q)], -1)
    rq[a["rq"] == -1] = -1
    if n > 3:
        rq[:, 3, 0] = -1  # only the low lane all ones: a key, not padding
    a["rq"] = rq.contiguous()
    a["keys"] = torch.stack([a["keys"], torch.from_numpy(hi_k)], -1).contiguous()
    return a


@pytest.mark.parametrize("case", LAYER_CASES[:6] + LAYER_CASES[7:])
def test_bucket_probe_kernels_take_two_lanes(card, case):
    d, n, table_size, stride, max_probe, masked, accumulate = case
    a = _lane_layer_case(LAYER_CASES.index(case), d, n, table_size)
    match_e = a["match_e"] if masked else None
    kw = dict(table_size=table_size, stride=stride, epoch=1, max_probe=max_probe,
              accumulate=accumulate)
    want = bucket_probe.bucket_probe_layer(
        a["rq"], a["rh"], a["lo"], match_e, a["offsets"], a["keys"], total=a["prev"].clone(), **kw)
    on = {k: v.to(card) for k, v in a.items()}
    total = on["prev"].clone() if accumulate else torch.full_like(on["prev"], -7)
    got = bucket_probe.bucket_probe_layer(
        on["rq"], on["rh"], on["lo"], on["match_e"] if masked else None, on["offsets"],
        on["keys"], total=total, **kw)
    assert torch.equal(got.cpu(), want)
    if n >= 4096 and max_probe:
        assert int(want.max()) > 1
    # The window entry on the windows the plain steps find for this batch.
    b = mh._rebase_buckets(a["rh"], (a["rq"] == -1).all(-1), a["lo"].reshape(-1, 1),
                           table_size, stride)
    from repro_torch.core import hashgraph

    st, en = hashgraph.bucket_windows(a["offsets"], table_size, b)
    st, en = st.to(torch.int32), en.to(torch.int32)
    want = bucket_probe.bucket_probe(st, en, a["rq"], a["keys"], max_probe)
    got = bucket_probe.bucket_probe(st.to(card), en.to(card), on["rq"], on["keys"], max_probe)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("probe", [False, True], ids=["sorted", "probe"])
def test_u64x4_table_on_card_matches_cpu(card, probe):
    """A u64x4 table at D = 8 (fingerprint lane on) through build, inserts, a
    delete, an upsert with TTL, fold and compact equals the CPU path in its
    arrays, queries, retrieves and joins; the card runs kernel 1's
    two-output entry, kernels 3-4 with 4 columns and (probe) kernel 5 at 2
    lanes."""
    from repro_torch.core.schema import TableSchema

    rng = np.random.default_rng(64)
    pool = rng.integers(0, 2**63, size=3000, dtype=np.uint64)
    keys = rng.choice(pool, 4096)
    vals = rng.integers(-2**31, 2**31, size=(4096, 4), dtype=np.int64).astype(np.int32)
    queries = np.concatenate([rng.choice(pool, 960), rng.integers(0, 2**63, 64, dtype=np.uint64)])
    batches = [rng.choice(pool, 256) for _ in range(3)]
    out, states = {}, {}
    for where in (card, "cpu"):
        t = DistributedHashTable(num_shards=8, hash_range=1 << 12, device=where,
                                 schema=TableSchema("uint64", 4), paper_faithful_probe=probe)
        before = dict(build.LAUNCHES)
        s = t.init(keys, vals)
        for i in range(3):
            s = s.insert(batches[i], vals[256 * i: 256 * (i + 1)])
            s = s.delete(pool[40 * i: 40 * i + 24])
        s = s.upsert(pool[200:216], vals[:16], ttl=2)
        res = []
        for st in (s, maintenance.fold_oldest(s, 2), s.advance(2).compact()):
            r, j = t.retrieve(st, queries), t.inner_join(st, queries)
            res += [t.query(st, queries).cpu(), r.offsets.cpu(), r.values.cpu(),
                    r.counts.cpu(), torch.from_numpy(join_to_pairs(j))]
        if where == card:
            torch.cuda.synchronize()
            got = {k: build.LAUNCHES[k] - before.get(k, 0) for k in (
                "murmur_hash", "csr_gather_owners", "csr_gather_queriers", "bucket_probe_layer")}
            assert got["murmur_hash"] > 0 and got["csr_gather_owners"] == 6
            assert got["csr_gather_queriers"] == 6
            assert got["bucket_probe_layer"] == (5 + 3 + 1 if probe else 0)
        out[str(where)], states[str(where)] = res, convert.state_to_numpy(s)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    for name in ("offsets", "keys", "values", "fingerprints", "hash_splits"):
        np.testing.assert_array_equal(states["cuda"]["base"][name], states["cpu"]["base"][name])
    assert int(out["cpu"][3].sum()) > 0


# (hq, hkv, sq, skv, d, causal, window): the JAX kernel tests' ATTN_CASES
# (batch folded into heads), then decode offsets, windows, the edges of the
# bf16 kernel's 128-row tiles (Sq and Skv one above and one below a
# multiple of 128, Skv < 128, Sq = 1) at each head dim, and a full-width
# qwen3-4b prefill (32 query heads over 8 kv heads, D = 128, ragged).
FLASH_CASES = [
    (2, 2, 128, 128, 64, True, None),
    (8, 4, 128, 128, 64, True, None),
    (4, 1, 256, 256, 32, True, None),
    (2, 2, 128, 128, 64, False, None),
    (2, 2, 256, 256, 32, True, 64),
    (2, 1, 1, 384, 64, True, None),
    (2, 2, 100, 100, 64, True, None),
    (4, 2, 70, 300, 128, True, None),   # decode offset with several query rows
    (4, 2, 70, 300, 128, True, 40),     # ... and a window
    (2, 2, 130, 190, 32, False, 17),    # non-causal window, ragged both ways
    (2, 1, 33, 33, 64, True, 0),        # window 0: every row masked, all zeros
    (4, 2, 127, 127, 128, True, None),  # one below a tile
    (4, 2, 129, 129, 128, True, None),  # one above a tile
    (4, 1, 255, 257, 64, True, None),   # ... both, Sq < Skv
    (2, 2, 257, 255, 32, True, None),   # Sq > Skv: leading rows see no key
    (2, 1, 129, 127, 64, False, None),  # Skv < 128, non-causal
    (4, 2, 1, 129, 128, True, None),    # Sq = 1 (a decode-shaped call)
    (2, 2, 1, 127, 32, True, None),
    (32, 8, 1000, 1000, 128, True, None),
]


def _flash_inputs(case, dtype, layout, device):
    """q, k, v of ``case``: contiguous, or strided views as a model hands
    them over (the heads of one (S, H, D) projection buffer, permuted)."""
    hq, hkv, sq, skv, d = case[:5]
    gen = torch.Generator(device=device).manual_seed(FLASH_CASES.index(case))
    if layout == "contiguous":
        return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                     for shape in ((hq, sq, d), (hkv, skv, d), (hkv, skv, d)))
    q = torch.randn((sq, hq, d), generator=gen, device=device).to(dtype).transpose(0, 1)
    kv = torch.randn((skv, 2 * hkv, d), generator=gen, device=device).to(dtype).transpose(0, 1)
    return q, kv[:hkv], kv[hkv:]


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(card, case, dtype, layout):
    hq, hkv, sq, skv, d, causal, window = case
    q, k, v = _flash_inputs(case, dtype, layout, card)
    assert q.is_contiguous() == (layout == "contiguous" or sq == 1)
    want = flash.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       q_heads_per_kv=hq // hkv)
    before = build.LAUNCHES["flash_attention"]
    got = flash.flash_attention_fhsd(q, k, v, causal=causal, window=window,
                                     q_heads_per_kv=hq // hkv)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_kernel_reads_projection_views_and_writes_the_output_buffer(card, d, dtype):
    """B = 2, GQA 4:1: q, k, v as views of one fused (B, S, heads, D)
    projection, o written into a (B, S, Hq, D) buffer, one launch."""
    b, hq, hkv, s = 2, 8, 2, 300
    gen = torch.Generator(device=card).manual_seed(d)
    qkv = torch.randn((b, s, hq + 2 * hkv, d), generator=gen, device=card).to(dtype)
    q, k, v = (qkv[:, :, lo:hi].permute(0, 2, 1, 3)
               for lo, hi in ((0, hq), (hq, hq + hkv), (hq + hkv, hq + 2 * hkv)))
    buf = torch.full((b, s, hq, d), float("nan"), device=card, dtype=dtype)
    before = build.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, window=None, out=buf.permute(0, 2, 1, 3))
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == before + 1
    assert got.data_ptr() == buf.data_ptr()
    want = flash.flash_attention_plain(q, k, v, q_heads_per_kv=hq // hkv)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(buf.permute(0, 2, 1, 3).float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros((2, 8, 48), device=card)
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_attention_fhsd(q, q, q)
    wide = torch.zeros((2, 8, 128), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous last dim"):
        flash.flash_attention_fhsd(wide[..., ::2], wide[..., ::2], wide[..., ::2])
    rows = torch.zeros((2, 8, 68), device=card, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash.flash_attention_fhsd(rows, rows, rows)
    shifted = torch.zeros(2 * 8 * 64 + 4, device=card, dtype=torch.bfloat16)[4:].view(2, 8, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash.flash_attention_fhsd(shifted, shifted, shifted)
    before = build.LAUNCHES["flash_attention"]
    ok = torch.zeros((8, 2, 64), device=card, dtype=torch.bfloat16).transpose(0, 1)
    flash.flash_attention_fhsd(ok, ok, ok)  # a strided view is taken
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_model_on_card_matches_cpu(card, dtype):
    """Prefill (kernel 6 on the card, its twin on the CPU), 6 decode steps
    and the batcher's token streams, card against CPU, on weights drawn once
    on the CPU.  Logit tolerance: 2e-4 in f32 (the CPU tests' bound for
    another summation order), 6e-2 in bf16 (the JAX-parity bound of the CPU
    tests: bf16 products rounded after other partial sums)."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_4b"), dtype=dtype)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device=card)
    params_cpu = cpu.init(3)
    params_gpu = copy.deepcopy(params_cpu).to(card)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, cfg.vocab_size, size=(1, 75), dtype=np.int32)
    tol = 2e-4 if dtype == "float32" else 6e-2
    before = build.LAUNCHES["flash_attention"]
    (lc, cc), (lg, cg) = (b.prefill(p, {"tokens": tokens[:, :69]}, cache_len=80)
                          for b, p in ((cpu, params_cpu), (gpu, params_gpu)))
    assert build.LAUNCHES["flash_attention"] == before + cfg.num_layers
    torch.testing.assert_close(lg.float().cpu(), lc.float(), atol=tol, rtol=tol)
    for t in range(69, 75):
        tok, pos = tokens[:, t:t + 1], np.array([t], np.int32)
        lc, cc = cpu.decode_step(params_cpu, cc, tok, pos)
        lg, cg = gpu.decode_step(params_gpu, cg, tok, pos)
        torch.testing.assert_close(lg.float().cpu(), lc.float(), atol=tol, rtol=tol)
    if dtype == "float32":
        streams = {}
        for name, bundle, params in (("cpu", cpu, params_cpu), ("card", gpu, params_gpu)):
            batcher = ContinuousBatcher(
                params, bundle.init_cache(3, 64), make_prefill_step(bundle, cache_len=64),
                make_serve_step(bundle), num_slots=3,
            )
            prompts = np.random.default_rng(2)
            for uid in range(7):
                batcher.submit(Request(uid=uid, max_new_tokens=5, prompt=prompts.integers(
                    1, cfg.vocab_size, size=8 + uid, dtype=np.int32)))
            done = batcher.run_until_drained(max_steps=200)
            streams[name] = {r.uid: r.out_tokens for r in done}
        assert streams["card"] == streams["cpu"]


# Kernel 7 (b, h, s, hd): the JAX kernel tests' shapes, a head dim of 48
# (3 blocks per head), the full-width decode shape (4 slots, S = 1, hd = 512),
# a full-width prefill and 64 (b, h) groups, more than one cooperative
# launch holds at once (batch slices); then, for the cluster kernel (bf16
# r), head dims that are not multiples of 16 (20, 36), one head dim for
# every cluster size its plan picks (68: 2 blocks, 132: 3, 196: 4, 260-484:
# 9-16, uneven splits among them) and 3 rows in a slice of 4.
SLSTM_CASES = [
    (1, 1, 8, 16, 2e-5), (2, 2, 32, 32, 2e-5), (1, 4, 100, 64, 2e-5), (2, 1, 256, 128, 2e-5),
    (3, 2, 37, 48, 2e-5), (4, 4, 1, 512, 2e-5), (1, 4, 300, 512, 1e-4), (16, 4, 20, 512, 1e-4),
    (1, 2, 12, 20, 2e-5), (2, 1, 12, 36, 2e-5), (1, 1, 12, 68, 2e-5), (1, 1, 12, 132, 2e-5),
    (2, 1, 12, 196, 2e-5), (1, 1, 12, 260, 2e-5), (1, 1, 12, 292, 2e-5), (1, 1, 12, 324, 2e-5),
    (1, 1, 12, 356, 2e-5), (1, 1, 12, 388, 2e-5), (1, 1, 12, 420, 2e-5), (1, 1, 12, 452, 2e-5),
    (1, 1, 12, 484, 2e-5), (3, 4, 9, 512, 2e-5),
]


def test_slstm_cases_cover_every_cluster_size():
    """Plain Python (no card): SLSTM_CASES reach every cluster size the
    bf16 plan picks for head dims up to 512."""
    sizes = {slstm.launch_plan(hd, torch.bfloat16, 1)["cluster"] for hd in range(4, 513, 4)}
    covered = {slstm.launch_plan(c[3], torch.bfloat16, c[0])["cluster"] for c in SLSTM_CASES}
    assert covered == sizes


def _slstm_inputs(b, h, s, hd, device, seed, r_dtype=torch.float32, warm=0):
    """pre, r and the initial states; with ``warm`` > 0 the states are those
    the twin reaches after ``warm`` steps of other inputs (non-zero)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pre = 0.5 * torch.randn((b, h, s, 4, hd), generator=gen, device=device)
    r = (torch.randn((h, 4, hd, hd), generator=gen, device=device) / hd ** 0.5).to(r_dtype)
    z = torch.zeros((b, h, hd), device=device)
    states = (z, z.clone(), z.clone(), torch.full_like(z, -1e30))
    if warm:
        prefix = 0.5 * torch.randn((b, h, warm, 4, hd), generator=gen, device=device)
        _, states = slstm.slstm_sequence_plain(prefix, r, *states)
    return pre, r, states


@pytest.mark.parametrize("case", SLSTM_CASES)
@pytest.mark.parametrize("r_dtype", [torch.float32, torch.bfloat16])
def test_slstm_kernel_matches_plain(card, case, r_dtype):
    b, h, s, hd, tol = case
    for warm in (0, 5):
        pre, r, states = _slstm_inputs(b, h, s, hd, card, SLSTM_CASES.index(case), r_dtype, warm)
        want_hs, want_fin = slstm.slstm_sequence_plain(pre, r, *states)
        before = build.LAUNCHES["slstm_sequence"]
        got_hs, got_fin = slstm.slstm_sequence(pre, r, *states)
        torch.cuda.synchronize()
        assert build.LAUNCHES["slstm_sequence"] == before + 1
        assert got_hs.shape == (b, h, s, hd)
        for got, want in zip((got_hs, *got_fin), (want_hs, *want_fin)):
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def test_slstm_kernel_reads_the_block_layout_and_refuses_what_it_does_not_take(card):
    """A strided (B, H, S, 4, hd) view of the block's (B, S, 4, H, hd)
    projection gives what its contiguous copy gives; hd % 4 != 0 and a
    strided last axis raise."""
    b, s, h, hd = 2, 40, 4, 32
    gen = torch.Generator(device=card).manual_seed(11)
    flat = 0.5 * torch.randn((b, s, 4 * h * hd), generator=gen, device=card)
    view = flat.view(b, s, 4, h, hd).permute(0, 3, 1, 2, 4)
    r = torch.randn((h, 4, hd, hd), generator=gen, device=card) / hd ** 0.5
    z = torch.zeros((b, h, hd), device=card)
    states = (z, z, z, torch.full_like(z, -1e30))
    got = slstm.slstm_sequence(view, r, *states)
    want = slstm.slstm_sequence(view.contiguous(), r, *states)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    z6 = torch.zeros((1, 1, 6), device=card)
    with pytest.raises(ValueError, match="multiples of 4"):
        slstm.slstm_sequence(torch.zeros((1, 1, 3, 4, 6), device=card),
                             torch.zeros((1, 4, 6, 6), device=card), z6, z6, z6, z6)
    with pytest.raises(ValueError, match="contiguous"):
        slstm.slstm_sequence(view.transpose(3, 4).contiguous().transpose(3, 4), r, *states)


@pytest.mark.parametrize("hd", [20, 48, 512])
def test_slstm_variant_follows_r_dtype(card, hd):
    """The C entry point's own plan (``slstm_plan``): f32 r takes the
    cooperative kernel, bf16 r the cluster kernel, as the Python plan says,
    and the card holds at least one such cluster."""
    for r_dtype, variant in ((torch.float32, "cooperative"), (torch.bfloat16, "cluster")):
        for batch in (1, 4, 16):
            got = slstm.card_plan(hd, r_dtype, batch, 4)
            want = slstm.launch_plan(hd, r_dtype, batch)
            assert got["variant"] == variant and got["resident"] >= 1
            for key in slstm.PLAN_KEYS:
                if not (key == "slices" and variant == "cooperative"):
                    assert got[key] == want[key], (key, got, want)


@pytest.mark.parametrize("shape", [(1, 4, 2675, 512), (4, 4, 1, 512)])
def test_slstm_bf16_call_is_one_launch_and_no_memset(card, shape):
    """At the main (prefill) and decode shapes a bf16 call puts exactly one
    kernel on the card, the cluster kernel, and no memset or copy."""
    from torch.profiler import ProfilerActivity, profile

    pre, r, states = _slstm_inputs(*shape, card, 3, torch.bfloat16)
    slstm.slstm_sequence(pre, r, *states)  # build, load and configure first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        slstm.slstm_sequence(pre, r, *states)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "slstm_cluster" in names[0], names


def test_slstm_cluster_kernel_refuses_wide_heads(card):
    """bf16 r takes head dims up to 512 (a cluster of 16 holds r[h] in
    registers); f32 r still takes them."""
    hd = 516
    z = torch.zeros((1, 1, hd), device=card)
    pre = torch.zeros((1, 1, 2, 4, hd), device=card)
    r = torch.zeros((1, 4, hd, hd), device=card)
    with pytest.raises(ValueError, match="up to 512"):
        slstm.slstm_sequence(pre, r.bfloat16(), z, z, z, z)
    slstm.slstm_sequence(pre, r, z, z, z, z)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_xlstm_on_card_matches_cpu(card, dtype):
    """The smoke xLSTM: prefill (kernel 7 in each sLSTM layer on the card,
    its twin on the CPU), 6 decode steps and, in f32, the batcher's token
    streams, card against CPU, on weights drawn once on the CPU.  Logit
    tolerance: 2e-4 in f32, 6e-2 in bf16, as for the qwen3 smoke model."""
    cfg = dataclasses.replace(get_smoke_config("xlstm_1_3b"), dtype=dtype)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device=card)
    params_cpu = cpu.init(3)
    params_gpu = copy.deepcopy(params_cpu).to(card)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, cfg.vocab_size, size=(1, 75), dtype=np.int32)
    tol = 2e-4 if dtype == "float32" else 6e-2
    n_slstm = cfg.num_periods
    before = build.LAUNCHES["slstm_sequence"]
    (lc, cc), (lg, cg) = (b.prefill(p, {"tokens": tokens[:, :69]})
                          for b, p in ((cpu, params_cpu), (gpu, params_gpu)))
    assert build.LAUNCHES["slstm_sequence"] == before + n_slstm
    torch.testing.assert_close(lg.float().cpu(), lc.float(), atol=tol, rtol=tol)
    for t in range(69, 75):
        tok, pos = tokens[:, t:t + 1], np.array([t], np.int32)
        lc, cc = cpu.decode_step(params_cpu, cc, tok, pos)
        lg, cg = gpu.decode_step(params_gpu, cg, tok, pos)
        torch.testing.assert_close(lg.float().cpu(), lc.float(), atol=tol, rtol=tol)
    assert build.LAUNCHES["slstm_sequence"] == before + 7 * n_slstm
    if dtype == "float32":
        streams = {}
        for name, bundle, params in (("cpu", cpu, params_cpu), ("card", gpu, params_gpu)):
            batcher = ContinuousBatcher(
                params, bundle.init_cache(3, 64), make_prefill_step(bundle, cache_len=64),
                make_serve_step(bundle), num_slots=3,
            )
            prompts = np.random.default_rng(2)
            for uid in range(7):
                batcher.submit(Request(uid=uid, max_new_tokens=5, prompt=prompts.integers(
                    1, cfg.vocab_size, size=8 + uid, dtype=np.int32)))
            done = batcher.run_until_drained(max_steps=200)
            streams[name] = {r.uid: r.out_tokens for r in done}
        assert streams["card"] == streams["cpu"]


# ---------------------------------------------------------------------------
# The table server on the card: reads never wait for a fold
# ---------------------------------------------------------------------------

FOLD_SPIN_CYCLES = 2_000_000_000  # about a second of one spinning thread


def _server_with_deltas(card, shards, depth=None, **warm):
    """A server at depth 2, warmed (which also gives the writer's and the
    fold stream's memory pools blocks of a delta's and a fold's sizes)."""
    from repro_torch.serve_table import CompactionPolicy, MicroBatcher, TableServer

    table = DistributedHashTable(num_shards=shards, hash_range=1 << 18, device=card, max_deltas=4)
    keys = np.arange(1 << 16, dtype=np.uint32)
    server = TableServer(table, keys, policy=CompactionPolicy(max_delta_depth=depth, fold_k=2),
                         batcher=MicroBatcher(table, min_bucket=64), write_bucket=64 * shards)
    for i in range(2):
        server.submit_insert(np.arange(1 << 20, (1 << 20) + 64 * shards, dtype=np.uint32) + i)
    server.drain()
    server.warm(**{"buckets": (64,), "depths": range(5), "fold_horizon": 1, **warm})
    return server, keys


def _spin_fold_stream(server):
    """Queue a long kernel on the fold stream: the fold's own kernels (and
    its hand-over) wait behind it, so the fold stays in flight."""
    with torch.cuda.stream(server._fold_stream):
        torch.cuda._sleep(FOLD_SPIN_CYCLES)


@pytest.mark.parametrize("shards", [1, 8])
def test_read_during_fold_does_not_wait_for_the_fold_stream(card, shards):
    import time

    server, keys = _server_with_deltas(card, shards)
    q = keys[: 64 * shards]
    server.query_many([q])  # first call: library and allocator warm
    pre = server.current().seqno
    _spin_fold_stream(server)
    t0 = time.perf_counter()
    fold = server.fold_async(k=1)
    counts, seqno = server.query_many([q])
    read_s = time.perf_counter() - t0
    assert server.fold_in_flight, "the fold ended before the read: spin longer"
    assert read_s < 0.3, f"the read took {read_s:.3f} s: it waited for the fold"
    assert counts[0].tolist() == [1] * q.shape[0] and seqno == pre
    rec = server.batcher.timeline[-1]
    assert rec.end.query() and rec.rounds == 2 == rec.budget
    fold.join()
    assert server.current().seqno == pre + 1 and server.stats().folds == 1
    assert server.fold_log[-1].rounds == 0
    assert server.query_many([q])[0][0].tolist() == [1] * q.shape[0]


def test_pending_batch_wait_returns_before_the_fold_ends(card):
    server, keys = _server_with_deltas(card, 8)
    q = keys[:512]
    server.query_many([q])
    _spin_fold_stream(server)
    fold = server.fold_async(k=1)
    snap = server.current()
    pending = server.batcher.dispatch_query(snap.state, [q], seqno=snap.seqno, ready=snap.ready)
    pending.wait()
    assert server.fold_in_flight, "PendingBatch.wait() waited for the fold"
    assert pending.scatter()[0].tolist() == [1] * 512
    fold.join()


def test_no_library_build_or_load_after_warm(card):
    """Warmed at depths 0-4 and one policy fold ahead: reads (query and
    per-layer retrieve), three inserts and the policy fold they trigger
    load nothing and miss nothing."""
    server, keys = _server_with_deltas(card, 8, depth=4, buckets=(64, 128),
                                       retrieve_caps={64: (512, 256), 128: (512, 256)},
                                       per_layer_counts=(False, True))
    events = dict(build.LIBRARY_EVENTS)
    server.query_many([keys[:100]])
    server.retrieve_many([keys[:50]], per_layer_counts=True)
    for i in range(3):  # depth 2 -> 4, then the policy folds 2 before the third
        server.submit_insert(np.arange(1 << 21, (1 << 21) + 512, dtype=np.uint32) + 1024 * i)
        server.drain()
        counts, _ = server.query_many([keys[:100]])
        assert counts[0].tolist() == [1] * 100
    assert server.stats().folds == 1
    vals, _ = server.retrieve_many([keys[:50]], per_layer_counts=True)
    assert [v.shape[0] for v in vals[0][0]] == [1] * 50
    assert dict(build.LIBRARY_EVENTS) == events
    assert server.stats().warmup.aot_misses == 0


# ---------------------------------------------------------------------------
# The table's users: the single-card API, hot-key replica rounds, dedup.
# ---------------------------------------------------------------------------
def _hot_pair(card, copies: int):
    """A D = 8 table with ``replicate_hot_keys = 4`` on the card and its CPU
    twin, after one insert holding ``copies`` rows of one key (replicated:
    about ``copies / 4`` rows of it a shard) among 2^14 others."""
    rng = np.random.default_rng(11)
    base = u32_bits(rng.integers(0, 1 << 16, size=1 << 14, dtype=np.uint32))
    batch = rng.integers(0, 1 << 16, size=1 << 14, dtype=np.uint32)
    batch = rng.permutation(np.concatenate([batch, np.full(copies, 777, np.uint32)]))
    batch = u32_bits(batch)
    batch = batch[: (batch.shape[0] // 8) * 8]
    vals = torch.arange(batch.shape[0], dtype=torch.int32)
    out = []
    for dev in (card, torch.device("cpu")):
        t = DistributedHashTable(num_shards=8, hash_range=1 << 16, device=dev,
                                 capacity_slack=2.0, replicate_hot_keys=4)
        s = t.insert(t.init(base.to(dev)), batch.to(dev), vals.to(dev))
        assert t.hot_keys == {(777,): 4} and int(s.num_dropped) == 0 and t.skew_fallbacks == 0
        out.append((t, s))
    return out


def test_probe_layer_on_a_replica_round_matches_plain(card):
    (tc, sc), (tp, sp) = _hot_pair(card, 40_000)
    q = torch.cat([torch.tensor([777], dtype=torch.int32), sp.deltas[0].local.keys[0, :1023]])
    for probe in (False, True):
        tc.paper_faithful_probe = tp.paper_faithful_probe = probe
        assert torch.equal(tc.query(sc, q.to(card)).cpu(), tp.query(sp, q))
    # Replica round 1: every query lands off its owner, in a clamped edge
    # bucket of the delta, where the hot key's replica rows sit.
    routed = mh._route_queries_once(sc.base, q.to(card).reshape(8, -1), tc.capacity_slack, False, 1)
    layer = sc.deltas[0]
    args = (routed.rq, routed.rh, routed.lo, None, layer.local.offsets, layer.local.keys)
    kw = dict(table_size=layer.local_range_cap, stride=layer.bucket_stride, epoch=1,
              max_probe=64, accumulate=False)
    total = torch.empty(routed.rq.shape, dtype=torch.int32, device=card)
    got = bucket_probe.bucket_probe_layer(*args, total=total, **kw)
    want = bucket_probe.bucket_probe_layer_plain(*args, total=torch.empty_like(total), **kw)
    assert torch.equal(got, want) and int(got.sum()) > 0


def test_gather_kernels_on_a_bucket_of_one_key(card):
    (tc, sc), (tp, sp) = _hot_pair(card, 40_000)
    q = torch.tensor([777] + list(range(1, 8)), dtype=torch.int32)
    got, want = tc.retrieve(sc, q.to(card)), tp.retrieve(sp, q)
    for name in ("offsets", "values", "counts"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    assert int(got.counts[0]) >= 9_000  # replica 0 of the hot key: about 10^4 copies
    routed = mh._route_queries_once(sc.base, q.to(card).reshape(8, -1), tc.capacity_slack)
    starts, counts, tables = mh._layer_run_descriptors(sc.layers, routed)
    nl, cap = len(sc.layers), routed.capacity
    starts4, counts4 = starts.reshape(nl, 8, 8, cap), counts.reshape(nl, 8, 8, cap)
    seg = 1 << 14
    g = csr_gather.csr_gather_owners(starts4, counts4, tables, seg)
    w = csr_gather.csr_gather_owners_plain(starts4, counts4, tables, seg)
    for a, b in zip(g, w):
        assert torch.equal(a, b)
    back_counts, back_starts, seg_flat = exchange.combine_ragged(g[0], g[2], routed.route)
    g = csr_gather.csr_gather_queriers(back_starts, back_counts, seg_flat, seg)
    w = csr_gather.csr_gather_queriers_plain(back_starts, back_counts, seg_flat, seg)
    for a, b in zip(g, w):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lanes", [1, 2])
def test_single_card_graph_on_card_matches_cpu(card, lanes):
    from repro_torch.core import hashgraph

    rng = np.random.default_rng(lanes)
    pool = rng.integers(0, 2**32 - 1, size=(5000, lanes), dtype=np.uint64).astype(np.uint32)
    keys = pool[rng.integers(0, 5000, 1 << 16)]
    keys[:12_000] = pool[0]  # about 10^4 copies of one key in one bucket
    keys = torch.from_numpy(keys.view(np.int32))
    queries = torch.from_numpy(pool.view(np.int32))
    if lanes == 1:
        keys, queries = keys[:, 0].contiguous(), queries[:, 0].contiguous()
    cpu = hashgraph.build(keys, 1 << 12, seed=5)
    dev = hashgraph.build(keys.to(card), 1 << 12, seed=5)
    for name in ("offsets", "keys", "values", "fingerprints"):
        a, b = getattr(dev, name), getattr(cpu, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a.cpu(), b))
    qd = queries.to(card)
    for fn in (hashgraph.query_count_sorted, hashgraph.lookup_first, hashgraph.contains):
        assert torch.equal(fn(dev, qd).cpu(), fn(cpu, queries))
    cap = int(hashgraph.query_count_sorted(cpu, queries).sum())
    before = build.LAUNCHES["csr_gather"]
    for fn in (hashgraph.retrieve, hashgraph.inner_join):
        for a, b in zip(fn(dev, qd, capacity=cap), fn(cpu, queries, capacity=cap)):
            assert torch.equal(a.cpu(), b)
    assert build.LAUNCHES["csr_gather"] == before + 2
    assert int(hashgraph.intersect_join_size(dev, dev)) == int(hashgraph.intersect_join_size(cpu, cpu))


def test_distributed_dedup_on_card_matches_cpu(card):
    from repro_torch.data import dedup_mask, dedup_mask_distributed

    rng = np.random.default_rng(4)
    toks = rng.integers(0, 151_936, size=(1 << 14, 128), dtype=np.int32)
    toks[rng.choice(1 << 14, 3000)] = toks[rng.integers(0, 1 << 14, 3000)]
    toks[:100] = toks[100]  # past the 64-row run window
    t = torch.from_numpy(toks)
    for shards in (1, 8):
        tables = [DistributedHashTable(num_shards=shards, hash_range=1 << 14, device=dev)
                  for dev in (card, "cpu")]
        assert torch.equal(dedup_mask_distributed(tables[0], t.to(card)).cpu(),
                           dedup_mask_distributed(tables[1], t))
    assert torch.equal(dedup_mask(t.to(card)).cpu(), dedup_mask(t))


# ---------------------------------------------------------------------------
# The table across processes on the card (one card: NCCL at world 1, gloo
# for two ranks on cuda:0)
# ---------------------------------------------------------------------------


def _slice_on_card(group, cfg, shards: int = 1) -> dict:
    """One ``table_run`` pass on cuda:0, stacked (``group=None``) or as
    this rank of ``group``."""
    from repro_torch.launch import table_run

    sink = table_run.Sink()
    dev = torch.device("cuda", 0)
    if group is None:
        steps = table_run.run_slice(cfg, sink, num_shards=shards, device=dev)["steps"]
    else:
        steps = table_run.run_slice(cfg, sink, group=group, device=dev)["steps"]
    return {"blocks": sink.blocks, "scalars": sink.scalars, "steps": steps,
            "rank": group.rank if group is not None else 0}


def _assert_rows(ranks, want):
    for res in ranks:
        r = res["rank"]
        assert set(res["blocks"]) == set(want["blocks"])
        for key, arr in want["blocks"].items():
            np.testing.assert_array_equal(res["blocks"][key][0], arr[r], err_msg=f"rank {r} {key}")
        assert res["scalars"] == want["scalars"], r
        for step, w in want["steps"].items():
            g = res["steps"][step]
            assert (g["rounds"], g["launches"]) == (w["rounds"], w["launches"]), (r, step)


def test_procs_nccl_world1_equals_stacked_on_card(card, tmp_path):
    import torch.distributed as dist

    from repro_torch.launch import mesh, table_run

    cfg = table_run.SliceConfig(n_keys=1 << 16)
    group = mesh.init_shard_group("nccl", "file://" + str(tmp_path / "store"), timeout_s=120,
                                  rank=0, world_size=1, device=torch.device("cuda", 0))
    try:
        got = _slice_on_card(group, cfg)
    finally:
        dist.destroy_process_group()
    want = _slice_on_card(None, cfg, 1)
    _assert_rows([got], want)
    assert want["steps"]["init"]["launches"]["murmur_bucket"] >= 1
    assert want["steps"]["r0.retrieve"]["launches"]["csr_gather_owners"] == 1


def test_procs_gloo_world2_on_one_card_equals_stacked(card, tmp_path):
    from repro_torch.launch import mesh, table_run

    cfg = table_run.SliceConfig(n_keys=1 << 16)
    ranks = mesh.spawn(_slice_on_card, 2, "gloo", "cuda:0", args=(cfg,), timeout_s=120,
                       store_dir=str(tmp_path))
    want = _slice_on_card(None, cfg, 2)
    _assert_rows(ranks, want)
    assert want["scalars"]["skew.fallback"] == 1


# ---------------------------------------------------------------------------
# The table's users across processes on the card: hot keys and the KV cache
# against the stacked run, the server against its oracle and a stacked
# replay of rank 0's log
# ---------------------------------------------------------------------------


def _users_configs():
    from repro_torch.launch import serve_run, users_run

    return (users_run.UsersConfig(n_keys=1 << 14, hot_batch=1 << 12, kv_batch=512, kv_ops=2048,
                                  kv_ttl_keys=1024),
            serve_run.ServeConfig(n_keys=1 << 14, write_bucket=1024, tombstones=4096,
                                  buckets=(256, 512, 1024), requests=32, req_sizes=(4, 64),
                                  retrieves=4, hot_repeats=32, deletes=512, upserts=512))


def _users_on_card(group, shards: int = 1) -> dict:
    """The users' pass and the server pass on cuda:0, stacked
    (``group=None``) or as this rank of ``group``."""
    from repro_torch.launch import serve_run, table_run, users_run

    ucfg, scfg = _users_configs()
    dev = torch.device("cuda", 0)
    kw = {"num_shards": shards} if group is None else {"group": group}
    sink = table_run.Sink()
    steps = users_run.run_users(ucfg, sink, device=dev, **kw)["steps"]
    out = {"blocks": sink.blocks, "scalars": sink.scalars, "steps": steps,
           "rank": group.rank if group is not None else 0}
    if group is not None:
        shadow = table_run.Sink()
        out["serve"] = serve_run.run_server(scfg, shadow, group=group, device=dev)
        out["shadow"] = {"blocks": shadow.blocks, "scalars": shadow.scalars}
    return out


def _assert_users(ranks, card):
    from repro_torch.launch import serve_run, table_run

    _, scfg = _users_configs()
    _assert_rows(ranks, _users_on_card(None, len(ranks)))
    lead = ranks[0]["serve"]
    assert not lead["errors"] and lead["bad"] == 0 and lead["failed"] == 0
    assert lead["responses"] == lead["requests"] and lead["applied_final"] == lead["writes"]
    assert lead["rounds"] == [(2, 2)] and lead["budget_misses"] == 0
    assert lead["num_dropped"] == 0 and lead["aot_misses"] == 0
    replay = table_run.Sink()
    serve_run.replay(scfg, lead["log"], len(ranks), card, replay)
    for res in ranks:
        f = res["serve"]
        for field in ("seqno", "read_batches", "writes_applied", "folds"):
            assert f[field] == lead[field], (res["rank"], field)
        for key, w in replay.blocks.items():
            np.testing.assert_array_equal(res["shadow"]["blocks"][key][0], w[res["rank"]],
                                          err_msg=f"rank {res['rank']} {key}")
        assert res["shadow"]["scalars"] == replay.scalars


def test_procs_users_nccl_world1_on_card(card, tmp_path):
    import torch.distributed as dist

    from repro_torch.launch import mesh

    group = mesh.init_shard_group("nccl", "file://" + str(tmp_path / "store"), timeout_s=120,
                                  rank=0, world_size=1, device=torch.device("cuda", 0))
    try:
        got = _users_on_card(group)
    finally:
        dist.destroy_process_group()
    _assert_users([got], card)
    assert got["steps"]["hot.retrieve"]["launches"]["csr_gather_queriers"] == 1
    assert got["steps"]["hot.probe_query"]["launches"]["bucket_probe_layer"] > 0


def test_procs_users_gloo_world2_on_one_card(card, tmp_path):
    from repro_torch.launch import mesh

    ranks = mesh.spawn(_users_on_card, 2, "gloo", "cuda:0", timeout_s=120,
                       store_dir=str(tmp_path))
    _assert_users(ranks, card)


# ---------------------------------------------------------------------------
# LM parallelism across processes on the card: gloo ranks on one card and
# NCCL at world 1 against the unsharded run; kernel 6 at granite's groups
# ---------------------------------------------------------------------------


def _lm_card_configs():
    from repro_torch.launch import lm_run

    common = dict(smoke=True, dtype="float32", requests=3, slots=2, cache_len=96,
                  prompt_lens=(40, 80), first_multiple=2, max_new=(3, 5))
    return [lm_run.LMRunConfig(arch="qwen3_4b", mesh=(1, 2), **common),
            lm_run.LMRunConfig(arch="xlstm_1_3b", mesh=(1, 2), **common)]


def _lm_on_card(group, cfgs, forced) -> list:
    """``lm_run.run_lm`` of each config on cuda:0 as this rank of ``group``,
    teacher-forced with ``forced`` tokens."""
    from repro_torch.launch import lm_run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return [lm_run.run_lm(cfg, device=torch.device("cuda", 0), forced=tokens, timeout_s=120)
            for cfg, tokens in zip(cfgs, forced)]


def test_lm_procs_gloo_world2_on_one_card_equals_unsharded(card, tmp_path):
    """Two gloo ranks on one card (qwen3-4b and xlstm-1.3b smoke in f32 over
    (1, 2)) against the unsharded run on the card, fed the same tokens: the
    logits within the CPU test's 2e-5, every rank the same bits, kernels 6
    and 7 launched by each rank on its own heads."""
    from repro_torch.launch import lm_run, mesh

    cfgs = _lm_card_configs()
    refs = [lm_run.run_lm(cfg, sharded=False, device=card) for cfg in cfgs]
    ranks = mesh.spawn(_lm_on_card, 2, "gloo", "cuda:0",
                       args=(cfgs, [ref["tokens"] for ref in refs]), timeout_s=180,
                       store_dir=str(tmp_path))
    for i, (cfg, ref) in enumerate(zip(cfgs, refs)):
        mcfg = lm_run.model_config(cfg)
        for rank in ranks:
            got = rank[i]
            assert got["logit_digests"] == ranks[0][i]["logit_digests"]
            assert got["param_bytes"] == got["shard_bytes"]
            for uid, want in ref["logits"].items():
                np.testing.assert_allclose(got["logits"][uid], want, rtol=2e-5, atol=2e-5)
            layers = {bt: mcfg.num_periods * mcfg.block_pattern.count(bt)
                      for bt in ("attn", "slstm")}
            want_launches = {}
            if layers["attn"]:
                want_launches["flash_attention"] = layers["attn"] * cfg.requests
            if layers["slstm"]:
                want_launches["slstm_sequence"] = layers["slstm"] * (cfg.requests
                                                                     + len(got["decode"]))
            assert got["launches"] == want_launches


def test_lm_procs_nccl_world1_is_the_unsharded_run_bit_for_bit(card, tmp_path):
    import torch.distributed as dist

    from repro_torch.launch import lm_run, mesh

    cfgs = [dataclasses.replace(cfg, dtype=None, mesh=(1, 1)) for cfg in _lm_card_configs()]
    refs = [lm_run.run_lm(cfg, sharded=False, device=card) for cfg in cfgs]
    mesh.init_shard_group("nccl", "file://" + str(tmp_path / "store"), timeout_s=120, rank=0,
                          world_size=1, device=torch.device("cuda", 0))
    try:
        got = _lm_on_card(None, cfgs, [ref["tokens"] for ref in refs])
    finally:
        dist.destroy_process_group()
    for g, ref in zip(got, refs):
        for uid, want in ref["logits"].items():
            assert np.array_equal(g["logits"][uid], want)
        assert g["tokens"] == ref["tokens"] and g["launches"] == ref["launches"]
        assert all(not call["collectives"] for call in g["prefill"] + g["decode"])


@pytest.mark.parametrize("hq", [48, 12])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lm_procs_flash_kernel_at_granite_groups(card, hq, dtype):
    """Kernel 6 with every query head over granite's single kv head: 48
    (unsharded) and 12 (a rank of tp 4), hd 128."""
    gen = torch.Generator(device=card).manual_seed(hq)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for s in (129, 700):
        q = torch.randn((hq, s, 128), generator=gen, device=card).to(dtype)
        k, v = (torch.randn((1, s, 128), generator=gen, device=card).to(dtype) for _ in range(2))
        got = flash.flash_attention_fhsd(q, k, v, q_heads_per_kv=hq)
        want = flash.flash_attention_plain(q, k, v, q_heads_per_kv=hq)
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= tol * (1 + want.float().abs())).all()), float(diff.max())


@pytest.mark.parametrize("r_dtype", [torch.bfloat16, torch.float32])
def test_lm_procs_slstm_head_slices_are_the_whole_launch(card, r_dtype):
    """A rank of tp 4 launches kernel 7 on its own head of the projection
    (a strided view) and of r: each head's outputs are bit for bit the
    whole launch's (the cluster and cooperative variants alike)."""
    gen = torch.Generator(device=card).manual_seed(3)
    pre = 0.5 * torch.randn((1, 4, 300, 4, 512), generator=gen, device=card)
    r = (torch.randn((4, 4, 512, 512), generator=gen, device=card) / 512 ** 0.5).to(r_dtype)
    z = torch.zeros((1, 4, 512), device=card)
    states = (z, z, z, torch.full_like(z, -1e30))
    hs, finals = slstm.slstm_sequence(pre, r, *states)
    for h in range(4):
        one = tuple(t[:, h:h + 1].contiguous() for t in states)
        hs1, fin1 = slstm.slstm_sequence(pre[:, h:h + 1], r[h:h + 1], *one)
        assert torch.equal(hs1, hs[:, h:h + 1])
        assert all(torch.equal(a, b[:, h:h + 1]) for a, b in zip(fin1, finals))
