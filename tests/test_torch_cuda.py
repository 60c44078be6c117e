"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither jax nor the JAX package, so it also runs on a machine that has only
PyTorch, skipping the repo's JAX conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

All comparisons are exact: every output is an integer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import DistributedHashTable, join_to_pairs
from repro_torch.core import convert
from repro_torch.core.hashing import DEFAULT_SEED, FINGERPRINT_SEED
from repro_torch.core.schema import u32_bits
from repro_torch.core import maintenance
from repro_torch.kernels import bucket_probe, build, histogram, murmur, ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
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
