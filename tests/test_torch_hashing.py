"""Parity of the PyTorch port's hashing, histogram and partitioning with the
JAX package, plus the port's package rules (imports, devices, schema).

All comparisons are exact: every output is an integer.  Inputs come from
``np.random.default_rng`` and go through both packages as numpy arrays.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import hashing as jhashing
from repro.core import partition as jpartition
from repro.kernels import ops as jops
from repro_torch import DistributedHashTable, TableSchema
from repro_torch.core import hashing, partition
from repro_torch.core.schema import u32_bits
from repro_torch.kernels import build, histogram, murmur

SEEDS = (jhashing.DEFAULT_SEED, jhashing.FINGERPRINT_SEED)
SPECIAL = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _keys(seed: int, n: int = 4093) -> np.ndarray:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([SPECIAL, keys])


def _t(a: np.ndarray) -> torch.Tensor:
    return u32_bits(a)


def test_seeds_and_constants_match_reference():
    assert hashing.DEFAULT_SEED == jhashing.DEFAULT_SEED
    assert hashing.FINGERPRINT_SEED == jhashing.FINGERPRINT_SEED


@pytest.mark.parametrize("seed", SEEDS)
def test_murmur3_u32_matches_reference(seed):
    keys = _keys(seed)
    want = np.asarray(jhashing.murmur3_u32(jnp.asarray(keys), seed=seed))
    got = hashing.murmur3_u32(_t(keys), seed).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("table_size", [1, 7, 4096, 1 << 27, 2**31 - 1])
def test_hash_to_buckets_matches_reference_and_pallas(seed, table_size):
    keys = _keys(seed + table_size)
    core = np.asarray(jhashing.hash_to_buckets(jnp.asarray(keys), table_size, seed=seed))
    pallas = np.asarray(
        jops.hash_to_buckets(jnp.asarray(keys), table_size, seed, interpret=True)
    )
    got = hashing.hash_to_buckets(_t(keys), table_size, seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), core)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # The kernel wrapper's plain twin is the same function.
    np.testing.assert_array_equal(murmur.murmur_bucket_plain(_t(keys), table_size, seed).numpy(), core)


def test_hash_to_buckets_rejects_bad_table_size():
    with pytest.raises(ValueError):
        hashing.hash_to_buckets(_t(SPECIAL), 0)
    with pytest.raises(ValueError):
        hashing.hash_to_buckets(_t(SPECIAL), 2**31)


@pytest.mark.parametrize("num_bins", [128, 256, 640])
def test_bin_histogram_matches_pallas(num_bins):
    rng = np.random.default_rng(num_bins)
    bins = rng.integers(-5, num_bins + 300, size=5000, dtype=np.int32)
    want = np.asarray(jops.bin_histogram(jnp.asarray(bins), num_bins, interpret=True))
    got = histogram.bin_histogram(torch.from_numpy(bins), num_bins)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hash_range", [4096, 100_003, 1 << 20])
def test_local_bin_histogram_with_valid_mask(hash_range):
    rng = np.random.default_rng(hash_range)
    buckets = rng.integers(0, hash_range, size=6000, dtype=np.int32)
    valid = rng.random(6000) < 0.8
    num_bins = jpartition.choose_num_bins(hash_range, 8)
    assert partition.choose_num_bins(hash_range, 8) == num_bins
    want = np.asarray(
        jpartition.local_bin_histogram(
            jnp.asarray(buckets), num_bins, hash_range, valid=jnp.asarray(valid)
        )
    )
    got = partition.local_bin_histogram(
        torch.from_numpy(buckets), num_bins, hash_range, valid=torch.from_numpy(valid)
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("skew", ["uniform", "one_bin", "empty_tail"])
@pytest.mark.parametrize("devices", [1, 3, 8])
def test_balanced_splits_and_destinations_match_reference(skew, devices):
    hash_range = 1 << 14
    num_bins = jpartition.choose_num_bins(hash_range, devices)
    rng = np.random.default_rng(devices)
    hist = rng.integers(0, 50, size=num_bins, dtype=np.int32)
    if skew == "one_bin":
        hist[:] = 0
        hist[3] = 1000
    elif skew == "empty_tail":
        hist[num_bins // 4 :] = 0
    want = np.asarray(jpartition.balanced_hash_splits(jnp.asarray(hist), devices, hash_range))
    got = partition.balanced_hash_splits(torch.from_numpy(hist), devices, hash_range)
    np.testing.assert_array_equal(got.numpy(), want)
    buckets = rng.integers(0, hash_range, size=3000, dtype=np.int32)
    want_d = np.asarray(jpartition.destination_of(jnp.asarray(buckets), jnp.asarray(want)))
    got_d = partition.destination_of(torch.from_numpy(buckets), got)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


def test_cpu_tensors_take_the_plain_twins_and_count_no_launch():
    before = dict(build.LAUNCHES)
    hashing.hash_to_buckets(_t(SPECIAL), 97)
    histogram.bin_histogram(torch.zeros(8, dtype=torch.int32), 128)
    assert dict(build.LAUNCHES) == before


def test_import_hygiene():
    """The port imports neither jax nor any module of the JAX package."""
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_table_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedHashTable(hash_range=1 << 10)
    assert DistributedHashTable(hash_range=1 << 10, device="cpu").device.type == "cpu"


def test_later_slices_raise_not_implemented():
    # Key widths, value columns, the fingerprint lane, hot-key replication
    # and a loader over a mesh are ported; a mesh whose dp axes do not
    # divide the batch and bad schemas are refused.
    from repro_torch.data import ShardedLoader, SyntheticCorpus
    from repro_torch.distributed import AbstractMesh

    assert TableSchema("uint64").key_lanes == 2
    assert TableSchema("uint32", 3).value_cols == 3
    assert DistributedHashTable(hash_range=1 << 10, device="cpu", fingerprint=True).use_fingerprint
    assert DistributedHashTable(hash_range=1 << 10, device="cpu", replicate_hot_keys=2).hot_keys == {}
    with pytest.raises(ValueError, match="does not divide"):
        ShardedLoader(SyntheticCorpus(100, 8, device="cpu"), 6,
                      mesh=AbstractMesh((4,), ("data",))).next_batch()
    with pytest.raises(ValueError):
        TableSchema("int8")
    with pytest.raises(ValueError):
        TableSchema("uint64", 0)


def test_pack_keys_rejects_wide_keys_and_keeps_bits():
    sch = TableSchema()
    with pytest.raises(ValueError):
        sch.pack_keys(np.array([1 << 33], np.int64), "cpu")
    with pytest.raises(ValueError):
        sch.pack_keys(torch.tensor([-1], dtype=torch.int64), "cpu")
    bits = sch.pack_keys(np.array([0xFFFFFFFF, 5], np.uint64), "cpu")
    assert bits.dtype == torch.int32 and bits.tolist() == [-1, 5]
    same = sch.pack_keys(torch.tensor([0xFFFFFFFF, 5], dtype=torch.int64), "cpu")
    assert same.tolist() == [-1, 5]
