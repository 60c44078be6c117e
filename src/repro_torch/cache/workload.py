"""YCSB-style mixed-workload generators (zipfian keys, A–F op mixes): a
numpy copy of ``repro.cache.workload`` (the same streams from the same
seeds).

The canonical cloud-serving benchmark shapes (Cooper et al., SoCC'10),
host-side and numpy-only — the generator produces *op batches* (grouped
by kind so each maps to one table/server call) and the driver decides how
to execute them (``chip_smoke.py`` runs them through the eager
:class:`~repro_torch.cache.kvcache.KVCache` on the card).

Workload letters::

    A  update-heavy   50% read / 50% update        zipfian
    B  read-heavy     95% read /  5% update        zipfian
    C  read-only     100% read                     zipfian
    D  read-latest    95% read /  5% insert        latest (recency-skewed)
    E  short-ranges   95% scan /  5% insert        zipfian (scan = multiget)
    F  read-mod-write 50% read / 50% RMW           zipfian

``scan`` is a contiguous multiget over insertion-order key indices — the
table is a hash table, so "range" means the loader's key sequence, which
is what YCSB-E measures on hashed stores too.  RMW ops read a key and
write it back in the same batch (the driver issues the read first).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

# Affine bijection modulo the Mersenne prime 2^31 - 1: spreads insertion
# order over the key space deterministically (YCSB's hashed-key idiom)
# while staying injective and never producing the EMPTY sentinel.
_KEY_P = (1 << 31) - 1
_KEY_A = 1103515245
_KEY_B = 12345


def key_of(index) -> np.ndarray:
    """Key id for insertion-order ``index`` (vectorized, uint32, never EMPTY)."""
    idx = np.asarray(index, dtype=np.uint64)
    return ((idx * _KEY_A + _KEY_B) % _KEY_P).astype(np.uint32)


class ZipfianGenerator:
    """Bounded zipfian ranks: ``P(rank=i) ∝ 1 / (i+1)^theta``, rank 0 hottest.

    CDF-inversion sampling (exact, vectorized) — the precomputed CDF is
    O(n) floats, fine for the benchmark-scale key counts this drives.
    ``theta=0.99`` is the YCSB default skew.
    """

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0):
        if n < 1:
            raise ValueError("need at least one key")
        self.n = int(n)
        self.theta = float(theta)
        w = 1.0 / np.arange(1, self.n + 1, dtype=np.float64) ** self.theta
        self._cdf = np.cumsum(w)
        self._cdf /= self._cdf[-1]
        self.rng = np.random.default_rng(seed)

    def sample(self, size: int) -> np.ndarray:
        """``size`` ranks in ``[0, n)``; rank 0 is the hottest."""
        return np.searchsorted(
            self._cdf, self.rng.random(size), side="left"
        ).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Op mix of one workload letter (fractions sum to 1)."""

    name: str
    read: float = 0.0
    update: float = 0.0
    insert: float = 0.0
    scan: float = 0.0
    rmw: float = 0.0
    request_distribution: str = "zipfian"  # or "latest"

    def __post_init__(self):
        total = self.read + self.update + self.insert + self.scan + self.rmw
        if abs(total - 1.0) > 1e-9:
            raise ValueError(f"workload {self.name}: mix sums to {total}, not 1")


WORKLOADS = {
    "A": WorkloadSpec("A", read=0.5, update=0.5),
    "B": WorkloadSpec("B", read=0.95, update=0.05),
    "C": WorkloadSpec("C", read=1.0),
    "D": WorkloadSpec("D", read=0.95, insert=0.05, request_distribution="latest"),
    "E": WorkloadSpec("E", scan=0.95, insert=0.05),
    "F": WorkloadSpec("F", read=0.5, rmw=0.5),
}


class YCSBWorkload:
    """Batched op stream for one workload letter.

    Yields ``(kind, keys, values)`` tuples — ``kind`` in ``{"read",
    "update", "insert", "scan", "rmw"}``, ``keys`` uint32, ``values``
    int32 (None for reads/scans).  Ops are drawn per-batch from the mix
    and grouped by kind, so each tuple maps to exactly one batched
    table/server call; ``scan`` keys are the flattened contiguous
    multigets (``scan_len`` per scan op).

    ``num_keys`` is the *loaded* population (insert via :meth:`load_keys`
    / :meth:`load_values`); D/E-style inserts append fresh keys after it
    and the "latest" distribution re-skews toward them as they land.
    """

    def __init__(
        self,
        spec: WorkloadSpec,
        num_keys: int,
        *,
        theta: float = 0.99,
        batch: int = 256,
        scan_len: int = 16,
        seed: int = 0,
    ):
        self.spec = spec
        self.num_keys = int(num_keys)
        self.batch = int(batch)
        self.scan_len = int(scan_len)
        self.zipf = ZipfianGenerator(num_keys, theta=theta, seed=seed)
        self.rng = np.random.default_rng(seed + 1)
        self.inserted = self.num_keys  # insertion cursor (D/E fresh keys)
        self._value_seq = 0

    # -- load phase ----------------------------------------------------------
    def load_keys(self) -> np.ndarray:
        """The initial key population, insertion order."""
        return key_of(np.arange(self.num_keys))

    def load_values(self) -> np.ndarray:
        """Initial values: the insertion index (so reads are checkable)."""
        return np.arange(self.num_keys, dtype=np.int32)

    # -- run phase -----------------------------------------------------------
    def _ranks_to_indices(self, ranks: np.ndarray) -> np.ndarray:
        if self.spec.request_distribution == "latest":
            # Rank 0 = newest inserted key, recency-skewed like YCSB-D.
            return (self.inserted - 1 - ranks) % self.inserted
        return ranks

    def _next_values(self, n: int) -> np.ndarray:
        v = np.arange(self._value_seq, self._value_seq + n, dtype=np.int64)
        self._value_seq += n
        return (v % (1 << 31)).astype(np.int32)

    def batches(self, num_ops: int) -> Iterator[tuple]:
        """Yield grouped op batches totalling ``num_ops`` ops."""
        mix = self.spec
        kinds = np.array(["read", "update", "insert", "scan", "rmw"])
        probs = np.array([mix.read, mix.update, mix.insert, mix.scan, mix.rmw])
        remaining = int(num_ops)
        while remaining > 0:
            b = min(self.batch, remaining)
            remaining -= b
            draw = self.rng.choice(len(kinds), size=b, p=probs)
            counts = np.bincount(draw, minlength=len(kinds))
            for kind, count in zip(kinds, counts):
                if not count:
                    continue
                if kind == "insert":
                    idx = np.arange(self.inserted, self.inserted + count)
                    self.inserted += int(count)
                    yield ("insert", key_of(idx), self._next_values(count))
                    continue
                ranks = self.zipf.sample(count)
                idx = self._ranks_to_indices(ranks)
                if kind == "scan":
                    spans = idx[:, None] + np.arange(self.scan_len)[None, :]
                    spans %= self.inserted
                    yield ("scan", key_of(spans.reshape(-1)), None)
                elif kind == "read":
                    yield ("read", key_of(idx), None)
                else:  # update / rmw — rmw's read half is the driver's job
                    yield (kind, key_of(idx), self._next_values(count))
