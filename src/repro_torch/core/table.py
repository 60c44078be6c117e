"""High-level table API (port of the eager parts of ``repro.core.table``).

    table = DistributedHashTable(num_shards=8, hash_range=1 << 20)  # the card
    state = table.init(keys)                  # keys: (N,) uint32, N % 8 == 0
    counts = table.query(state, queries)
    result = table.retrieve(state, queries)   # count-first capacity sizing
    pairs = join_to_pairs(table.inner_join(state, queries))

The D shards live on one device (see ``repro_torch.core.exchange``).
Results keep the reference's global layout: shard blocks stacked along dim
0, e.g. ``offsets`` of shape ``(D * (n_local + 1),)``, so they compare
directly with the JAX package's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import hashing, multi_hashgraph, plans
from repro_torch.core.multi_hashgraph import (
    DistributedHashGraph,
    ShardJoin,
    ShardRetrieval,
)
from repro_torch.core.schema import LATER_SLICE, TableSchema
from repro_torch.core.state import TableState, as_state, empty_tombstones
from repro_torch.utils import cdiv


@dataclasses.dataclass(kw_only=True, eq=False)
class DistributedHashTable:
    """The distributed HashGraph of ``num_shards`` shards on one device.

    ``device=None`` takes the CUDA card and raises when there is none; the
    plain PyTorch path runs only when the caller asks for ``device="cpu"``.
    ``seed``, ``capacity_slack``, ``range_slack`` and ``num_bins`` keep the
    reference's defaults and meaning.
    """

    hash_range: int
    num_shards: int = 1
    device: Optional[object] = None
    seed: int = hashing.DEFAULT_SEED
    capacity_slack: float = 1.25
    range_slack: float = 1.5
    num_bins: Optional[int] = None
    schema: Optional[TableSchema] = None
    fingerprint: Optional[bool] = None

    def __post_init__(self):
        if self.device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DistributedHashTable runs on the CUDA card by default and "
                    "none is available; pass device='cpu' for the plain path"
                )
            self.device = "cuda"
        self.device = torch.device(self.device)
        if self.schema is None:
            self.schema = TableSchema()
        if self.fingerprint:
            raise NotImplementedError(f"fingerprint=True belongs to {LATER_SLICE}")
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        hashing.check_table_size(self.hash_range)

    def _shard(self, flat: torch.Tensor, what: str) -> torch.Tensor:
        n = flat.shape[0]
        if n % self.num_shards:
            raise ValueError(
                f"{what} length {n} is not divisible by num_shards={self.num_shards}"
            )
        return flat.reshape(self.num_shards, n // self.num_shards)

    def _pack_queries(self, queries) -> torch.Tensor:
        return self._shard(self.schema.pack_keys(queries, self.device), "queries")

    # -- build ----------------------------------------------------------------
    def build(self, keys, values=None) -> DistributedHashGraph:
        """Build the distributed graph from a global ``(N,)`` key array.

        ``values``: optional ``(N,)`` int32 payload (default: global row ids).
        """
        k = self._shard(self.schema.pack_keys(keys, self.device), "keys")
        v = None
        if values is not None:
            v = self._shard(self.schema.pack_values(values, self.device), "values")
        return multi_hashgraph.build_sharded(
            k,
            hash_range=self.hash_range,
            values=v,
            num_bins=self.num_bins,
            capacity_slack=self.capacity_slack,
            range_slack=self.range_slack,
            seed=self.seed,
        )

    def init(self, keys, values=None) -> TableState:
        """Build and wrap into a (base-only) :class:`TableState`."""
        return TableState(
            base=self.build(keys, values),
            tombstones=empty_tombstones(self.device),
            table=self,
        )

    # -- reads ----------------------------------------------------------------
    def query(self, state, queries) -> torch.Tensor:
        """Multiplicity of each global query key, ``(Nq,)`` int32."""
        st = as_state(self, state)
        return plans.exec_query(self, st, self._pack_queries(queries)).reshape(-1)

    def contains(self, state, queries) -> torch.Tensor:
        return self.query(state, queries) > 0

    def join_size(self, state, queries) -> torch.Tensor:
        """Global inner-join cardinality (int64 scalar tensor)."""
        st = as_state(self, state)
        return plans.exec_join_size(self, st, self._pack_queries(queries))

    def plan_caps(self, state, queries) -> tuple[int, int]:
        """One counts round sizing retrieval exactly: ``(seg, out)`` ints."""
        st = as_state(self, state)
        return plans.exec_plan_caps(self, st, self._pack_queries(queries))

    def _resolve_caps(self, state: TableState, q: torch.Tensor, out_capacity, seg_capacity):
        """Count-first static output sizing, as in the reference: a ``None``
        capacity triggers the counts round; ``out`` is sized exactly,
        ``seg`` to the next power of two, both to a multiple of 8."""
        if out_capacity is None or seg_capacity is None:
            seg_need, out_need = plans.exec_plan_caps(self, state, q)
            if out_capacity is None:
                out_capacity = out_need
            if seg_capacity is None:
                seg_capacity = (
                    max(8, 1 << (seg_need - 1).bit_length()) if seg_need > 0 else 8
                )
        out_cap = max(8, cdiv(out_capacity, 8) * 8)
        seg_cap = max(8, cdiv(seg_capacity, 8) * 8)
        return out_cap, seg_cap

    def retrieve(
        self,
        state,
        queries,
        *,
        out_capacity: Optional[int] = None,
        seg_capacity: Optional[int] = None,
    ) -> ShardRetrieval:
        """All stored values for every occurrence of every query key.

        Global layout: block ``d`` of ``offsets`` (``n_local + 1`` rows)
        indexes block ``d`` of ``values`` (``out_capacity`` rows).  Overflow
        is reported in ``num_dropped``, never silently truncated.
        """
        st = as_state(self, state)
        q = self._pack_queries(queries)
        out_cap, seg_cap = self._resolve_caps(st, q, out_capacity, seg_capacity)
        r = plans.exec_retrieve(self, st, q, out_capacity=out_cap, seg_capacity=seg_cap)
        return ShardRetrieval(
            offsets=r.offsets.reshape(-1),
            values=r.values.reshape(-1),
            counts=r.counts.reshape(-1),
            num_dropped=r.num_dropped,
        )

    def inner_join(
        self,
        state,
        queries,
        *,
        out_capacity: Optional[int] = None,
        seg_capacity: Optional[int] = None,
    ) -> ShardJoin:
        """Materialized inner join: global ``(query_idx, value)`` match pairs,
        shard ``d``'s in block ``d`` with its count in ``num_results[d]``."""
        st = as_state(self, state)
        q = self._pack_queries(queries)
        out_cap, seg_cap = self._resolve_caps(st, q, out_capacity, seg_capacity)
        j = plans.exec_join(self, st, q, out_capacity=out_cap, seg_capacity=seg_cap)
        return ShardJoin(
            query_idx=j.query_idx.reshape(-1),
            values=j.values.reshape(-1),
            num_results=j.num_results,
            num_dropped=j.num_dropped,
        )


# ---------------------------------------------------------------------------
# Host-side views
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def retrieval_to_lists(result: ShardRetrieval) -> list:
    """One np.ndarray of values per global query (vectorized block slicing)."""
    counts = _np(result.counts)
    offsets = _np(result.offsets)
    values = _np(result.values)
    d = offsets.shape[0] - counts.shape[0]
    n_local = counts.shape[0] // d
    out_cap = values.shape[0] // d
    off2 = offsets.reshape(d, n_local + 1)
    flat = np.concatenate(
        [values[s * out_cap : s * out_cap + off2[s, -1]] for s in range(d)], axis=0
    )
    lens = np.diff(off2, axis=1).reshape(-1)
    return np.split(flat, np.cumsum(lens)[:-1])


def join_to_pairs(result: ShardJoin) -> np.ndarray:
    """``(M, 2)`` int32 rows ``(query_idx, value)`` of every valid pair."""
    qi = _np(result.query_idx)
    vals = _np(result.values)[:, None]
    nres = _np(result.num_results)
    d = nres.shape[0]
    out_cap = qi.shape[0] // d
    mask = np.arange(out_cap)[None, :] < nres[:, None]
    qi_sel = qi.reshape(d, out_cap)[mask]
    vals_sel = vals.reshape(d, out_cap, -1)[mask]
    return np.concatenate([qi_sel[:, None], vals_sel], axis=1).astype(np.int32)
