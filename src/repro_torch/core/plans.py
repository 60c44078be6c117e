"""Plan/execute API over a versioned table state (port of
``repro.core.plans``).

The executors (``exec_*``) take the table (for its settings), a
:class:`TableState` and a ``(D, n_local[, L])`` query tensor, and run the
sharded path at once over ``base + deltas - tombstones``.  A *plan* binds a
table to its resolved statics (query count, capacities) and returns global
layouts, as the table's read methods do:

    plan = table.plan_retrieve(state, queries)        # counts round, syncs once
    plan = table.plan_retrieve(num_queries=n, out_capacity=4096, seg_capacity=512)
    result = plan(state2, queries2)

PyTorch has no program to compile, so ``plan.compile(state)`` runs the
executor once on an all-sentinel batch against ``state`` (the kernel library
is loaded and the caching allocator holds blocks of these shapes) and
returns a :class:`CompiledPlan` bound to ``(kind, num_queries,
state_signature(state))``, which refuses any other structure.
``plan.lower(state)`` returns an object whose ``.compile()`` does the same,
the reference's two-step idiom.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import hashgraph, multi_hashgraph
from repro_torch.core.hashgraph import EMPTY_BITS
from repro_torch.core.multi_hashgraph import ShardJoin, ShardRetrieval
from repro_torch.core.state import TableState, as_state


def _fused(table, state: TableState) -> bool:
    """Single-route layered execution?  Needs the partition-coherence
    invariant; ``table.fused_routing=False`` forces the per-layer path."""
    if table.fused_routing is False:
        return False
    return state.coherent or len(state.deltas) == 0


def _read_kw(table, state: TableState) -> dict:
    return dict(
        tombstones=state.tombstones.index(),
        fused=_fused(table, state),
        capacity_slack=table.capacity_slack,
    )


def exec_query(
    table, state: TableState, queries: torch.Tensor, *, dest_offset: int = 0
) -> torch.Tensor:
    """Merged multiplicity per query, ``(D, n_local)`` int32.

    ``dest_offset`` counts replica ``r`` of hot-key rows; ``table.query``
    sums the rounds ``r = 0..R-1`` (a key that was not replicated counts 0
    on every round but the first).  The default 0 is the one fused round.
    """
    return multi_hashgraph.query_layers_sharded(
        state.layers,
        queries,
        paper_faithful_probe=table.paper_faithful_probe,
        max_probe=table.max_probe,
        dest_offset=dest_offset,
        **_read_kw(table, state),
    )


def exec_join_size(table, state: TableState, queries: torch.Tensor) -> torch.Tensor:
    """Global join cardinality over the versioned stack, an int64 scalar."""
    return multi_hashgraph.join_size_layers_sharded(
        state.layers,
        queries,
        paper_faithful_probe=table.paper_faithful_probe,
        max_probe=table.max_probe,
        **_read_kw(table, state),
    )


def exec_retrieve(
    table,
    state: TableState,
    queries: torch.Tensor,
    *,
    out_capacity: int,
    seg_capacity: int,
    per_layer_counts: bool = False,
) -> ShardRetrieval:
    """Merged CSR retrieval over the versioned stack.  ``per_layer_counts``
    fills ``layer_counts``; on the fused path the planes ride the values'
    return call, so the retrieve stays at two exchange calls."""
    return multi_hashgraph.retrieve_layers_sharded(
        state.layers,
        queries,
        seg_capacity=seg_capacity,
        out_capacity=out_capacity,
        per_layer_counts=per_layer_counts,
        **_read_kw(table, state),
    )


def exec_join(
    table,
    state: TableState,
    queries: torch.Tensor,
    *,
    out_capacity: int,
    seg_capacity: int,
) -> ShardJoin:
    """Materialized inner join over the versioned stack."""
    return multi_hashgraph.inner_join_layers_sharded(
        state.layers,
        queries,
        seg_capacity=seg_capacity,
        out_capacity=out_capacity,
        **_read_kw(table, state),
    )


def exec_plan_caps(table, state: TableState, queries: torch.Tensor) -> tuple[int, int]:
    """The one counts round sizing both capacities: ``(seg, out)``."""
    return multi_hashgraph.plan_caps_sharded(state.layers, queries, **_read_kw(table, state))


def _layer_live(state: TableState) -> list[torch.Tensor]:
    ts_keys, ts_epochs = state.tombstones.index()
    live = []
    for epoch, layer in enumerate(state.layers):
        k = layer.local.keys
        dead = hashgraph.is_empty_key(k, layer.local.key_lanes)
        if ts_keys.shape[0]:
            dead = dead | (hashgraph.match_epochs_sorted(k, ts_keys, ts_epochs) >= epoch)
        live.append((~dead).sum())
    return live


def exec_live_count(table, state: TableState) -> torch.Tensor:
    """Live (non-tombstoned, non-sentinel) rows over every layer and shard:
    the count behind compaction sizing (a sum, no exchange)."""
    return torch.stack(_layer_live(state)).sum()


def exec_layer_live(table, state: TableState) -> torch.Tensor:
    """Per-layer live row counts ``(num_layers,)``, base first."""
    return torch.stack(_layer_live(state))


def _leaf(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), str(t.dtype).removeprefix("torch."))


def state_signature(state: TableState) -> tuple:
    """Structural identity of a state: delta depth, coherence, each layer's
    static geometry and its tensors' shapes and dtypes, and the tombstone
    buffer's.  Two states with equal signatures have the same structure,
    whatever their data, and run through the same compiled plans."""
    layers = tuple(
        (
            layer.hash_range,
            layer.seed,
            layer.local_range_cap,
            layer.bucket_stride,
            layer.local.table_size,
            layer.local.seed,
            _leaf(layer.hash_splits),
            _leaf(layer.local.offsets),
            _leaf(layer.local.keys),
            _leaf(layer.local.values),
            _leaf(layer.local.fingerprints),
        )
        for layer in state.layers
    )
    ts = state.tombstones
    return (state.coherent, layers, (_leaf(ts.keys), _leaf(ts.epochs), _leaf(ts.expires)))


# ---------------------------------------------------------------------------
# Global layouts: shard blocks stacked along dim 0, as the reference returns
# ---------------------------------------------------------------------------


def global_retrieval(r: ShardRetrieval) -> ShardRetrieval:
    """Block ``d`` of ``offsets`` (``n_local + 1`` rows) indexes block ``d``
    of ``values``; ``layer_counts`` is ``(Nq, L)``."""
    lc = r.layer_counts
    return ShardRetrieval(
        offsets=r.offsets.reshape(-1),
        values=r.values.reshape(-1, *r.values.shape[2:]),
        counts=r.counts.reshape(-1),
        num_dropped=r.num_dropped,
        layer_counts=None if lc is None else lc.reshape(-1, lc.shape[-1]),
    )


def global_join(j: ShardJoin) -> ShardJoin:
    return ShardJoin(
        query_idx=j.query_idx.reshape(-1),
        values=j.values.reshape(-1, *j.values.shape[2:]),
        num_results=j.num_results,
        num_dropped=j.num_dropped,
    )


# ---------------------------------------------------------------------------
# Compiled plans
# ---------------------------------------------------------------------------


def _proto_queries(table, num_queries: int) -> torch.Tensor:
    """An all-sentinel query batch with the schema's packed shape, on the
    table's device."""
    lanes = table.schema.key_lanes
    shape = (num_queries,) if lanes == 1 else (num_queries, lanes)
    return torch.full(shape, EMPTY_BITS, dtype=torch.int32, device=table.device)


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """A plan bound to one state structure and batch size.

    Built by ``plan.compile(state)``, which ran the executor once against
    ``state``.  Calls require the exact structure it was built for: a state
    matching :func:`state_signature` and a batch of ``num_queries`` keys;
    anything else raises ``ValueError`` and is never run.
    """

    plan: object  # the QueryPlan / RetrievePlan / JoinPlan it runs
    kind: str  # "query" | "retrieve" | "join"
    num_queries: int
    signature: tuple  # state_signature it was compiled against

    def __call__(self, state, queries):
        st = as_state(self.plan.table, state)
        if state_signature(st) != self.signature:
            raise ValueError(
                f"compiled {self.kind} plan got a state of another structure "
                f"(depth {len(st.deltas)}); compile a plan for it"
            )
        n = len(queries)
        if n != self.num_queries:
            raise ValueError(f"compiled {self.kind} plan takes {self.num_queries} queries, got {n}")
        return self.plan(st, queries)


@dataclasses.dataclass(frozen=True)
class _Lowered:
    """``plan.lower(state)``: the prototype ``(state, queries)``; ``.compile()``
    runs it once and returns the :class:`CompiledPlan`."""

    plan: object
    state: TableState
    queries: torch.Tensor

    def compile(self) -> CompiledPlan:
        self.plan(self.state, self.queries)
        return CompiledPlan(
            plan=self.plan,
            kind=self.plan.kind,
            num_queries=int(self.queries.shape[0]),
            signature=state_signature(self.state),
        )


# ---------------------------------------------------------------------------
# Plans: small frozen descriptors binding a table to resolved statics
# ---------------------------------------------------------------------------


class _PlanBase:
    kind = ""

    def _prep(self, state, queries):
        st = as_state(self.table, state)
        q = self.table._pack_queries(queries)
        n = q.shape[0] * q.shape[1]
        if self.num_queries is not None and n != self.num_queries:
            raise ValueError(f"plan was built for {self.num_queries} queries, got {n}")
        return st, q

    def _proto_q(self, queries):
        if queries is not None:
            return self.table.schema.pack_keys(queries, self.table.device)
        if self.num_queries is None:
            raise ValueError("plan has no num_queries; pass a queries sample")
        return _proto_queries(self.table, self.num_queries)

    def lower(self, state, queries=None) -> _Lowered:
        """The prototype run against ``state``'s structure; ``queries``
        defaults to an all-sentinel batch of ``num_queries`` keys."""
        return _Lowered(self, as_state(self.table, state), self._proto_q(queries))

    def compile(self, state, queries=None) -> CompiledPlan:
        """Run the executor once against ``state`` and bind the plan to its
        structure: see :class:`CompiledPlan`."""
        return self.lower(state, queries).compile()


@dataclasses.dataclass(frozen=True)
class QueryPlan(_PlanBase):
    """``(state, queries) -> (Nq,) int32`` merged multiplicities."""

    table: object
    num_queries: Optional[int] = None
    kind = "query"

    def __call__(self, state, queries) -> torch.Tensor:
        st, q = self._prep(state, queries)
        return exec_query(self.table, st, q).reshape(-1)

    def join_size(self, state, queries) -> torch.Tensor:
        """Global join cardinality under the same plan (int64 scalar)."""
        st, q = self._prep(state, queries)
        return exec_join_size(self.table, st, q)


@dataclasses.dataclass(frozen=True)
class RetrievePlan(_PlanBase):
    """``(state, queries) -> ShardRetrieval`` with capacities fixed."""

    table: object
    num_queries: Optional[int]
    out_capacity: int
    seg_capacity: int
    per_layer_counts: bool = False
    kind = "retrieve"

    def __call__(self, state, queries) -> ShardRetrieval:
        st, q = self._prep(state, queries)
        return global_retrieval(exec_retrieve(
            self.table,
            st,
            q,
            out_capacity=self.out_capacity,
            seg_capacity=self.seg_capacity,
            per_layer_counts=self.per_layer_counts,
        ))


@dataclasses.dataclass(frozen=True)
class JoinPlan(_PlanBase):
    """``(state, queries) -> ShardJoin`` with capacities fixed."""

    table: object
    num_queries: Optional[int]
    out_capacity: int
    seg_capacity: int
    kind = "join"

    def __call__(self, state, queries) -> ShardJoin:
        st, q = self._prep(state, queries)
        return global_join(exec_join(
            self.table, st, q, out_capacity=self.out_capacity, seg_capacity=self.seg_capacity
        ))
