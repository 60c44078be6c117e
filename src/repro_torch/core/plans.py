"""Eager executors over a versioned table state (port of the ``exec_*``
functions of ``repro.core.plans``).

PyTorch runs eagerly, so there is no jit and no plan object: each executor
takes the table (for its settings), a :class:`TableState` and a
``(D, n_local)`` query tensor, and runs the sharded path at once over
``base + deltas - tombstones``.  The plan and AOT objects of the reference
(``QueryPlan``, ``RetrievePlan``, ``JoinPlan``, ``CompiledPlan``) belong to
a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashgraph, multi_hashgraph
from repro_torch.core.multi_hashgraph import ShardJoin, ShardRetrieval
from repro_torch.core.state import TableState


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


def exec_query(table, state: TableState, queries: torch.Tensor) -> torch.Tensor:
    """Merged multiplicity per query, ``(D, n_local)`` int32."""
    return multi_hashgraph.query_layers_sharded(
        state.layers,
        queries,
        paper_faithful_probe=table.paper_faithful_probe,
        max_probe=table.max_probe,
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
) -> ShardRetrieval:
    """Merged CSR retrieval over the versioned stack."""
    return multi_hashgraph.retrieve_layers_sharded(
        state.layers,
        queries,
        seg_capacity=seg_capacity,
        out_capacity=out_capacity,
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


def state_signature(state: TableState) -> tuple:
    """Structural identity of a state: delta depth, coherence, each layer's
    static geometry and array shapes, and the tombstone capacity.  Two states
    with equal signatures have the same structure, whatever their data."""
    layers = tuple(
        (
            layer.hash_range,
            layer.seed,
            layer.local_range_cap,
            layer.bucket_stride,
            tuple(layer.local.offsets.shape),
            tuple(layer.local.keys.shape),
        )
        for layer in state.layers
    )
    return (state.coherent, layers, state.tombstones.capacity)
