"""Eager executors over a table state (port of the ``exec_*`` functions of
``repro.core.plans``).

PyTorch runs eagerly, so there is no jit and no plan object: each executor
takes the table (for its settings), a :class:`TableState` and a
``(D, n_local)`` query tensor, and runs the sharded path at once.
"""
from __future__ import annotations

import torch

from repro_torch.core import multi_hashgraph
from repro_torch.core.multi_hashgraph import ShardJoin, ShardRetrieval
from repro_torch.core.state import TableState


def exec_query(table, state: TableState, queries: torch.Tensor) -> torch.Tensor:
    """Multiplicity per query, ``(D, n_local)`` int32."""
    (base,) = state.layers
    return multi_hashgraph.query_sharded(base, queries, capacity_slack=table.capacity_slack)


def exec_join_size(table, state: TableState, queries: torch.Tensor) -> torch.Tensor:
    """Global join cardinality, an int64 scalar tensor."""
    (base,) = state.layers
    return multi_hashgraph.join_size_sharded(
        base, queries, capacity_slack=table.capacity_slack
    )


def exec_retrieve(
    table,
    state: TableState,
    queries: torch.Tensor,
    *,
    out_capacity: int,
    seg_capacity: int,
) -> ShardRetrieval:
    """Fused single-route CSR retrieval."""
    (base,) = state.layers
    return multi_hashgraph.retrieve_sharded(
        base,
        queries,
        seg_capacity=seg_capacity,
        out_capacity=out_capacity,
        capacity_slack=table.capacity_slack,
    )


def exec_join(
    table,
    state: TableState,
    queries: torch.Tensor,
    *,
    out_capacity: int,
    seg_capacity: int,
) -> ShardJoin:
    """Materialized inner join over the fused single-route path."""
    (base,) = state.layers
    return multi_hashgraph.inner_join_sharded(
        base,
        queries,
        seg_capacity=seg_capacity,
        out_capacity=out_capacity,
        capacity_slack=table.capacity_slack,
    )


def exec_plan_caps(table, state: TableState, queries: torch.Tensor) -> tuple[int, int]:
    """The one counts round sizing both capacities: ``(seg, out)``."""
    return multi_hashgraph.plan_caps_sharded(
        state.layers, queries, capacity_slack=table.capacity_slack
    )
