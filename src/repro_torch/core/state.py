"""Table state (port of ``repro.core.state``), base-only in this slice.

A :class:`TableState` holds the base graph, an empty delta ring and an empty
tombstone buffer.  Inserts, deletes, upserts, TTLs and compaction build on
it in a later slice; a state that carries deltas or tombstones is refused
rather than read wrongly.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.core.multi_hashgraph import DistributedHashGraph

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.table import DistributedHashTable


@dataclasses.dataclass(frozen=True)
class Tombstones:
    """Delete buffer: keys and their epochs (empty in this slice)."""

    keys: torch.Tensor  # (T,) int32 uint32 bits
    epochs: torch.Tensor  # (T,) int32
    num_dropped: torch.Tensor  # () int64

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[0])

    def index(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Sorted ``(keys, epochs)`` lookup pair; an empty buffer is sorted."""
        if self.capacity:
            raise NotImplementedError("tombstones belong to a later slice of the port")
        return self.keys, self.epochs


def empty_tombstones(device) -> Tombstones:
    return Tombstones(
        keys=torch.empty(0, dtype=torch.int32, device=device),
        epochs=torch.empty(0, dtype=torch.int32, device=device),
        num_dropped=torch.zeros((), dtype=torch.int64, device=device),
    )


@dataclasses.dataclass(frozen=True)
class TableState:
    """Immutable snapshot of a table: ``layers == (base,)`` in this slice."""

    base: DistributedHashGraph
    tombstones: Tombstones
    table: "DistributedHashTable"
    deltas: tuple = ()

    def __post_init__(self):
        if self.deltas or self.tombstones.capacity:
            raise NotImplementedError(
                "delta layers and tombstones belong to a later slice of the port"
            )

    @property
    def layers(self) -> tuple:
        return (self.base,) + tuple(self.deltas)

    @property
    def num_dropped(self) -> torch.Tensor:
        """Total overflow across the base build and the tombstone buffer."""
        return self.base.num_dropped + self.tombstones.num_dropped


def as_state(table: "DistributedHashTable", state) -> TableState:
    """Lift a bare :class:`DistributedHashGraph` into a :class:`TableState`."""
    if isinstance(state, TableState):
        return state
    if isinstance(state, DistributedHashGraph):
        return TableState(
            base=state, tombstones=empty_tombstones(state.hash_splits.device), table=table
        )
    raise TypeError(
        f"expected TableState or DistributedHashGraph, got {type(state).__name__}"
    )
