"""Versioned table state — base graph + delta ring + tombstones (port of
``repro.core.state``).

* ``base`` — the big :class:`DistributedHashGraph` of the last full build or
  compaction (epoch 0).
* ``deltas`` — a bounded ring of small graphs, one per ``insert``; delta
  ``i`` (0-based) has epoch ``i + 1``.
* ``tombstones`` — a fixed-capacity buffer of deleted keys, each stamped with
  the number of deltas when the delete was issued.  A tombstone of epoch
  ``e`` hides matching rows in every layer of epoch ``<= e`` and leaves later
  inserts visible, so delete-then-reinsert behaves like a real table.  Each
  entry also carries an ``expires`` stamp against the logical clock ``now``:
  a plain delete expires at 0 (masks at once), a TTL entry at ``now + ttl``
  masks nothing until the clock reaches it.  Expiry is resolved only in
  :meth:`Tombstones.effective_epochs`.

States are immutable: every mutation returns a new state and the old one
stays valid.  The tombstone buffer's ``count``, ``num_dropped`` and ``now``
are host integers (the port runs eagerly, so they never need a device
read); its arrays live on the table's device.  Over a process group the
buffer is replicated: deletes and upserts take the same batch on every
rank (``DistributedHashTable`` checks a checksum of it), so the buffer and
its host integers are the same everywhere and no branch on them can split
the ranks.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import torch

from repro_torch.core.hashgraph import (
    EMPTY_BITS,
    match_epochs,
    sort_tombstones,
)
from repro_torch.core.multi_hashgraph import DistributedHashGraph

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.table import DistributedHashTable

# Expiry stamp meaning "never": larger than any reachable logical clock.
NEVER_EXPIRES = 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class Tombstones:
    """Fixed-capacity delete/TTL buffer, shared by every shard (replicated
    on every rank of a process group).

    Unused slots hold EMPTY with epoch -1 (matched by nothing).
    ``num_dropped`` counts deletes that overflowed the buffer.
    """

    keys: torch.Tensor  # (T,) int32 uint32 bits, or (T, L) int32 lanes
    epochs: torch.Tensor  # (T,) int32, -1 in unused slots
    expires: torch.Tensor  # (T,) int32, logical time the entry takes effect
    count: int  # used slots
    num_dropped: int  # deletes lost to capacity
    now: int = 0  # the state's logical clock

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[0])

    def effective_epochs(self) -> torch.Tensor:
        """Per-entry masking epoch at the clock: -1 while an entry is pending."""
        return torch.where(self.now >= self.expires, self.epochs, -1).to(torch.int32)

    def epoch_of(self, keys: torch.Tensor) -> torch.Tensor:
        """Newest effective tombstone epoch matching each key (-1: none)."""
        return match_epochs(keys, self.keys, self.effective_epochs())

    def push(self, keys: torch.Tensor, epoch: int, expires=None) -> "Tombstones":
        """Append ``keys`` stamped with ``epoch``; overflow is counted.

        ``expires`` defaults to 0, an immediately effective delete.  Keys past
        the capacity are dropped and counted (the reference's ``mode="drop"``
        scatter).
        """
        n = int(keys.shape[0])
        room = max(0, min(n, self.capacity - self.count))
        overflow = max(self.count + n - self.capacity, 0)
        exp = torch.as_tensor(0 if expires is None else expires, dtype=torch.int32)
        exp = exp.to(self.expires.device).expand(n)
        new_keys, new_epochs, new_expires = (
            t.clone() for t in (self.keys, self.epochs, self.expires)
        )
        end = self.count + room
        new_keys[self.count : end] = keys[:room]
        new_epochs[self.count : end] = int(epoch)
        new_expires[self.count : end] = exp[:room]
        return Tombstones(
            keys=new_keys,
            epochs=new_epochs,
            expires=new_expires,
            count=min(self.count + n, self.capacity),
            num_dropped=self.num_dropped + overflow,
            now=self.now,
        )

    def at_time(self, now: int) -> "Tombstones":
        """The same buffer with the logical clock at ``now``."""
        return dataclasses.replace(self, now=int(now))

    def as_mask_args(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The raw ``(keys, effective_epochs)`` pair (push order)."""
        return self.keys, self.effective_epochs()

    def index(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Sorted ``(keys, effective epochs)`` lookup pair; pending entries
        sort with epoch -1, so a key's run ends with its newest masking epoch."""
        return sort_tombstones(self.keys, self.effective_epochs())


def empty_tombstones(capacity: int, now: int = 0, *, device, key_lanes: int = 1) -> Tombstones:
    """An all-empty tombstone buffer of ``capacity`` slots of ``key_lanes``-lane keys."""
    shape = (capacity,) if key_lanes == 1 else (capacity, key_lanes)
    return Tombstones(
        keys=torch.full(shape, EMPTY_BITS, dtype=torch.int32, device=device),
        epochs=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        expires=torch.full((capacity,), NEVER_EXPIRES, dtype=torch.int32, device=device),
        count=0,
        num_dropped=0,
        now=int(now),
    )


@dataclasses.dataclass(frozen=True)
class TableState:
    """Immutable snapshot of a mutable distributed table.

    ``coherent`` stamps the partition-coherence invariant: every delta was
    built on the base's frozen ``hash_splits``, so one routing round serves
    the whole stack (the fused path).  Stacks with a delta of its own splits
    (``coherent_deltas=False`` or a skew-guard fallback) carry
    ``coherent=False`` and are read layer by layer.
    """

    base: DistributedHashGraph
    deltas: tuple  # delta ring, delta i has epoch i + 1
    tombstones: Tombstones
    table: "DistributedHashTable"
    coherent: bool = True

    @property
    def epoch(self) -> int:
        """Current insert epoch == number of live deltas."""
        return len(self.deltas)

    @property
    def layers(self) -> tuple:
        """``(base, *deltas)``: layer ``i`` has epoch ``i``."""
        return (self.base,) + tuple(self.deltas)

    @property
    def num_dropped(self) -> torch.Tensor:
        """Total overflow across base build, delta builds and tombstones."""
        total = self.base.num_dropped + self.tombstones.num_dropped
        for d in self.deltas:
            total = total + d.num_dropped
        return total

    def stats(self):
        """A ``maintenance.TableStats`` snapshot (reads a few scalars)."""
        from repro_torch.core.maintenance import collect_stats

        return collect_stats(self)

    def should_compact(self, *, tombstone_load: float = 0.5, ring_full: bool = True) -> bool:
        """Is the state due for a fold: ring full, tombstone load reached, or
        tombstones overflowed?  A shim over ``maintenance.CompactionPolicy``."""
        from repro_torch.core.maintenance import CompactionPolicy

        policy = CompactionPolicy(
            max_delta_depth=self.table.max_deltas if ring_full else None,
            tombstone_load=tombstone_load,
        )
        return policy.due(self.stats())

    # -- functional mutation (forwarders to the owning table) ---------------
    def insert(self, keys, values=None, *, auto_compact: bool = False) -> "TableState":
        """New state with one more delta holding ``keys``/``values``."""
        return self.table.insert(self, keys, values, auto_compact=auto_compact)

    def delete(self, keys) -> "TableState":
        """New state with ``keys`` tombstoned at the current epoch."""
        return self.table.delete(self, keys)

    def upsert(self, keys, values=None, *, ttl: Optional[int] = None) -> "TableState":
        """New state where ``keys`` map to exactly ``values``; ``ttl``
        schedules expiry at ``now + ttl``."""
        return self.table.upsert(self, keys, values, ttl=ttl)

    @property
    def now(self) -> int:
        """The state's logical clock (drives TTL expiry)."""
        return self.tombstones.now

    def advance(self, now: int) -> "TableState":
        """New state with the logical clock at ``now`` (monotone by contract)."""
        return dataclasses.replace(self, tombstones=self.tombstones.at_time(now))

    def compact(self, capacity: Optional[int] = None) -> "TableState":
        """Fold deltas + tombstones into a fresh base; reset the ring."""
        return self.table.compact(self, capacity=capacity)


def as_state(table: "DistributedHashTable", state) -> TableState:
    """Lift a bare :class:`DistributedHashGraph` into a delta-free state with
    a zero-capacity tombstone buffer; pass a :class:`TableState` through."""
    if isinstance(state, TableState):
        return state
    if isinstance(state, DistributedHashGraph):
        return TableState(
            base=state,
            deltas=(),
            tombstones=empty_tombstones(
                0, device=state.hash_splits.device, key_lanes=state.local.key_lanes
            ),
            table=table,
        )
    raise TypeError(
        f"expected TableState or DistributedHashGraph, got {type(state).__name__}"
    )
