"""Per-thread scoped counts of exchange rounds and kernel launches.

The process-wide counters (``exchange.CALLS``, ``kernels.build.LAUNCHES``)
add up every thread's work.  A server runs reads, writes and folds on
several threads at once, so a read's budget (two exchange rounds on the
fused path) cannot be read off them.  :func:`scoped` opens a
:class:`Scope` on the calling thread; every exchange round and kernel
launch that thread makes inside the block is recorded in it (and in every
enclosing scope of the same thread), and nothing another thread does is.

    with counting.scoped() as scope:
        plans.exec_query(table, state, queries)
    assert scope.exchange_rounds == 2

Over a process group (``exchange.ProcessGroup``) the scope holds this
rank's own rounds, and its reductions apart in ``collectives`` (``"psum"``,
``"pmax"``, ``"agree"``), which a stacked run never makes.  The language
models' collectives over a mesh axis (``distributed/collectives.py``) are
counted there too, with the bytes of each rank's input in
``collective_bytes``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

_local = threading.local()


@dataclasses.dataclass
class Scope:
    """What the calling thread did inside one :func:`scoped` block."""

    rounds: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    round_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collectives: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collective_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def exchange_rounds(self) -> int:
        """Exchange rounds under every label."""
        return sum(self.rounds.values())

    @property
    def exchange_bytes(self) -> int:
        """Bytes one shard sent through those rounds."""
        return sum(self.round_bytes.values())


def _scopes() -> list:
    scopes = getattr(_local, "scopes", None)
    if scopes is None:
        scopes = _local.scopes = []
    return scopes


@contextlib.contextmanager
def scoped():
    """Record the calling thread's exchange rounds and launches in a new scope."""
    scope = Scope()
    scopes = _scopes()
    scopes.append(scope)
    try:
        yield scope
    finally:
        scopes.remove(scope)


def record_round(label: str, nbytes: int) -> None:
    """One exchange round under ``label`` moving ``nbytes`` per shard."""
    for scope in _scopes():
        scope.rounds[label] += 1
        scope.round_bytes[label] += int(nbytes)


def record_collective(kind: str, nbytes: int = 0) -> None:
    """One collective of a process group (``"psum"``, ``"pmax"``, ``"agree"``,
    ...) whose input on this rank is ``nbytes`` long."""
    for scope in _scopes():
        scope.collectives[kind] += 1
        scope.collective_bytes[kind] += int(nbytes)


def record_launch(name: str) -> None:
    """One launch of kernel ``name``."""
    for scope in _scopes():
        scope.launches[name] += 1
