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

A backward pass on the card runs on autograd's own thread, which no scope
of the caller sees: :data:`PROCESS` counts every thread's collectives
(under a lock), as ``kernels.build.LAUNCHES`` counts every launch; a train
step reads it (``launch/train_run.py``).

Each collective also adds its wire bytes (``collective_wire``) by the
reference dry run's model for a group of ``group`` ranks
(:func:`wire_bytes`), and a kernel traced on the meta device (the dry run,
``launch/dryrun.py``) records the work its launch would do
(:func:`record_kernel`: ``kernel_flops``, ``kernel_bytes``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

_local = threading.local()
_lock = threading.Lock()


@dataclasses.dataclass
class Scope:
    """What the calling thread did inside one :func:`scoped` block."""

    rounds: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    round_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collectives: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collective_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collective_wire: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    kernel_flops: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    kernel_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def exchange_rounds(self) -> int:
        """Exchange rounds under every label."""
        return sum(self.rounds.values())

    @property
    def exchange_bytes(self) -> int:
        """Bytes one shard sent through those rounds."""
        return sum(self.round_bytes.values())


# Every thread's collectives (``record_collective``), process-wide.
PROCESS = Scope()


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


def wire_bytes(kind: str, nbytes: int, group: int) -> float:
    """Bytes one rank puts on the wire for a collective whose input on the
    rank is ``nbytes`` long, over ``group`` ranks: the reference dry run's
    model (``repro/launch/dryrun.py``, ``parse_collectives``) in terms of
    its output ``out`` -- all-gather ``out (g-1)/g`` (``out = g nbytes``),
    reduce-scatter ``out (g-1)`` (``out = nbytes / g``), all-reduce
    ``out 2(g-1)/g``, all-to-all ``out (g-1)/g``, a permute ``out``.  A
    broadcast, absent from the reference's list, is charged ``out``, as a
    permute (every rank but the root receives it once); the table's
    reductions (``"psum"``, ``"pmax"``, ``"agree"``) are all-reduces."""
    g = int(group)
    if g <= 1:
        return 0.0
    n = float(nbytes)
    if kind == "all_gather":
        return n * (g - 1)
    if kind in ("reduce_scatter", "all_to_all"):
        return n * (g - 1) / g
    if kind in ("all_reduce", "psum", "pmax", "agree"):
        return n * 2 * (g - 1) / g
    return n  # ppermute, broadcast


def record_collective(kind: str, nbytes: int = 0, group: int = 0) -> None:
    """One collective of a process group (``"psum"``, ``"pmax"``, ``"agree"``,
    ...) whose input on this rank is ``nbytes`` long, over ``group`` ranks
    (0: not known; no wire bytes)."""
    wire = wire_bytes(kind, nbytes, group)
    with _lock:
        PROCESS.collectives[kind] += 1
        PROCESS.collective_bytes[kind] += int(nbytes)
        PROCESS.collective_wire[kind] += wire
    for scope in _scopes():
        scope.collectives[kind] += 1
        scope.collective_bytes[kind] += int(nbytes)
        scope.collective_wire[kind] += wire


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """The work one launch of kernel ``name`` does (its FLOPs and the bytes it
    reads and writes), where the launch is traced and not run (the meta
    device)."""
    for scope in _scopes():
        scope.kernel_flops[name] += flops
        scope.kernel_bytes[name] += nbytes


def record_launch(name: str) -> None:
    """One launch of kernel ``name``."""
    for scope in _scopes():
        scope.launches[name] += 1
