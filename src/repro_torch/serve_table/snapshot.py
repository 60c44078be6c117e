"""Seqno-stamped, atomically-published table snapshots (port of
``repro.serve_table.snapshot``).

The serving design splits the table into two roles:

* a **published snapshot** — the immutable :class:`~repro_torch.core.state.
  TableState` every reader queries.  States are functional pytrees, so a
  reader holding a snapshot can never observe a torn write: the arrays it
  references are never mutated, only *replaced* by publishing a new state.
* a **shadow state** — the writer's working copy.  Mutations (insert /
  delete / fold) build new states off the shadow and publish when a batch
  is complete.

:class:`SnapshotRegistry` is the hinge between them: ``publish`` stamps a
monotonically increasing ``seqno`` and swaps the current reference under a
lock; ``current`` is a plain reference read (atomic in CPython, lock-free)
— the read path never waits on a writer or a background compaction.  A
small history ring keeps recent seqnos inspectable for debugging and
consistency tests.  A follower of a server across processes keeps every
snapshot instead (``history=None``) until the leader says no read can ask
for it any more (:meth:`SnapshotRegistry.release_below`): its reads run
against the leader's seqno, and its writes may publish ahead of them.

On the card a snapshot also carries ``ready``, the CUDA event recorded on
the publishing stream after the state's last kernel: a reader makes its own
stream wait on it before reading the state (a device-side wait, which never
blocks the host).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Optional

from repro_torch.core.state import TableState


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One published version of the table: ``(seqno, state)``.

    ``seqno`` 0 is the initial build; every publish increments it.  The
    state is immutable — holding a snapshot pins a consistent view for as
    long as the reference lives, with no locking protocol on the reader.
    """

    seqno: int
    state: TableState
    ready: Optional[object] = None  # torch.cuda.Event on the card, else None


class SnapshotRegistry:
    """Atomic publish/read of table snapshots.

    Thread contract: any number of reader threads call :meth:`current`;
    writers serialize :meth:`publish` through the internal lock (the
    server's writer loop is single-threaded anyway, the lock makes misuse
    safe rather than fast).  Readers are wait-free — ``current`` is one
    attribute load of an immutable :class:`Snapshot`.
    """

    def __init__(self, state: TableState, *, history: Optional[int] = 8, ready=None):
        self._lock = threading.Lock()
        self._published = threading.Condition(self._lock)
        self._current = Snapshot(0, state, ready)
        self._history: deque = deque(
            [self._current], maxlen=None if history is None else max(1, history))

    def current(self) -> Snapshot:
        """The last published snapshot (wait-free reference read)."""
        return self._current

    @property
    def seqno(self) -> int:
        return self._current.seqno

    def publish(self, state: TableState, ready=None) -> Snapshot:
        """Stamp ``state`` with the next seqno and swap it in atomically;
        ``ready`` is the event readers wait on before reading it."""
        with self._lock:
            snap = Snapshot(self._current.seqno + 1, state, ready)
            self._current = snap
            self._history.append(snap)
            self._published.notify_all()
            return snap

    def wait_for(self, seqno: int, timeout: Optional[float] = None) -> Snapshot:
        """Block until a snapshot with ``seqno`` or later is published.

        Read-your-writes for async callers: a writer learns the seqno its
        batch published at, hands it to a reader, and the reader parks here
        (Condition wait, no polling) until the read path is guaranteed to
        observe the write.  Returns the current snapshot (whose seqno may
        exceed the request); raises :class:`TimeoutError` on timeout.
        """
        with self._published:
            ok = self._published.wait_for(
                lambda: self._current.seqno >= seqno, timeout=timeout
            )
            if not ok:
                raise TimeoutError(
                    f"snapshot seqno {seqno} not published within {timeout}s "
                    f"(current {self._current.seqno})"
                )
            return self._current

    def recent(self, seqno: int) -> Optional[Snapshot]:
        """A recently published snapshot by seqno, if still in the ring."""
        with self._lock:
            for snap in self._history:
                if snap.seqno == seqno:
                    return snap
        return None

    def release_below(self, seqno: int) -> None:
        """Drop the kept snapshots older than ``seqno`` (never the current)."""
        with self._lock:
            while len(self._history) > 1 and self._history[0].seqno < seqno:
                self._history.popleft()
