"""Executor cost accounting — exchange rounds, bytes and kernel launches.

The reference walks each executor's jaxpr for collectives and reads XLA's
cost analysis of the compiled program.  The port has neither: it runs the
executor once inside ``counting.scoped`` and reports what the calling thread
did there — every all-to-all round of the exchange (the transposes of the
stacked shards), the bytes one shard sent through them, and the kernel
launches by name.  Work other threads do at the same time (a fold, another
reader) is not counted.  ``flops`` and ``bytes_accessed`` have no source
and are ``None``.

``warm_server`` profiles one executor per (kind, depth) of its grid and
stores the :class:`ExecutorCost` rows on the ``ExecutorGrid``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch import counting

# The reference's collective primitives.  The stacked-shard exchange makes
# only all-to-alls; sums over the shard axis are local reductions.
COLLECTIVE_PRIMITIVES = (
    "all_to_all",
    "all_gather",
    "psum",
    "ppermute",
    "reduce_scatter",
)


@dataclasses.dataclass(frozen=True)
class ExecutorCost:
    """Measured cost of one executor run.

    ``collective_counts`` / ``collective_bytes`` hold the exchange rounds
    and the bytes of each transposed buffer for one shard, summed over the
    rounds; ``launches`` the kernel launches by name (empty on the CPU,
    where the plain twins run).
    """

    kind: str  # "query" | "retrieve" | "join"
    bucket: int  # query batch size
    depth: int  # delta depth of the state
    collective_counts: dict  # primitive name -> occurrences
    collective_bytes: dict  # primitive name -> summed bytes per shard
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    launches: dict = dataclasses.field(default_factory=dict)

    @property
    def all_to_alls(self) -> int:
        return self.collective_counts.get("all_to_all", 0)

    @property
    def all_to_all_bytes(self) -> int:
        return self.collective_bytes.get("all_to_all", 0)

    @property
    def total_collective_bytes(self) -> int:
        return sum(self.collective_bytes.values())

    @property
    def flop_per_byte(self) -> Optional[float]:
        if self.flops is None or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "bucket": self.bucket,
            "depth": self.depth,
            "all_to_alls": self.all_to_alls,
            "all_to_all_bytes": self.all_to_all_bytes,
            "collective_counts": dict(self.collective_counts),
            "collective_bytes": dict(self.collective_bytes),
            "total_collective_bytes": self.total_collective_bytes,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "flop_per_byte": self.flop_per_byte,
            "launches": dict(self.launches),
        }


def profile_executor(
    table,
    state,
    queries,
    *,
    kind: str,
    compiled=None,
    exec_kwargs: Optional[dict] = None,
) -> ExecutorCost:
    """Run one executor once and report its exchange rounds, bytes and launches.

    ``kind`` selects the executor (``"query"``, ``"retrieve"`` or
    ``"join"``), ``exec_kwargs`` its capacities; ``compiled`` (a
    ``CompiledPlan``, e.g. out of the AOT grid) is run instead when given.
    ``queries`` is a global packed batch.
    """
    from repro_torch.core import plans
    from repro_torch.core.state import as_state

    st = as_state(table, state)
    kw = dict(exec_kwargs or {})
    execs = {"query": plans.exec_query, "retrieve": plans.exec_retrieve, "join": plans.exec_join}
    if kind not in execs:
        raise ValueError(f"unknown executor kind {kind!r}")
    with counting.scoped() as scope:
        if compiled is not None:
            compiled(st, queries)
        else:
            execs[kind](table, st, table._pack_queries(queries), **kw)
    rounds, nbytes = scope.exchange_rounds, scope.exchange_bytes
    return ExecutorCost(
        kind=kind,
        bucket=int(queries.shape[0]),
        depth=len(st.deltas),
        collective_counts={"all_to_all": rounds} if rounds else {},
        collective_bytes={"all_to_all": nbytes} if rounds else {},
        launches=dict(scope.launches),
    )


__all__ = ["COLLECTIVE_PRIMITIVES", "ExecutorCost", "profile_executor"]
