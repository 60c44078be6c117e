"""Table serving engine — snapshot-swapped reads, micro-batched requests,
incremental background compaction, and an async warmed front end (port of
``repro.serve_table``).

Synchronous::

    from repro_torch.serve_table import TableServer

    server = TableServer(table, keys, values)       # seqno-0 snapshot
    server.submit_insert(new_keys, new_values)      # queued
    server.step()                                   # applied + published
    counts, seqno = server.query_many([q1, q2, q3]) # one fused execution
    server.fold_async()                             # compaction off the read path

Async::

    from repro_torch.serve_table import AsyncFrontend, TableServer

    server = TableServer(table, keys, values, write_bucket=256)
    server.warm(buckets=(64, 128, 256))             # the executor grid
    with AsyncFrontend(server, linger=0.002) as fe:
        fut = fe.submit_query(q)                    # -> Future[QueryResult]
        fe.submit_insert(new_keys)                  # bounded backlog
        print(fut.result().counts)
"""
from repro_torch.core.maintenance import CompactionPolicy, TableStats, fold_oldest
from repro_torch.serve_table.aot import ExecutorGrid, WarmupStats, warm_server
from repro_torch.serve_table.batcher import BatcherStats, MicroBatcher, PendingBatch
from repro_torch.serve_table.frontend import (
    AsyncFrontend,
    DeadlineBatcher,
    FrontendStats,
    QueryResult,
)
from repro_torch.serve_table.server import ServerStats, TableServer
from repro_torch.serve_table.snapshot import Snapshot, SnapshotRegistry

__all__ = [
    "AsyncFrontend",
    "BatcherStats",
    "CompactionPolicy",
    "DeadlineBatcher",
    "ExecutorGrid",
    "FrontendStats",
    "MicroBatcher",
    "PendingBatch",
    "QueryResult",
    "ServerStats",
    "Snapshot",
    "SnapshotRegistry",
    "TableServer",
    "TableStats",
    "WarmupStats",
    "warm_server",
]
