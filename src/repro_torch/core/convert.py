"""Carry graphs and versioned states across packages as numpy arrays.

:func:`graph_to_numpy` flattens the port's graph into the reference's global
stacked layout (shard blocks along dim 0) and :func:`graph_from_numpy` reads
that layout back, so a graph built by the JAX package, read out with
``np.asarray`` field by field, can be queried by the port, which tests the
read path apart from the build.  :func:`state_from_numpy` and
:func:`state_to_numpy` do the same for a whole ``TableState``: base, every
delta, every tombstone field and the ``coherent`` flag.  Key lanes ``(...,
2)``, value columns ``(..., C)``, the fingerprint lane and 2-lane
tombstones carry across in the reference's layout (uint32 lanes,
``fingerprints`` ``(D*M,)`` uint32 or None).

:func:`state_for_rank` turns a stacked state of D shards (the port's, or
the reference's through :func:`state_from_numpy`) into one rank's state of
a table over a process group: row ``r`` of every per-shard tensor, the
splits, ``num_dropped`` and the tombstones replicated.  Both backends then
read identical states, whatever built them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from typing import Sequence

from repro_torch.core.hashgraph import HashGraph
from repro_torch.core.multi_hashgraph import DistributedHashGraph
from repro_torch.core.state import TableState, Tombstones


def graph_from_numpy(
    *,
    offsets,
    keys,
    values,
    hash_splits,
    num_dropped,
    hash_range: int,
    seed: int,
    local_range_cap: int,
    bucket_stride: int = 1,
    fingerprints=None,
    device,
) -> DistributedHashGraph:
    """Port graph from the global arrays of a base ``DistributedHashGraph``.

    ``offsets`` is ``(D*(local_range_cap+2),)`` int32, ``keys`` ``(D*M,)``
    or ``(D*M, L)`` uint32, ``values`` ``(D*M,)`` or ``(D*M, C)`` int32,
    ``hash_splits`` ``(D+1,)``, ``fingerprints`` ``(D*M,)`` uint32 or None.
    """
    splits = np.asarray(hash_splits, dtype=np.int32)
    d = splits.shape[0] - 1
    offsets = np.asarray(offsets, dtype=np.int32).reshape(d, local_range_cap + 2)
    keys = np.asarray(keys, dtype=np.uint32)
    keys = keys.reshape(d, -1, *keys.shape[1:]).view(np.int32)
    values = np.asarray(values, dtype=np.int32)
    values = values.reshape(d, -1, *values.shape[1:])
    if fingerprints is not None:
        fingerprints = np.asarray(fingerprints, dtype=np.uint32).reshape(d, -1).view(np.int32)

    def dev(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return DistributedHashGraph(
        local=HashGraph(
            offsets=dev(offsets),
            keys=dev(keys),
            values=dev(values),
            table_size=int(local_range_cap),
            seed=int(seed),
            fingerprints=None if fingerprints is None else dev(fingerprints),
        ),
        hash_splits=dev(splits),
        num_dropped=torch.tensor(int(np.asarray(num_dropped)), device=device),
        hash_range=int(hash_range),
        seed=int(seed),
        local_range_cap=int(local_range_cap),
        bucket_stride=int(bucket_stride),
    )


def graph_to_numpy(graph: DistributedHashGraph) -> dict:
    """The graph's arrays in the global stacked layout, plus its metadata
    (``fingerprints`` only where the graph has the lane)."""

    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    keys, values, fp = (host(t) for t in (graph.local.keys, graph.local.values,
                                          graph.local.fingerprints))
    lane = {} if fp is None else {"fingerprints": fp.reshape(-1).view(np.uint32)}
    return {
        **lane,
        "offsets": host(graph.local.offsets).reshape(-1),
        "keys": keys.reshape(-1, *keys.shape[2:]).view(np.uint32),
        "values": values.reshape(-1, *values.shape[2:]),
        "hash_splits": host(graph.hash_splits),
        "num_dropped": int(graph.num_dropped),
        "hash_range": graph.hash_range,
        "seed": graph.seed,
        "local_range_cap": graph.local_range_cap,
        "bucket_stride": graph.bucket_stride,
    }


def state_from_numpy(
    *,
    base: dict,
    deltas: Sequence[dict],
    tombstones: dict,
    coherent: bool,
    table,
    device,
) -> TableState:
    """Port state from the arrays of a reference ``TableState``.

    ``base`` and each of ``deltas`` hold :func:`graph_from_numpy`'s keyword
    arguments; ``tombstones`` holds ``keys`` ``(T,)`` or ``(T, L)`` uint32, ``epochs`` and
    ``expires`` ``(T,)`` int32, and the scalars ``count``, ``num_dropped``
    and ``now``.  ``table`` is the port table the state will be read by.
    """
    ts_keys = np.asarray(tombstones["keys"], dtype=np.uint32).view(np.int32)

    def dev(a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)

    return TableState(
        base=graph_from_numpy(**base, device=device),
        deltas=tuple(graph_from_numpy(**g, device=device) for g in deltas),
        tombstones=Tombstones(
            keys=dev(ts_keys, np.int32),
            epochs=dev(tombstones["epochs"], np.int32),
            expires=dev(tombstones["expires"], np.int32),
            count=int(np.asarray(tombstones["count"])),
            num_dropped=int(np.asarray(tombstones["num_dropped"])),
            now=int(np.asarray(tombstones["now"])),
        ),
        table=table,
        coherent=bool(coherent),
    )


def graph_for_rank(graph: DistributedHashGraph, group, device=None) -> DistributedHashGraph:
    """Rank ``group.rank``'s graph of a stacked ``graph`` of ``group.size``
    shards: its row of ``offsets`` / ``keys`` / ``values`` /
    ``fingerprints`` as a leading axis of 1, on ``device`` (default: the
    graph's); ``hash_splits`` and ``num_dropped`` whole."""
    if graph.local.keys.shape[0] != group.size:
        raise ValueError(
            f"graph has {graph.local.keys.shape[0]} shards, the group {group.size}"
        )
    device = graph.hash_splits.device if device is None else device

    def mine(t):
        return None if t is None else group.rows(t).clone().to(device)

    loc = graph.local
    local = dataclasses.replace(loc, offsets=mine(loc.offsets), keys=mine(loc.keys),
                                values=mine(loc.values), fingerprints=mine(loc.fingerprints))
    return dataclasses.replace(graph, local=local, hash_splits=graph.hash_splits.clone().to(device),
                               num_dropped=graph.num_dropped.clone().to(device), group=group)


def state_for_rank(state: TableState, table) -> TableState:
    """Rank ``r``'s state of ``table`` (a ``DistributedHashTable`` over a
    process group) from a stacked ``state`` of as many shards: every layer
    through :func:`graph_for_rank`, the tombstone buffer replicated."""
    group, dev = table.group, table.device
    ts = state.tombstones
    return TableState(
        base=graph_for_rank(state.base, group, dev),
        deltas=tuple(graph_for_rank(g, group, dev) for g in state.deltas),
        tombstones=dataclasses.replace(ts, keys=ts.keys.clone().to(dev),
                                       epochs=ts.epochs.clone().to(dev),
                                       expires=ts.expires.clone().to(dev)),
        table=table,
        coherent=state.coherent,
    )


def state_to_numpy(state: TableState) -> dict:
    """The state's arrays in the reference's layout (inverse of
    :func:`state_from_numpy`, without the table)."""
    ts = state.tombstones
    return {
        "base": graph_to_numpy(state.base),
        "deltas": [graph_to_numpy(g) for g in state.deltas],
        "tombstones": {
            "keys": ts.keys.cpu().numpy().view(np.uint32),
            "epochs": ts.epochs.cpu().numpy(),
            "expires": ts.expires.cpu().numpy(),
            "count": ts.count,
            "num_dropped": ts.num_dropped,
            "now": ts.now,
        },
        "coherent": state.coherent,
    }
