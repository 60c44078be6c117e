#!/usr/bin/env python3
"""Time the stacked table server through a given copy of the port.

    python3 tools/serve_ab.py --src SRC [--keys 134217728] [--shards 1 8]
        [--batches 40] [--seed 0]

``SRC`` is the ``src`` directory of a checkout (this one, or an earlier
commit unpacked with ``git archive``); ``repro_torch`` is imported from
there, so two versions can be compared on one card by running the script
once for each, in turns (A, B, B, A).  For each ``--shards`` value D it
runs ``chip_smoke.run_serve_table`` (the serve-table phase: a warmed
``TableServer`` behind ``AsyncFrontend`` on ``--keys / D`` uint32 keys,
four readers, a retrieve thread and a writer, every response held against
the oracle), then, on a second warmed server of the same table with no
traffic, ``--batches`` back-to-back ``query_many`` calls of one 4096-key
batch, each synchronised: the read path's own time a batch, with no
queueing in front of it.

It prints the card's name and power limit and one JSON object per D: the
phase's latency p50 / p99, its tracer phases' p50, each bucket's batches
and read-stream ms p50, its traffic seconds, and the quiet batches' wall
ms (every call, and their min, median and max).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def quiet_batches(shards: int, n_keys: int, seed: int, batches: int, device) -> list:
    """Wall ms of ``batches`` synchronised 4096-key reads of a warmed,
    otherwise idle stacked server."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch import DistributedHashTable
    from repro_torch.serve_table import CompactionPolicy, MicroBatcher, TableServer

    rng = np.random.default_rng(seed + 17)
    keys = rng.integers(0, n_keys, size=n_keys, dtype=np.uint32)
    table = DistributedHashTable(num_shards=shards, hash_range=n_keys, device=device,
                                 tombstone_capacity=chip_smoke.SERVE_TOMBSTONES,
                                 capacity_slack=chip_smoke.SERVE_CAPACITY_SLACK)
    server = TableServer(table, keys, write_bucket=chip_smoke.SERVE_WRITE_BUCKET,
                         policy=CompactionPolicy(max_delta_depth=8, fold_k=2),
                         batcher=MicroBatcher(table, min_bucket=chip_smoke.SERVE_BUCKETS[0]))
    server.warm(buckets=(4096,), depths=range(1), fold_horizon=0)
    req = keys[rng.integers(0, n_keys, size=4096)]
    want = None
    walls = []
    for i in range(batches + 2):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        counts, _ = server.query_many([req])
        torch.cuda.synchronize(device)
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
        want = counts[0] if want is None else want
        if not np.array_equal(counts[0], want):
            raise AssertionError("a quiet batch returned other counts than the first")
    server.stop()
    return walls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True)
    parser.add_argument("--keys", type=int, default=1 << 27)
    parser.add_argument("--shards", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--batches", type=int, default=40)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import gc

    import torch

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, REPO)
    import chip_smoke

    card = chip_smoke.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    chip_smoke.run_path(1, 1 << 14, args.seed, device, lambda m: None)  # warm-up
    for shards in args.shards:
        n = args.keys // shards
        res = chip_smoke.run_serve_table(shards, n, args.seed, device, lambda m: None)["result"]
        gc.collect()
        torch.cuda.empty_cache()
        walls = quiet_batches(shards, n, args.seed, args.batches, device)
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({
            "card": card, "src": args.src, "shards": shards, "keys": n,
            "latency_ms": res["latency_ms"],
            "tracer_p50_ms": {k: v["p50_ms"] for k, v in res["tracer_phases"].items()},
            "by_bucket": {k: [v["batches"], v["device_ms_p50"]]
                          for k, v in res["by_bucket"].items()},
            "traffic_s": res["traffic_s"],
            "quiet_batch_ms": {"all": walls, "min": min(walls),
                               "median": statistics.median(walls), "max": max(walls)},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
