#!/usr/bin/env python3
"""Time warm stacked retrieves with and without per-layer counts through a
given copy of the port.

    python3 tools/layer_counts_ab.py --src SRC [--shards 4] [--keys 67108864]
        [--queries 16777216] [--repeats 10] [--seed 0]

``SRC`` is the ``src`` directory of a checkout (this one, or an earlier
commit unpacked with ``git archive``); ``repro_torch`` is imported from
there, so two versions can be compared on one card by running the script
once for each, in turns (A, B, B, A).  The script builds, on the card and
from ``--seed`` with numpy, a stacked table of ``--shards`` shards and
``--keys`` uint32 keys (uniform over half the key count) with two coherent
inserts of N/8 each (three layers), then times ``retrieve`` of
``--queries`` of the base keys with ``per_layer_counts=True`` and without,
two warm-up calls and ``--repeats`` timed calls each, every call
synchronised on both sides and checked to return the first call's counts
(and per-layer counts).  The difference between the two medians is what
the per-layer planes cost: their owner-side counting and their way home in
the retrieve's exchange.

It prints the card's name and power limit and one JSON object: the wall ms
of every repeat of each case, their min, median and max, and the
difference of the medians.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True)
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--keys", type=int, default=1 << 26)
    parser.add_argument("--queries", type=int, default=1 << 24)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("layer_counts_ab: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, REPO)
    import chip_smoke
    from repro_torch import DistributedHashTable

    card = chip_smoke.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    n, half = args.keys, args.keys // 2
    keys = rng.integers(0, half, size=n, dtype=np.uint32)
    inserts = [rng.integers(0, half, size=n // 8, dtype=np.uint32) for _ in range(2)]
    queries = keys[rng.integers(0, n, size=args.queries)]
    table = DistributedHashTable(num_shards=args.shards, hash_range=n, device=device)
    state = table.init(keys)
    for batch in inserts:
        state = table.insert(state, batch)
    chip_smoke.sync(device)
    out = {"card": card, "src": args.src, "shards": args.shards, "keys": n,
           "queries": args.queries, "layers": len(state.layers)}
    for name, per_layer in (("plain", False), ("per_layer_counts", True)):
        def retrieve(per_layer=per_layer):
            return table.retrieve(state, queries, per_layer_counts=per_layer)

        def parts(r, per_layer=per_layer):
            return (r.counts, r.layer_counts) if per_layer else (r.counts,)

        walls, _ = chip_smoke.repeat_walls(retrieve, device, args.repeats, parts, name)
        out[name] = {"wall_ms": walls,
                     "wall_ms_min_median_max": [min(walls), statistics.median(walls), max(walls)]}
    out["per_layer_minus_plain_ms"] = (out["per_layer_counts"]["wall_ms_min_median_max"][1]
                                       - out["plain"]["wall_ms_min_median_max"][1])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
