#!/usr/bin/env python3
"""Time warm depth-6 probe queries through a given copy of the port.

    python3 tools/probe_ab.py --src SRC [--keys 134217728] [--repeats 10] [--seed 0]

``SRC`` is the ``src`` directory of a checkout (this one, or an earlier
commit unpacked with ``git archive``); ``repro_torch`` is imported from
there, so two versions can be compared on one card by running the script
once for each, in turns (A, B, B, A).  The script builds the D = 1 update
state of ``chip_smoke.py`` on the card from its seed and data (``--keys``
uint32 base keys, four inserts of N/32, 2^16 deletes, a fifth insert, a
2^16-key upsert: depth 6, seven layers) through a
``paper_faithful_probe=True`` table, then

- runs the probe query of every base key plus 2^20 absent ones (the
  public ``query``) twice to warm up and ``--repeats`` times, each
  synchronised on both sides, and checks that every repeat returns the
  first one's counts;
- times the same query over the stack's first 1, 4 and 7 layers (the fused
  layered query the table runs) for the per-layer slope, median of
  ``--repeats`` each;
- measures one more depth-6 query's peak device bytes above the resident
  state (``torch.cuda.max_memory_allocated``);
- profiles one more depth-6 query (``torch.profiler``: device time and
  launches by kernel class, as ``chip_smoke.py --profile`` splits them);
- where the port at ``SRC`` has kernel 5's layer entry, times its launch
  on each layer of the query (CUDA events, median of 5 groups of 5) as the
  query runs it, with every slot masked (the streamed slot arrays alone)
  and with ``max_probe`` 0 (the slot arrays and the offsets pairs, no
  window word).

It prints the card's name and power limit and one JSON object: the wall ms
of every repeat with their min, median and max, the medians by depth and
their slope, the query's peak bytes, the profiled call's wall, device busy
ms, per-class ms and launches and its largest kernels, and the per-layer
launch times (null for a port without the layer entry).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def layer_launches(state, probe, queries, device):
    """Each layer's kernel 5 launch as the depth-6 query makes it, alone, all
    masked and with ``max_probe`` 0: ``{layer: {case: [min, median, max] ms}}``
    (None where the port has no layer entry)."""
    import torch

    import chip_smoke
    from repro_torch.core import multi_hashgraph as mh
    from repro_torch.kernels import bucket_probe

    if not hasattr(bucket_probe, "bucket_probe_layer"):
        return None
    routed = mh._route_queries_once(state.base, queries.reshape(1, -1), probe.capacity_slack)
    match_e = mh._tombstone_epochs(routed.rq, state.tombstones.index())
    total = torch.zeros_like(routed.rq)
    out = {}
    for epoch, layer in enumerate(state.layers):
        def launch(epoch=epoch, layer=layer, max_probe=probe.max_probe, mask_at=None):
            return lambda: bucket_probe.bucket_probe_layer(
                routed.rq, routed.rh, routed.lo, match_e, layer.local.offsets,
                layer.local.keys, table_size=layer.local_range_cap, stride=layer.bucket_stride,
                epoch=epoch if mask_at is None else mask_at, max_probe=max_probe, total=total,
                accumulate=epoch > 0)
        # match_e >= -1 everywhere, so epoch -1 masks every slot.
        out[epoch] = chip_smoke.spread_ms(
            {"launch": launch(), "all_masked": launch(mask_at=-1), "max_probe_0": launch(max_probe=0)},
            device, groups=5, launches=5)
        out[epoch]["offsets_bytes"] = layer.local.offsets.numel() * 4
        out[epoch]["keys_bytes"] = layer.local.keys.numel() * 4
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True)
    parser.add_argument("--keys", type=int, default=1 << 27)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, REPO)
    import chip_smoke
    from repro_torch import DistributedHashTable
    from repro_torch.core import multi_hashgraph as mh

    card = chip_smoke.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    _, dev = chip_smoke.update_data(args.keys, args.seed, device)
    probe = DistributedHashTable(num_shards=1, hash_range=args.keys, device=device,
                                 tombstone_capacity=chip_smoke.TOMBSTONE_CAPACITY,
                                 paper_faithful_probe=True)
    state = chip_smoke.depth6_state(probe, dev)
    queries = dev["queries"]

    def query():
        return probe.query(state, queries)

    def query_layers(k):
        return lambda: mh.query_layers_sharded(
            state.layers[:k], queries.reshape(1, -1), tombstones=state.tombstones.index(),
            fused=True, paper_faithful_probe=True, max_probe=probe.max_probe)

    walls, _ = chip_smoke.repeat_walls(query, device, args.repeats, lambda c: (c,), "query")
    by_depth = {}
    for k in (1, 4, 7):
        fn = query_layers(k)
        fn()
        by_depth[k] = statistics.median(
            chip_smoke.wall(fn, device)[1] * 1e3 for _ in range(args.repeats))
    peak = chip_smoke.peak_bytes(query, device)
    profiled = chip_smoke.profile_phases({"probe query (depth 6)": query}, device)
    profiled = profiled["probe query (depth 6)"]
    print(json.dumps({
        "card": card, "src": args.src, "keys": args.keys, "queries": int(queries.numel()),
        "wall_ms": walls,
        "wall_ms_min_median_max": [min(walls), statistics.median(walls), max(walls)],
        "keys_per_s_at_median": queries.numel() / statistics.median(walls) * 1e3,
        "median_ms_by_layers": by_depth,
        "ms_per_layer": (by_depth[7] - by_depth[1]) / 6,
        "query_peak_bytes": peak,
        "profiled_launches": sum(v["launches"] for v in profiled["by_class"].values()),
        "profiled": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "by_class", "top")},
        "layer_launch_ms": layer_launches(state, probe, queries, device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
