#!/usr/bin/env python3
"""Time warm depth-6 retrieves and inner joins through a given copy of the port.

    python3 tools/gather_ab.py --src SRC [--shards 1] [--keys N] [--repeats 10] [--seed 0]

``SRC`` is the ``src`` directory of a checkout (this one, or an earlier
commit unpacked with ``git archive``); ``repro_torch`` is imported from
there, so two versions can be compared on one card by running the script
once for each, in turns (A, B, B, A).  The script builds the update state
of ``chip_smoke.py`` on the card from its seed and data (``--keys`` uint32
base keys, 2^27 / ``--shards`` by default, as ``chip_smoke.py`` runs D = 1
and D = 8; four inserts of N/32, the deletes, a fifth insert, the upsert:
depth 6, seven layers, coherent), then

- sizes the retrieve of the update run's N/32-key batch once (the counts
  round) and runs ``retrieve`` and ``inner_join`` at those capacities twice
  each to warm up and ``--repeats`` times, each synchronised on both sides,
  checking every repeat against the first;
- measures one more retrieve's peak device bytes above the resident state
  (``torch.cuda.max_memory_allocated``);
- profiles one more retrieve (``chip_smoke.profile_phases``): device
  time, wall and launches by kernel class for the whole call, and for the
  gather stage alone: the owner-side and querier-side gathers with the
  plain set-up around them, each call of the stage's functions of the port
  at ``SRC`` wrapped in a ``record_function`` range, whose device windows
  give the stage's device time and launches;
- where the port at ``SRC`` has the owner and querier entries, times each
  alone on the retrieve's own inputs (``chip_smoke.gather_inputs``; CUDA
  events, median of 5 groups of 20, [min, median, max]).

It prints the card's name and power limit and one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The gather stage's functions, by module, in either version of the port: the
# owner and querier gathers of the table's retrieve (the calls the retrieve
# makes at the top level, so no range holds another).
STAGE = {
    "multi_hashgraph": ("_owner_gather", "_querier_gather"),
    "ops": ("csr_gather_layers", "csr_gather_queriers"),
}
RANGE = "gather stage"


@contextlib.contextmanager
def stage_ranges():
    """Wrap the gather stage's functions in ``record_function(RANGE)``."""
    from torch.profiler import record_function

    from repro_torch.core import multi_hashgraph
    from repro_torch.kernels import ops

    saved = []
    for module in (multi_hashgraph, ops):
        for name in STAGE[module.__name__.rsplit(".", 1)[1]]:
            fn = getattr(module, name, None)
            if fn is None:
                continue

            @functools.wraps(fn)
            def ranged(*a, _fn=fn, **k):
                with record_function(RANGE):
                    return _fn(*a, **k)

            saved.append((module, name, fn))
            setattr(module, name, ranged)
    try:
        yield [f"{m.__name__}.{n}" for m, n, _ in saved]
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def profile_retrieve(fn, device) -> dict:
    import chip_smoke

    with stage_ranges() as wrapped:
        profiled = chip_smoke.profile_phases({"retrieve": fn}, device, window=RANGE)["retrieve"]
    profiled["window"]["functions"] = wrapped
    return profiled


def entry_times(table, state, batch, device):
    """The owner and querier entries alone on the retrieve's inputs (None
    for a port without them)."""
    import chip_smoke
    from repro_torch.kernels import csr_gather

    if not hasattr(csr_gather, "csr_gather_owners"):
        return None
    a = chip_smoke.gather_inputs(table, state, batch)
    o, q = a["csr_gather_owners"], a["csr_gather_queriers"]
    return chip_smoke.spread_ms({
        "csr_gather_owners": lambda: csr_gather.csr_gather_owners(
            o["starts"], o["counts"], o["tables"], o["capacity"]),
        "csr_gather_queriers": lambda: csr_gather.csr_gather_queriers(
            q["starts"], q["counts"], q["table"], q["capacity"]),
    }, device, groups=5, launches=20)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True)
    parser.add_argument("--shards", type=int, default=1)
    parser.add_argument("--keys", type=int, default=None)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gather_ab: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, REPO)
    import chip_smoke
    from repro_torch import DistributedHashTable

    card = chip_smoke.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    d = args.shards
    n_keys = args.keys or (1 << 27) // d
    _, dev = chip_smoke.update_data(n_keys, args.seed, device)
    table = DistributedHashTable(num_shards=d, hash_range=n_keys, device=device,
                                 tombstone_capacity=chip_smoke.TOMBSTONE_CAPACITY)
    state = chip_smoke.depth6_state(table, dev)
    batch = dev["batch"]
    seg_need, out_need = table.plan_caps(state, batch)
    caps = dict(out_capacity=out_need, seg_capacity=max(8, 1 << (seg_need - 1).bit_length()))
    calls = {
        "retrieve": (lambda: table.retrieve(state, batch, **caps),
                     lambda r: (r.offsets, r.values, r.counts, r.num_dropped)),
        "inner_join": (lambda: table.inner_join(state, batch, **caps),
                       lambda j: (j.query_idx, j.values, j.num_results, j.num_dropped)),
    }
    walls = {}
    for name, (fn, parts) in calls.items():
        walls[name], first = chip_smoke.repeat_walls(fn, device, args.repeats, parts, name)
        chip_smoke.check(int(first[-1]) == 0, f"{name} dropped {int(first[-1])}")
        del first
    peak = chip_smoke.peak_bytes(calls["retrieve"][0], device)
    profiled = profile_retrieve(calls["retrieve"][0], device)
    entries = entry_times(table, state, batch, device)
    print(json.dumps({
        "card": card, "src": args.src, "shards": d, "keys": n_keys,
        "retrieve_queries": int(batch.numel()), "caps": caps,
        "wall_ms": walls,
        "wall_ms_min_median_max": {k: [min(v), statistics.median(v), max(v)]
                                   for k, v in walls.items()},
        "retrieve_peak_bytes": peak,
        "profiled_retrieve": profiled,
        "entry_ms_min_median_max": entries,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
