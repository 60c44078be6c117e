#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check every result.

    python3 chip_smoke.py [--keys 134217728] [--seed 0] [--profile]
                          [--out results.json]

Run from the root of a checkout: it builds the port's CUDA kernels from
``src/repro_torch/csrc`` and then

1. runs the table's build -> query -> retrieve -> inner_join path through the
   public API, with D = 1 shard at N = 2^27 uint32 keys (uniform in [0, N),
   so keys repeat; ``hash_range = N``), then with D = 8 stacked shards at
   N / 8 = 2^24; each run is checked against a numpy oracle (counts, every
   retrieved value multiset, every join pair, ``num_dropped == 0``, exactly
   two exchange calls per retrieve and per join) and reports build keys/s,
   query keys/s and retrieve results/s;
2. counts the kernel launches of each run (every count is set to 0 just
   before a run and read just after it) and requires each kernel > 0;
3. calls each kernel's wrapper on the inputs each run gives it (at D = 8 the
   batched gather of one owner over its 8 sources and the gather of one
   querier), requires ``torch.equal`` with its plain PyTorch twin
   (tolerance: none, every output is an integer), and times kernel, plain
   twin and (for the histogram) ``torch.bincount`` with CUDA events beside
   the least time the card could take: the larger of the bytes moved over
   3.35 TB/s and the integer operations over the card's int32 rate.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line (one
row per kernel and run, ``shards`` naming the run) and, last,
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# int32 operations outside the tensor cores: 64 INT32 lanes per SM x 132 SMs
# x 1.98 GHz boost clock (H100 SXM).  Not half the 67 TFLOP/s float32 rate:
# that counts each fused multiply-add as two operations.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
ABSENT_QUERIES = 1 << 20
RETRIEVE_QUERIES = 1 << 22

# Kernel name -> (source in the repo, Pallas function it replaces).
KERNELS = {
    "murmur_bucket": ("src/repro_torch/csrc/murmur.cu", "src/repro/kernels/murmur.py:53"),
    "bin_histogram": ("src/repro_torch/csrc/histogram.cu", "src/repro/kernels/histogram.py:41"),
    "csr_gather": ("src/repro_torch/csrc/csr_gather.cu", "src/repro/kernels/bucket_probe.py:161"),
    "csr_gather_batched": (
        "src/repro_torch/csrc/csr_gather.cu",
        "src/repro/kernels/bucket_probe.py:206",
    ),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mean_ms(fn, reps: int, device) -> float:
    """Mean time of ``fn`` over ``reps`` calls after two warm-up calls
    (CUDA events on the card)."""
    import torch

    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn, device):
    """``(result, seconds)`` of one call, synchronised on both sides."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


class Oracle:
    """numpy reference of a multiset table whose value is the global row id.

    Keys are drawn from ``[0, n)``, so per-value counts come from
    ``np.bincount`` and the rows of each value from a stable argsort; a
    query outside ``[0, n)`` counts 0.  (A binary search per query over
    2^27 sorted keys would take minutes on the host.)
    """

    def __init__(self, keys, n: int):
        import numpy as np

        self.counts = np.bincount(keys, minlength=n)
        self.first = np.cumsum(self.counts) - self.counts
        self.order = np.argsort(keys, kind="stable")

    def runs(self, queries):
        """``(first sorted row, count)`` of every query."""
        import numpy as np

        inside = queries < self.counts.shape[0]
        q = np.where(inside, queries, 0)
        return np.where(inside, self.first[q], 0), np.where(inside, self.counts[q], 0)

    def pairs(self, queries):
        """Every ``(query row, value)`` match, sorted."""
        import numpy as np

        lo, cnt = self.runs(queries)
        qidx = np.repeat(np.arange(queries.shape[0], dtype=np.int64), cnt)
        first = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
        vals = self.order[first + np.arange(qidx.shape[0])]
        return sort_pairs(qidx, vals)


def sort_pairs(qidx, vals):
    import numpy as np

    key = np.lexsort((vals, qidx))
    return np.stack([qidx[key], vals[key]], axis=1).astype(np.int64)


def retrieval_pairs(result):
    """``(query row, value)`` of every retrieved value, sorted."""
    import numpy as np

    from repro_torch import retrieval_to_lists

    lists = retrieval_to_lists(result)
    lens = np.fromiter(map(len, lists), dtype=np.int64, count=len(lists))
    qidx = np.repeat(np.arange(len(lists), dtype=np.int64), lens)
    return sort_pairs(qidx, np.concatenate(lists).astype(np.int64))


def run_path(n_shards: int, n_keys: int, seed: int, device, log) -> dict:
    """One build -> query -> retrieve -> inner_join run through the public API."""
    import numpy as np
    import torch

    from repro_torch import DistributedHashTable, join_to_pairs
    from repro_torch.core import exchange
    from repro_torch.kernels import build

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, size=n_keys, dtype=np.uint32)
    absent = rng.integers(n_keys, 2**32 - 1, size=ABSENT_QUERIES, dtype=np.uint64).astype(np.uint32)
    queries = np.concatenate([keys, absent])
    batch = rng.integers(0, n_keys, size=RETRIEVE_QUERIES, dtype=np.uint32)
    keys_dev = torch.from_numpy(keys.view(np.int32)).to(device)
    queries_dev = torch.from_numpy(queries.view(np.int32)).to(device)
    batch_dev = torch.from_numpy(batch.view(np.int32)).to(device)
    table = DistributedHashTable(num_shards=n_shards, hash_range=n_keys, device=device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    build.LAUNCHES.clear()
    exchange.CALLS.clear()
    state, build_s = wall(lambda: table.init(keys_dev), device)
    calls_build = dict(exchange.CALLS)
    exchange.CALLS.clear()
    counts, query_s = wall(lambda: table.query(state, queries_dev), device)
    calls_query = dict(exchange.CALLS)
    exchange.CALLS.clear()
    retrieval, retrieve_s = wall(lambda: table.retrieve(state, batch_dev), device)
    calls_retrieve = dict(exchange.CALLS)
    exchange.CALLS.clear()
    join = table.inner_join(state, batch_dev)
    calls_join = dict(exchange.CALLS)
    join_size = int(table.join_size(state, batch_dev))
    sync(device)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    oracle = Oracle(keys, n_keys)
    _, want_counts = oracle.runs(queries)
    check(int(state.num_dropped) == 0, f"D={n_shards}: build dropped {int(state.num_dropped)} rows")
    check(np.array_equal(counts.cpu().numpy(), want_counts), f"D={n_shards}: query counts differ")
    want_pairs = oracle.pairs(batch)
    total = want_pairs.shape[0]
    check(int(retrieval.num_dropped) == 0, f"D={n_shards}: retrieve dropped {int(retrieval.num_dropped)}")
    _, batch_counts = oracle.runs(batch)
    check(np.array_equal(retrieval.counts.cpu().numpy(), batch_counts), f"D={n_shards}: retrieve counts differ")
    check(np.array_equal(retrieval_pairs(retrieval), want_pairs),
          f"D={n_shards}: retrieved value multisets differ from the oracle")
    check(int(join.num_dropped) == 0, f"D={n_shards}: join dropped {int(join.num_dropped)}")
    got = join_to_pairs(join).astype(np.int64)
    check(np.array_equal(sort_pairs(got[:, 0], got[:, 1]), want_pairs), f"D={n_shards}: join pairs differ")
    check(join_size == total == int(batch_counts.sum()), f"D={n_shards}: join_size {join_size} != {total}")
    check(calls_build == {"exchange": 1}, f"D={n_shards}: build exchange calls {calls_build}")
    check(calls_query == {"exchange": 2}, f"D={n_shards}: query exchange calls {calls_query}")
    for name, calls in (("retrieve", calls_retrieve), ("inner_join", calls_join)):
        check(calls == {"exchange": 2, "plan_caps": 1},
              f"D={n_shards}: {name} exchange calls {calls}, want 2 plus the sizing round")
    for name in KERNELS if device.type == "cuda" else ():
        check(launches.get(name, 0) > 0, f"D={n_shards}: kernel {name} never launched")

    res = {
        "shards": n_shards,
        "keys": n_keys,
        "queries": int(queries.shape[0]),
        "retrieve_queries": RETRIEVE_QUERIES,
        "retrieved_values": total,
        "build_s": build_s,
        "query_s": query_s,
        "retrieve_s": retrieve_s,
        "build_keys_per_s": n_keys / build_s,
        "query_keys_per_s": queries.shape[0] / query_s,
        "retrieve_results_per_s": total / retrieve_s,
        "exchange_calls": {"build": calls_build, "query": calls_query, "retrieve": calls_retrieve, "inner_join": calls_join},
        "launches": launches,
        "peak_bytes": peak,
    }
    log(f"path D={n_shards} N={n_keys}: " + json.dumps(res))
    return {"result": res, "table": table, "state": state, "keys": keys_dev,
            "queries": queries_dev, "batch": batch_dev}


def profile_phases(run: dict, device) -> dict:
    """Device time by operation for one more build, query and retrieve of a
    run (``torch.profiler``), with the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    table, state = run["table"], run["state"]
    phases = {
        "build": lambda: table.init(run["keys"]),
        "query": lambda: table.query(state, run["queries"]),
        "retrieve": lambda: table.retrieve(state, run["batch"]),
    }
    out = {}
    for phase, fn in phases.items():
        sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, seconds = wall(fn, device)
        # Kernel rows only: operator rows repeat the device time of their kernels.
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
        out[phase] = {
            "wall_ms": seconds * 1e3,
            "device_busy_ms": busy_ms,
            "top": [[e.key, e.self_device_time_total / 1e3, e.count] for e in top],
        }
    return out


def kernel_inputs(run: dict) -> dict:
    """Each kernel's inputs as the run's path hands them over: the sharded
    keys to murmur and histogram (build phase 1), and from the retrieve of
    the query batch owner 0's batched gather (one source per shard) and
    querier 0's gather."""
    import torch

    from repro_torch.core import exchange, partition
    from repro_torch.core import multi_hashgraph as mh
    from repro_torch.kernels import murmur, ops

    table, state = run["table"], run["state"]
    base, d = state.base, table.num_shards
    keys = run["keys"].reshape(d, -1)
    n = keys.numel()
    h = murmur.murmur_bucket(keys, table.hash_range, table.seed)
    num_bins = table.num_bins or partition.choose_num_bins(table.hash_range, d)
    bsz = partition.bin_size_for(table.hash_range, num_bins)
    bins = torch.clamp(torch.div(h, bsz, rounding_mode="floor"), 0, num_bins - 1).to(torch.int32)
    del h
    q = run["batch"].reshape(d, -1)
    out_cap, seg_cap = table._resolve_caps(state, q, None, None)
    routed = mh._route_queries_once(base, q, table.capacity_slack)
    starts_lr, counts_lr, tables = mh._layer_run_descriptors((base,), routed)
    cap = routed.capacity

    def owner_runs(o):
        """Owner ``o``'s (L=1, S=D, R) run descriptors and its table."""
        return (starts_lr[:, o].reshape(1, d, cap), counts_lr[:, o].reshape(1, d, cap),
                (tables[0][o],))

    starts_i, counts_i, table_cat = ops.interleave_layer_runs(*owner_runs(0))
    segs = torch.stack([ops.csr_gather_layers(*owner_runs(o), capacity=seg_cap)[0] for o in range(d)])
    counts, starts, seg_flat = exchange.combine_ragged(segs, counts_lr.sum(0), routed.route)
    return {
        "murmur_bucket": dict(keys=keys, table_size=table.hash_range, seed=table.seed, n=n),
        "bin_histogram": dict(bins=bins, num_bins=num_bins),
        "csr_gather_batched": dict(
            offsets=ops.run_offsets(counts_i), starts=starts_i, table=table_cat, capacity=seg_cap
        ),
        "csr_gather": dict(
            offsets=ops.run_offsets(counts[0]), starts=starts[0], table=seg_flat[0], capacity=out_cap
        ),
    }


def gather_work(offsets, starts, capacity: int) -> tuple[int, int]:
    """``(bytes, int32 ops)`` a CSR gather needs on these inputs: offsets and
    starts read once, the table words the valid slots select, two int32
    written per slot; each valid slot bisects ``bit_length(N + 1)`` levels
    at 3 operations (midpoint, compare, select) plus 8 for the address."""
    import torch

    totals = offsets[..., -1].to(torch.int64)
    picked = int(torch.clamp(totals, max=capacity).sum())
    slots = capacity * (offsets.shape[0] if offsets.ndim == 2 else 1)
    nbytes = 4 * (offsets.numel() + starts.numel() + picked) + 8 * slots
    levels = (offsets.shape[-1]).bit_length()
    return nbytes, picked * (3 * levels + 8) + 2 * slots


def check_kernels(run: dict, device, log) -> list:
    """Each kernel against its plain twin on the run's own card inputs,
    timed; the launch counts of the run are reported beside."""
    import torch

    from repro_torch.kernels import csr_gather, histogram, murmur

    inputs = kernel_inputs(run)
    shards, launches = run["result"]["shards"], run["result"]["launches"]
    rows = []

    def record(name, shapes, kernel_fn, plain_fn, work, library_fn=None, reps=20):
        nbytes, nops = work
        bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": nops / INT32_OPS_PER_S * 1e3}
        bound_by = max(bounds, key=bounds.get)
        got, want = kernel_fn(), plain_fn()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        sync(device)
        for a, b in zip(got, want):
            check(a.shape == b.shape and torch.equal(a, b), f"kernel {name} differs from its plain twin")
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
                  for a, b in zip(got, want))
        del got, want
        row = {
            "name": name,
            "shards": shards,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "max_abs_err": err,
            "ms": mean_ms(kernel_fn, reps, device),
            "plain_ms": mean_ms(plain_fn, 3, device),
            "bound_ms": bounds[bound_by],
            "bound_by": bound_by,
            "library_ms": mean_ms(library_fn, reps, device) if library_fn else None,
            "launches": launches.get(name, 0),
        }
        log(f"kernel {name} D={shards} {shapes}: equal=True kernel_ms={row['ms']} plain_ms={row['plain_ms']} "
            f"library_ms={row['library_ms']} bound_ms={row['bound_ms']} ({bound_by}) "
            f"launches={row['launches']}")
        rows.append(row)

    a = inputs["murmur_bucket"]
    record(
        "murmur_bucket", f"keys={tuple(a['keys'].shape)} int32 -> int32 of the same shape",
        lambda: murmur.murmur_bucket(a["keys"], a["table_size"], a["seed"]),
        lambda: murmur.murmur_bucket_plain(a["keys"], a["table_size"], a["seed"]),
        (8 * a["n"], 22 * a["n"]),  # 5 multiplies, 2 rotates, 3 shift-xors, mod, ...
    )
    a = inputs["bin_histogram"]
    bins = a["bins"]
    record(
        "bin_histogram", f"bins={tuple(bins.shape)} int32 -> ({a['num_bins']},) int32",
        lambda: histogram.bin_histogram(bins, a["num_bins"]),
        lambda: histogram.bin_histogram_plain(bins, a["num_bins"]),
        (4 * bins.numel() + 4 * a["num_bins"], 3 * bins.numel()),  # 2 compares, 1 atomic
        library_fn=(lambda: torch.bincount(bins.reshape(-1), minlength=a["num_bins"]))
        if bool((bins >= 0).all()) else None,
    )
    for name, fn in (("csr_gather_batched", csr_gather.csr_gather_batched_2d),
                     ("csr_gather", csr_gather.csr_gather_2d)):
        a = inputs[name]
        record(
            name,
            f"offsets={tuple(a['offsets'].shape)} starts={tuple(a['starts'].shape)} "
            f"table={tuple(a['table'].shape)} capacity={a['capacity']}",
            lambda fn=fn, a=a: fn(a["offsets"], a["starts"], a["table"], a["capacity"]),
            lambda a=a: csr_gather.gather_plain(a["offsets"], a["starts"], a["table"], a["capacity"]),
            gather_work(a["offsets"], a["starts"], a["capacity"]),
        )
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--keys", type=int, default=1 << 27,
                        help="N of the D = 1 run; the D = 8 run takes N / 8")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="also write the results as JSON here")
    parser.add_argument("--profile", action="store_true",
                        help="also profile one more build, query and retrieve of the D = 1 run")
    args = parser.parse_args(argv)

    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        print("chip_smoke: run from the root of a checkout (src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def log(msg):
        print(msg, flush=True)

    t0 = time.perf_counter()
    build.library()
    log(f"kernels built from {build.CSRC} in {time.perf_counter() - t0:.1f} s")
    run_path(1, 1 << 14, args.seed, device, lambda m: None)  # warm-up at a small size

    run1 = run_path(1, args.keys, args.seed, device, log)
    rows = check_kernels(run1, device, log)
    profiled = profile_phases(run1, device) if args.profile else None
    if profiled:
        log("profile D=1: " + json.dumps(profiled))
    paths = [run1["result"]]
    del run1
    run8 = run_path(8, args.keys // 8, args.seed, device, log)
    rows += check_kernels(run8, device, log)
    paths.append(run8["result"])
    kernels = {"kernels": [{k: row[k] for k in (
        "name", "shards", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for row in rows]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "paths": paths,
                       "profile": profiled, **kernels}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
