"""Block-shape autotuner for kernels 1-5 on the card (port of
``repro.kernels.autotune``).

Sweeps the ``block_rows`` candidates of each kernel wrapped by
:mod:`repro_torch.kernels.ops` (``common.CANDIDATES``: the tiles each
kernel was built for) and records the fastest per ``(kernel, backend, lane
width, log2-size bucket)``.  Winners live in an in-process cache consulted
by :func:`repro_torch.kernels.common.resolve_block_rows`, i.e. every
wrapper call that leaves ``block_rows=None``, and round-trip through a JSON
file so one sweep seeds later processes.  The wrappers resolve at every
launch, so a cache loaded later changes the next launch.

Usage (on the card)::

    from repro_torch.kernels import autotune
    autotune.autotune(sizes=(1 << 20, 1 << 24))  # sweep, fill the cache
    autotune.save_cache()                        # persist the winners
    # later, in another process
    autotune.load_cache()                        # the wrappers now launch tuned

Cache file format (version 1, the reference's)::

    {"version": 1,
     "entries": {"csr_gather|cuda|w2|b20": {
         "block_rows": 16, "best_ms": 0.41,
         "timings_ms": {"8": 0.52, "16": 0.41, "32": 0.47}, ...}}}

``REPRO_AUTOTUNE_CACHE`` names the default JSON path for save and load
(else ``autotune_cache.json`` in the working directory).  The backend in a
key is always ``"cuda"``: the kernels run nowhere else, and on the CPU the
plain twins have no geometry (the resolver still answers).

The sweep calls the public wrappers with an explicit ``block_rows``, so
timing never re-enters the resolver.  Its inputs are drawn on the card from
a seeded ``torch.Generator``, shaped as the reference's drivers shape them.
Each candidate is timed with CUDA events: one warm-up launch, then the
median of ``repeats`` launches (the reference takes the best of its wall
times).  Without a card the sweep raises; it never times a plain twin.
"""
from __future__ import annotations

import json
import os
import statistics
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import common

_ENV_CACHE = "REPRO_AUTOTUNE_CACHE"
_DEFAULT_FILE = "autotune_cache.json"
BACKEND = "cuda"
SEED = 0xA07

#: kernels the sweep knows how to drive: the resolver's keys.
KERNELS: Tuple[str, ...] = (
    "murmur",
    "bin_histogram",
    "bucket_probe",
    "csr_gather",
    "csr_gather_batched",
)

# In-process winner cache: key -> block_rows.  ``_details`` keeps the full
# sweep record per key for the JSON file.
_cache: Dict[str, int] = {}
_details: Dict[str, dict] = {}


def _size_bucket(n: int) -> int:
    """log2 bucket: sizes within a factor of 2 share one tuned shape."""
    return max(0, int(n) - 1).bit_length()


def _key(kernel: str, backend: str, width: int, bucket: int) -> str:
    return f"{kernel}|{backend}|w{width}|b{bucket}"


def cached_block_rows(
    kernel: str, *, n: Optional[int] = None, width: int = 1
) -> Optional[int]:
    """Tuned ``block_rows`` for a call, or None if nothing relevant is cached.

    Exact (kernel, backend, width, size-bucket) hit first; else the nearest
    size bucket tuned for the same kernel, backend and width.  Runs at every
    launch that leaves ``block_rows=None``, so the empty cache returns at
    once.
    """
    if not _cache or n is None:
        return None
    bucket = _size_bucket(n)
    hit = _cache.get(_key(kernel, BACKEND, width, bucket))
    if hit is not None:
        return hit
    prefix = f"{kernel}|{BACKEND}|w{width}|b"
    buckets = [int(k[len(prefix):]) for k in _cache if k.startswith(prefix)]
    if not buckets:
        return None
    nearest = min(buckets, key=lambda b: abs(b - bucket))
    return _cache[prefix + str(nearest)]


def clear_cache() -> None:
    """Drop all in-process winners (the JSON file is untouched)."""
    _cache.clear()
    _details.clear()


def _default_path() -> str:
    return os.environ.get(_ENV_CACHE, _DEFAULT_FILE)


def save_cache(path: Optional[str] = None) -> str:
    """Write the in-process winners to the JSON file; returns the path."""
    path = path or _default_path()
    entries = {}
    for key, br in sorted(_cache.items()):
        entries[key] = _details.get(key, {"block_rows": int(br)})
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_cache(path: Optional[str] = None) -> int:
    """Merge winners from the JSON file; returns the entries loaded.  A
    missing file loads nothing (0), so a process may load at start-up and
    fall back to ``common.DEFAULT_BLOCK_ROWS``."""
    path = path or _default_path()
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        blob = json.load(f)
    entries = blob.get("entries", {})
    for key, rec in entries.items():
        _cache[key] = int(rec["block_rows"])
        _details[key] = dict(rec)
    return len(entries)


# ---------------------------------------------------------------------------
# Sweep drivers: inputs drawn on the card, the public wrapper called with an
# explicit block_rows.  n is the resolver's dominant size for the kernel.
# ---------------------------------------------------------------------------
def _words(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform 32-bit words (int32 bit patterns) on the card."""
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=gen, device=device)


def _driver(kernel: str, n: int, width: int, device):
    """A function of ``block_rows`` that launches ``kernel`` once on inputs
    of size ``n`` and ``width`` lanes or columns (the reference's shapes:
    murmur keys into ``max(8, n)`` buckets, 256 histogram bins, windows of 8
    keys over a sorted table, runs of 8 rows gathered into ``n`` slots, 4
    sources for the batched gather)."""
    from repro_torch.kernels import murmur, ops

    gen = torch.Generator(device=device).manual_seed(SEED)
    if kernel == "murmur":
        if width == 1:
            keys = _words(gen, (n,), device)
            return lambda br: ops.hash_to_buckets(keys, max(8, n), block_rows=br)
        keys = _words(gen, (n, width), device)
        return lambda br: murmur.murmur_hash(keys, max(8, n), lanes=width, fingerprint=True,
                                             block_rows=br)
    if kernel == "bin_histogram":
        num_bins = 256
        bins = torch.randint(0, num_bins, (n,), dtype=torch.int32, generator=gen, device=device)
        return lambda br: ops.bin_histogram(bins, num_bins, block_rows=br)
    if kernel == "bucket_probe":
        nv = max(8, n // 8)
        shape = (n,) if width == 1 else (n, width)
        table = _words(gen, shape, device)
        if width == 1:
            table = torch.sort(table).values
        edges = torch.linspace(0, n, nv + 1, device=device).to(torch.int32)
        b = torch.randint(0, nv, (n,), dtype=torch.int64, generator=gen, device=device)
        starts, ends = edges[b], edges[b + 1]
        queries = _words(gen, shape, device)
        return lambda br: ops.bucket_probe(table, starts, ends, queries, block_rows=br)
    if kernel in ("csr_gather", "csr_gather_batched"):
        run = 8
        shape = (n,) if width == 1 else (n, width)
        table = torch.randint(0, 2**31 - 1, shape, dtype=torch.int32, generator=gen,
                              device=device)
        if kernel == "csr_gather":
            rows = max(1, n // run)
            starts = torch.arange(rows, dtype=torch.int32, device=device) * run
            counts = torch.full((rows,), run, dtype=torch.int32, device=device)
            return lambda br: ops.csr_gather(starts, counts, table, capacity=n, block_rows=br)
        s_dim = 4
        rows = max(1, n // (run * s_dim))
        starts = (torch.arange(rows, dtype=torch.int32, device=device) * run)[None].repeat(
            s_dim, 1)
        counts = torch.full((s_dim, rows), run, dtype=torch.int32, device=device)
        return lambda br: ops.csr_gather_batched(starts, counts, table, capacity=rows * run,
                                                 block_rows=br)
    raise ValueError(f"unknown kernel {kernel!r} (one of {KERNELS})")


def _time(fn, repeats: int) -> float:
    """Median of ``repeats`` launches in ms by CUDA events, after one warm-up."""
    fn()
    pairs = []
    for _ in range(max(1, repeats)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _card(device) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the autotuner times the CUDA kernels and needs a card")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"the autotuner runs on a CUDA device, not {dev}")
    return dev


def sweep_kernel(
    kernel: str,
    *,
    n: int,
    width: int = 1,
    candidates: Optional[Sequence[int]] = None,
    repeats: int = 5,
    device=None,
) -> dict:
    """Time every ``block_rows`` candidate (default: all the kernel has) for
    one kernel, size and width on the card.

    Stores the winner in the in-process cache (keyed by the backend and the
    log2 size bucket of ``n``) and returns the record::

        {"key": ..., "block_rows": 16, "best_ms": ..., "timings_ms": {...},
         "n": n, "width": width}
    """
    dev = _card(device)
    cands = common.CANDIDATES[kernel] if candidates is None else tuple(candidates)
    call = _driver(kernel, int(n), int(width), dev)
    timings = {}
    with torch.cuda.device(dev):
        for cand in cands:
            timings[str(int(cand))] = _time(lambda c=cand: call(int(c)), repeats)
    winner = min(timings, key=timings.get)
    key = _key(kernel, BACKEND, width, _size_bucket(n))
    record = {
        "key": key,
        "block_rows": int(winner),
        "best_ms": timings[winner],
        "timings_ms": timings,
        "n": int(n),
        "width": int(width),
    }
    _cache[key] = int(winner)
    _details[key] = record
    return record


def autotune(
    kernels: Sequence[str] = KERNELS,
    *,
    sizes: Sequence[int] = (1 << 16, 1 << 20),
    widths: Sequence[int] = (1, 2),
    candidates: Optional[Sequence[int]] = None,
    repeats: int = 5,
    device=None,
    save: bool = False,
) -> list:
    """Sweep the kernel x size x width grid; optionally persist the file.

    ``widths`` fans out only the gathers (murmur, the histogram and the
    probe take one lane here, as in the reference).  Returns every sweep
    record; winners enter the cache as they are measured.
    """
    records = []
    for kernel in kernels:
        kwidths = widths if kernel.startswith("csr_gather") else (1,)
        for n in sizes:
            for width in kwidths:
                records.append(sweep_kernel(kernel, n=int(n), width=int(width),
                                            candidates=candidates, repeats=repeats,
                                            device=device))
    if save:
        save_cache()
    return records
