#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on the card, profiling
their host side.

    python3 tools/phase_profile.py [--phases update,update-u64x4,procs,lm-procs]
                                   [--keys N] [--seed 0] [--top 30] [--no-profile]
                                   [--out FILE]

From the root of a checkout: builds the port's kernels, warms up as
``chip_smoke.main`` does, then runs each named phase once under
``cProfile`` (``update`` and ``update-u64x4`` at D = 1 with their kernel
checks; ``procs``, ``lm-procs``, ``archs-procs`` and ``moe-train`` whole,
with their gates; the last two also profile rank 0's card with
``torch.profiler``).  For each phase it prints the wall, the seconds spent
inside each of the script's own functions (cumulative: the oracles, data
making, the kernel checks, the spawned ranks' wait) and the functions
with the most time of their own.  The spawned ranks' own work is not in
the profile: it shows as the wait in ``mesh.spawn``.  ``--no-profile``
runs the phases without ``cProfile`` (their walls and logs only).  The
card's name and power limit go beside every wall.
"""
from __future__ import annotations

import argparse
import cProfile
import gc
import json
import os
import pstats
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split(prof: cProfile.Profile, top: int) -> dict:
    """The profile's script functions by cumulative seconds, and every
    function by its own seconds."""
    stats = pstats.Stats(prof).stats
    script = os.path.join(REPO, "chip_smoke.py")
    ours, own = [], []
    for (path, line, name), (_, calls, tt, ct, _) in stats.items():
        where = f"{os.path.relpath(path, REPO) if path.startswith(REPO) else path}:{line}:{name}"
        if path == script:
            ours.append((where, calls, round(ct, 3)))
        own.append((where, calls, round(tt, 3)))
    ours.sort(key=lambda r: -r[2])
    own.sort(key=lambda r: -r[2])
    return {"script_cumulative_s": ours[:top], "own_s": own[:top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="update,update-u64x4,procs,lm-procs")
    ap.add_argument("--keys", type=int, default=1 << 27)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "src")]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("phase_profile: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    chip_smoke.lm_settings()
    smi = chip_smoke.card_line()
    print(smi, flush=True)
    build.library()
    chip_smoke.run_path(1, 1 << 14, args.seed, device, lambda m: None)
    chip_smoke.run_update_path(8, 1 << 17, args.seed, device, lambda m: None, skew=False)
    quiet = lambda m: None  # noqa: E731

    def table(wide):
        def go():
            run = chip_smoke.run_update_path(1, args.keys, args.seed, device, quiet, wide=wide)
            chip_smoke.check_kernels(run, device, quiet)
        return go

    runners = {
        "update": table(False),
        "update-u64x4": table(True),
        "procs": lambda: chip_smoke.run_procs(args.seed, device, quiet),
        "lm-procs": lambda: chip_smoke.run_lm_procs(args.seed, device, print),
        "archs-procs": lambda: chip_smoke.run_archs_procs(args.seed, device, print,
                                                          profile=not args.no_profile),
        "moe-train": lambda: chip_smoke.run_moe_train(args.seed, device, print,
                                                      profile=not args.no_profile),
    }
    out = {"card": smi, "phases": {}}
    for name in args.phases.split(","):
        prof = None if args.no_profile else cProfile.Profile()
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        got = runners[name]()
        if prof is not None:
            prof.disable()
        secs = time.perf_counter() - t0
        out["phases"][name] = {"wall_s": secs, **(split(prof, args.top) if prof else {})}
        if isinstance(got, dict) and "rows" in got:
            out["phases"][name]["rows"] = got["rows"]
        print(f"phase_profile {name}: {secs:.1f} s{'' if prof is None else ' under cProfile'} "
              f"({smi}): " + json.dumps(out["phases"][name], default=str), flush=True)
        del prof
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
