#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s archs phase alone on the card.

    python3 tools/archs_probe.py [--seed 0] [--profile] [--out FILE]

From the root of a checkout: builds the port's kernels, prints kernel 6's
registers, spills and shared memory (``ptxas -v``), then runs the phase
(``chip_smoke.run_archs``: recurrentgemma-9b through the continuous
batcher, whisper-base and pixtral-12b through the bundle, every gate of the
phase and kernel 6's rows at head dim 256 and at whisper's encoder shape).
``--profile`` also profiles one more recurrentgemma prefill and decode step
(device time by kernel class and inside the RG-LRU scan's range).  It
prints the card's name and power limit and one JSON object with the
phase's result and its kernel rows; ``--out`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("archs_probe: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    chip_smoke.lm_settings()
    smi = chip_smoke.card_line()
    print(smi, flush=True)
    log = lambda m: print(m, flush=True)
    t0 = time.perf_counter()
    build.library()
    log("kernel flash_attention build: " + json.dumps(chip_smoke.flash_build_report()))
    torch.zeros(1, device=device)  # the context, before the phase resets its peak
    run = chip_smoke.run_archs(args.seed, device, log, profile=args.profile)
    out = {"card": smi, "result": run["result"], "rows": run["rows"],
           "seconds": time.perf_counter() - t0}
    text = json.dumps(out, default=str)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(f"archs_probe: {out['seconds']:.1f} s in all ({smi})", flush=True)
    print(json.dumps({"rows": [{k: r[k] for k in ("name", "path", "launches", "max_abs_err", "ms",
                                                  "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms")} for r in run["rows"]]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
