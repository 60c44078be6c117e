#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s tooling phase alone on the card.

    python3 tools/tooling_probe.py [--seed 0] [--keys 134217728] [--out FILE]

From the root of a checkout: builds the port's kernels, runs the read and
the update path at D = 1 / N = ``--keys`` to keep their inputs of kernels
1-5 on the host (as ``chip_smoke.main`` does), then the phase
(``chip_smoke.run_tooling``: the autotuner's sweep, the cache's round trip,
the tuned relaunches against the default geometry and their kernel rows,
the dry run of qwen3-4b and mixtral-8x22b on the (16, 16) mesh).  It prints
the card's name and power limit and one JSON object with the phase's
result and its kernel rows; ``--out`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=1 << 27)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("tooling_probe: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    chip_smoke.lm_settings()
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    captured = {}
    for runner, wanted in ((chip_smoke.run_path,
                            chip_smoke.READ_PATH_KERNELS + chip_smoke.PALLAS_GATHERS),
                           (chip_smoke.run_update_path, ("bucket_probe_layer", "bucket_probe"))):
        run = runner(1, args.keys, args.seed, device, lambda m: None)
        captured.update(chip_smoke.moved({k: v for k, v in run["inputs"]().items()
                                          if k in wanted}, torch.device("cpu")))
        del run
        gc.collect()
        torch.cuda.empty_cache()
    out = chip_smoke.run_tooling(args.seed, device, lambda m: print(m, flush=True), captured)
    blob = json.dumps({"result": out["result"], "kernels": out["rows"]}, default=str)
    print(blob, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
