#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s train phase, or its train-procs phase, alone on
the card.

    python3 tools/train_probe.py [--seed 0] [--profile] [--skip-checks] [--out FILE]
    python3 tools/train_probe.py --procs [--seed 0] [--profile] [--out FILE]

From the root of a checkout: builds the port's kernels, then runs the train
phase's main run (``chip_smoke.run_train``: qwen3-4b at full width,
``chip_smoke.TRAIN_LAYERS`` layers, seq 2048, batch 4 in 2 microbatches,
the loader's dedup, 4 steps, every gate of the phase), and, unless
``--skip-checks``, its gradient checks (``check_train_grads``) and the
crash and resume (``check_train_resume``).  ``--profile`` profiles one more
train step (``torch.profiler``): device time by kernel class, and inside
the ranges of kernel 6's plain backward (``flash_attention.backward``) and
of the optimizer (``train.optimizer``).  ``--procs`` runs the
train-procs phase instead (``chip_smoke.run_train_procs``: training over a
mesh, four gloo ranks on the card and one NCCL rank, every gate of the
phase); with ``--profile`` rank 0 profiles one more step of each run
(device busy time and the host time inside each kind of collective).  It
prints the card's name and power limit and one JSON object with the
phase's result, its kernel rows and the profile; ``--out`` also writes it
to a file.
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
    ap.add_argument("--skip-checks", action="store_true")
    ap.add_argument("--procs", action="store_true", help="the train-procs phase instead")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [REPO, os.path.join(REPO, "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import BACKWARD_RANGE
    from repro_torch.train.step import OPTIMIZER_RANGE

    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    chip_smoke.lm_settings()
    smi = chip_smoke.card_line()
    print(smi, flush=True)
    log = lambda m: print(m, flush=True)
    t0 = time.perf_counter()
    build.library()
    torch.zeros(1, device=device)  # the context, before the phase resets its peak
    out = {"card": smi}
    if args.procs:
        run = chip_smoke.run_train_procs(args.seed, device, log, profile=args.profile)
        out["result"], out["rows"] = run["result"], run["rows"]
        return _finish(out, t0, args.out)
    run = chip_smoke.run_train(args.seed, device, log)
    out["result"], out["rows"] = run["result"], run["rows"]
    if args.profile:
        out["profile"] = chip_smoke.profile_phases(chip_smoke.train_phases(run), device,
                                                   window=(BACKWARD_RANGE, OPTIMIZER_RANGE))
    del run
    torch.cuda.empty_cache()
    if not args.skip_checks:
        out["grads"] = chip_smoke.check_train_grads(args.seed, device, log)
        out["resume"] = chip_smoke.check_train_resume(args.seed, device, log)
    return _finish(out, t0, args.out)


def _finish(out: dict, t0: float, path) -> int:
    out["seconds"] = time.perf_counter() - t0
    text = json.dumps(out, default=str)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
