#!/usr/bin/env python3
"""Time prefills of one prompt through a given copy of the port.

    python3 tools/prefill_ab.py --src SRC [--config qwen3_4b] [--repeats 10] [--seed 0]

``SRC`` is the ``src`` directory of a checkout (this one, or an earlier
commit unpacked with ``git archive``); ``repro_torch`` is imported from
there, so two versions can be compared on one card by running the script
once for each, in turns (A, B, B, A).  The script builds ``--config``
(``qwen3_4b`` or ``xlstm_1_3b``) at full width on the card with the seeded
random bf16 weights of ``chip_smoke.py`` and the prompt of its request 0
(2675 tokens at seed 0),
runs ``prefill`` with a 4096-token cache twice to warm up and then
``--repeats`` times, each synchronised on both sides, and profiles one
more call (``torch.profiler``: device time by kernel class, as
``chip_smoke.py --profile`` splits it).  It prints the card's name and
power limit and one JSON object: the wall ms of every repeat with their
min, median and max, and the profiled call's wall, device busy ms and
per-class ms and launches.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True)
    parser.add_argument("--config", default="qwen3_4b", help="a config name of get_config")
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prefill_ab: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, REPO)
    import chip_smoke
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    chip_smoke.lm_settings()
    device = torch.device("cuda", 0)
    cfg = get_config(args.config)
    bundle = build_model(cfg, device=device)
    params = bundle.init(args.seed)
    rng = np.random.default_rng(args.seed + 2)  # request 0's prompt, as chip_smoke draws it
    lens = rng.integers(chip_smoke.LM_PROMPT_LENS[0], chip_smoke.LM_PROMPT_LENS[1] + 1,
                        size=chip_smoke.LM_REQUESTS)
    prompt = rng.integers(1, cfg.vocab_size, size=int(lens[0]), dtype=np.int32)

    def prefill():
        return bundle.prefill(params, {"tokens": prompt[None]}, cache_len=chip_smoke.LM_CACHE_LEN)

    walls = []
    with torch.no_grad():
        for i in range(2 + args.repeats):
            _, seconds = chip_smoke.wall(prefill, device)
            if i >= 2:
                walls.append(seconds * 1e3)
        profiled = chip_smoke.profile_phases({"prefill": prefill}, device)["prefill"]
    print(json.dumps({
        "card": card, "src": args.src, "config": args.config, "prompt_tokens": int(lens[0]),
        "wall_ms": walls,
        "wall_ms_min_median_max": [min(walls), statistics.median(walls), max(walls)],
        "tokens_per_s_at_median": int(lens[0]) / statistics.median(walls) * 1e3,
        "profiled": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "by_class")},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
