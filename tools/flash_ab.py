#!/usr/bin/env python3
"""Time kernel 6 against an earlier version of its source, on one card.

    PYTHONPATH=src python3 tools/flash_ab.py --old-source OLD.cu [--groups 5] [--reps 20]

``OLD.cu`` is an earlier ``src/repro_torch/csrc/flash_attention.cu`` whose
C entry point takes contiguous tensors, ``flash_attention(q, k, v, o, hq,
sq, skv, d, group, causal, window, scale, is_bf16, stream)``, for example
``git show <commit>:src/repro_torch/csrc/flash_attention.cu``.  It is
compiled alone into ``build/flash_ab/``.  At qwen3-4b's first prefill shape
(q (32, 2675, 128), k/v (8, 2675, 128), bf16, causal) the script holds both
versions against the plain twin (``FLASH_TOL``'s 2e-2) and times, in turns
within each of ``--groups`` groups of ``--reps`` launches (CUDA events):
the old kernel on contiguous tensors, the current kernel on the strided
views a model hands over and on contiguous tensors, and
``scaled_dot_product_attention`` (causal, ``enable_gqa``) as the yardstick.
It prints the card's name and power limit and one JSON object with each
variant's min, median and max ms over the groups.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-2
SHAPE = (32, 8, 2675, 128)  # hq, hkv, s, d: request 0 at layer 0 of qwen3-4b


def old_library(source: str):
    from repro_torch.kernels import build

    out_dir = os.path.join(REPO, "build", "flash_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "old_flash.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", source, "-o", lib_path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.flash_attention.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-source", required=True)
    parser.add_argument("--groups", type=int, default=5)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import flash_attention as flash

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    hq, hkv, s, d = SHAPE
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # The model's layout: (S, heads, D) projections, permuted to (heads, S, D).
    qv = torch.randn((s, hq, d), generator=gen, device=dev).bfloat16().transpose(0, 1)
    kv = torch.randn((s, hkv, d), generator=gen, device=dev).bfloat16().transpose(0, 1)
    vv = torch.randn((s, hkv, d), generator=gen, device=dev).bfloat16().transpose(0, 1)
    qc, kc, vc = qv.contiguous(), kv.contiguous(), vv.contiguous()
    scale = 1.0 / math.sqrt(d)
    lib = old_library(args.old_source)
    stream = torch.cuda.current_stream(dev).cuda_stream
    old_out = torch.empty_like(qc)

    def old():
        code = lib.flash_attention(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), old_out.data_ptr(),
                                   hq, s, s, d, hq // hkv, 1, -1, scale, 1, stream)
        if code != 0:
            raise RuntimeError(f"old kernel failed to launch: error {code}")
        return old_out

    variants = {
        "old_flash_fwd_mma (contiguous)": old,
        "kernel 6 (strided views)": lambda: flash.flash_attention_fhsd(qv, kv, vv, q_heads_per_kv=hq // hkv),
        "kernel 6 (contiguous)": lambda: flash.flash_attention_fhsd(qc, kc, vc, q_heads_per_kv=hq // hkv),
        "sdpa": lambda: F.scaled_dot_product_attention(qc[None], kc[None], vc[None], is_causal=True,
                                                       enable_gqa=True)[0],
    }
    want = flash.flash_attention_plain(qc, kc, vc, q_heads_per_kv=hq // hkv).float()
    errors = {}
    for name, fn in variants.items():
        got = fn().float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        errors[name] = float(err.max())
        if not bool((err <= TOL * (1 + want.abs())).all()):
            raise SystemExit(f"flash_ab: {name} differs from the plain twin by {errors[name]}")
    times = {name: [] for name in variants}
    for fn in variants.values():  # warm-up
        fn()
    for _ in range(args.groups):
        for name, fn in variants.items():
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / args.reps)
    live = s * (s + 1) // 2
    flops = 4 * d * live * hq
    result = {"card": card, "shape": {"hq": hq, "hkv": hkv, "s": s, "d": d, "dtype": "bfloat16",
                                      "causal": True},
              "bound_ms": flops / 989e12 * 1e3, "flop": flops, "launches_per_group": args.reps,
              "variants": {name: {"min_ms": min(t), "median_ms": statistics.median(t),
                                  "max_ms": max(t), "max_abs_err": errors[name],
                                  "tflops_at_median": flops / statistics.median(t) / 1e9}
                           for name, t in times.items()}}
    med = {name: v["median_ms"] for name, v in result["variants"].items()}
    result["new_over_old"] = med["kernel 6 (strided views)"] / med["old_flash_fwd_mma (contiguous)"]
    result["new_over_sdpa"] = med["kernel 6 (strided views)"] / med["sdpa"]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
