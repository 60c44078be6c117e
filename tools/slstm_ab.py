#!/usr/bin/env python3
"""Time kernel 7 against an earlier version of its source, on one card.

    PYTHONPATH=src python3 tools/slstm_ab.py --old-source OLD.cu [--groups 5] [--reps 20]

``OLD.cu`` is an earlier ``src/repro_torch/csrc/slstm.cu`` whose C entry
point is ``slstm_sequence(pre, 4 strides, r, r_bf16, c0, n0, h0, m0, hs, 3
strides, cf, nf, hf, mf, xbuf, counters, batch, heads, seq, hd, stream)``
and needs ``xbuf`` (2, B*H, hd) f32 and ``counters`` (B*H,) zeroed, for
example ``git show <commit>:src/repro_torch/csrc/slstm.cu``.  It is
compiled alone into ``build/slstm_ab/`` and called as its wrapper called
it (scratch allocated and the counters zeroed at every call).  At
xlstm-1.3b's shapes with bf16 r, the main one (pre (1, 4, 2675, 4, 512), a
strided view of the block's projection, from zero states) and the decode
one (pre (4, 4, 1, 4, 512) from warm states), the script holds both
versions against the plain twin (2e-5 at the decode shape; 1e-4 over the
first 256 steps of the main shape, as ``chip_smoke.py`` holds 256-step
chunks) and times them in turns within each of ``--groups`` groups of
``--reps`` calls (CUDA events: the host's share included), and once more
under ``torch.profiler`` for the device time a launch.  It prints the
card's name and power limit and one JSON object with each version's min,
median and max ms a call and device ms a launch at each shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"main": (1, 4, 2675, 512), "decode": (4, 4, 1, 512)}  # b, h, s, hd
TOL = {"main": 1e-4, "decode": 2e-5}
CHECK_STEPS = 256


def old_library(source: str):
    from repro_torch.kernels import build

    out_dir = os.path.join(REPO, "build", "slstm_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "old_slstm.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", source, "-o", lib_path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.slstm_sequence.argtypes = list(build._SIGNATURES["slstm_sequence"])
    lib.slstm_sequence.restype = ctypes.c_int
    return lib


def inputs(shape, dev, seed):
    import torch

    from repro_torch.kernels import slstm

    b, h, s, hd = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    # The block's layout: a (B, S, 4, H, hd) projection, permuted.
    pre = 0.5 * torch.randn((b, s, 4, h, hd), generator=gen, device=dev).permute(0, 3, 1, 2, 4)
    r = (torch.randn((h, 4, hd, hd), generator=gen, device=dev) / hd ** 0.5).bfloat16()
    z = torch.zeros((b, h, hd), device=dev)
    states = (z, z.clone(), z.clone(), torch.full_like(z, -1e30))
    if s == 1:  # decode: from the states 16 steps of other inputs reach
        prefix = 0.5 * torch.randn((b, h, 16, 4, hd), generator=gen, device=dev)
        _, states = slstm.slstm_sequence_plain(prefix, r, *states)
    return pre, r, states


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-source", required=True)
    parser.add_argument("--groups", type=int, default=5)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("slstm_ab: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import slstm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    lib = old_library(args.old_source)

    def old_call(pre, r, states):
        b, h, s, _, hd = pre.shape
        hs = torch.empty((b, s, h, hd), device=dev).permute(0, 2, 1, 3)
        finals = tuple(torch.empty_like(states[0]) for _ in range(4))
        xbuf = torch.empty((2, b * h, hd), device=dev)
        counters = torch.zeros((b * h,), dtype=torch.int32, device=dev)
        code = lib.slstm_sequence(
            pre.data_ptr(), *pre.stride()[:4], r.data_ptr(), 1, *(t.data_ptr() for t in states),
            hs.data_ptr(), *hs.stride()[:3], *(t.data_ptr() for t in finals), xbuf.data_ptr(),
            counters.data_ptr(), b, h, s, hd, torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"old kernel failed to launch: error {code}")
        return hs, finals

    result = {"card": card, "launches_per_group": args.reps, "shapes": {}}
    for label, shape in SHAPES.items():
        pre, r, states = inputs(shape, dev, args.seed)
        variants = {"old": lambda: old_call(pre, r, states),
                    "new": lambda: slstm.slstm_sequence(pre, r, *states)}
        n = min(shape[2], CHECK_STEPS)
        want = slstm.slstm_sequence_plain(pre[:, :, :n], r, *states)
        errors = {}
        for name in variants:
            got = (old_call if name == "old" else
                   lambda p, rr, st: slstm.slstm_sequence(p, rr, *st))(pre[:, :, :n], r, states)
            torch.cuda.synchronize()
            worst = 0.0
            for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
                diff = (a - b).abs()
                worst = max(worst, float(diff.max()))
                if not bool((diff <= TOL[label] * (1 + b.abs())).all()):
                    raise SystemExit(f"slstm_ab: {name} at {label} differs from the twin by {worst}")
            errors[name] = worst
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
        device_ms = {}
        for name, fn in variants.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    fn()
                torch.cuda.synchronize()
            device_ms[name] = sum(e.self_device_time_total for e in prof.key_averages()
                                  if "slstm" in e.key) / 1e3 / args.reps
        entry = {"shape": {"b": shape[0], "h": shape[1], "s": shape[2], "hd": shape[3],
                           "r": "bfloat16"},
                 "variants": {name: {"min_ms": min(t), "median_ms": statistics.median(t),
                                     "max_ms": max(t), "device_ms_per_launch": device_ms[name],
                                     "max_abs_err": errors[name], "checked_steps": n}
                              for name, t in times.items()}}
        med = {name: v["median_ms"] for name, v in entry["variants"].items()}
        entry["new_over_old"] = med["new"] / med["old"]
        entry["new_over_old_device"] = device_ms["new"] / device_ms["old"]
        entry["new_ns_per_step"] = med["new"] * 1e6 / shape[2]
        result["shapes"][label] = entry
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
