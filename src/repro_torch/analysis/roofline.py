"""Roofline table from dry-run JSON records (port of
``repro.analysis.roofline``, with the H100's constants).

Terms per (arch x shape x mesh), all **seconds per step, per rank** (one
rank's traced step; wire bytes are one rank's):

    compute    = FLOPs / 989e12        (H100 SXM5 80GB, dense bf16 peak)
    memory     = bytes / 3.35e12       (its HBM3 rate)
    collective = wire_bytes / 50e9     (a GPU's inter-node link)

The constants are the H100 SXM5 80GB's at its 700 W limit (NVIDIA's H100
datasheet: 989 TFLOP/s dense BF16 tensor core, 3.35 TB/s HBM3).  The link
rate: a GPU reaches the seven others of its node over NVLink 4 at 450 GB/s
a direction (:data:`NVLINK_BW`), but the production mesh's 16-rank
``model`` axis spans two 8-GPU nodes, and its ``data`` axis every node, so
each axis's ring crosses the nodes' network, and a ring runs at its slowest
hop: a DGX H100's ConnectX-7 port, one a GPU, at 400 Gb/s = 50 GB/s a
direction (NVIDIA DGX H100 user guide).  The collective term is charged at
that rate, :data:`LINK_BW`.  These are the one place the dry run takes its
constants from.

The *step-time estimate* is ``max`` of the three (no-overlap roofline);
``roofline fraction`` = compute / max: 1.0 means compute-bound at peak.
``MFU_est`` uses the 6·N·D (train) / 2·N·D (inference) convention over the
same step time:

    MFU = MODEL_FLOPS / (chips · 989e12 · step_time)

``useful`` = MODEL_FLOPS / (FLOPs · chips): how much of the traced compute
is model math (remat's recomputation, dense-MoE waste, attention outside
the 6ND convention; above 1 where 6ND undercounts long-sequence
attention).

    python -m repro_torch.analysis.roofline [--dir results/dryrun] [--mesh 16x16] [--pick]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

PEAK_FLOPS = 989e12  # FLOP/s of one H100 SXM5 80GB (700 W), dense bf16
HBM_BW = 3.35e12  # B/s, its HBM3
NVLINK_BW = 450e9  # a direction, within a node
LINK_BW = 50e9  # a direction, a GPU's 400 Gb/s port between nodes: what the collective term uses


def load_records(directory: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def derive(rec: dict) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    t = rec["terms_s"]
    step = max(t.values())
    chips = rec["chips"]
    mf = rec["model_flops_global"]
    return {
        "arch": rec["arch"],
        "cell": rec["cell"],
        "mesh": "2x16x16" if rec["multi_pod"] else "16x16",
        "compute_s": t["compute_s"],
        "memory_s": t["memory_s"],
        "collective_s": t["collective_s"],
        "step_s": step,
        "bottleneck": rec["bottleneck"].replace("_s", ""),
        "fraction": t["compute_s"] / step if step else 0.0,
        "mfu": mf / (chips * PEAK_FLOPS * step) if step else 0.0,
        "useful": rec.get("useful_flops_ratio", 0.0),
        "temp_gib": rec.get("memory_analysis", {}).get("temp_size_in_bytes", 0)
        / 2**30,
        "arg_gib": rec.get("memory_analysis", {}).get("argument_size_in_bytes", 0)
        / 2**30,
    }


def markdown_table(rows: list[dict]) -> str:
    hdr = (
        "| arch | cell | mesh | compute (s) | memory (s) | collective (s) | "
        "step est (s) | bottleneck | roofline frac | MFU est | useful | temp GiB |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|---|"
    )
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} | {r['compute_s']:.3e} "
            f"| {r['memory_s']:.3e} | {r['collective_s']:.3e} | {r['step_s']:.3e} "
            f"| {r['bottleneck']} | {r['fraction']:.3f} | {r['mfu']:.3f} "
            f"| {r['useful']:.2f} | {r['temp_gib']:.1f} |"
        )
    return "\n".join(lines)


def summarize(directory: str, mesh: Optional[str] = None) -> list[dict]:
    rows = [d for d in (derive(r) for r in load_records(directory)) if d]
    if mesh:
        rows = [r for r in rows if r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], r["cell"], r["mesh"]))
    return rows


def worst_cells(rows: list[dict], n: int = 5) -> list[dict]:
    return sorted(rows, key=lambda r: r["fraction"])[:n]


def most_collective_bound(rows: list[dict], n: int = 5) -> list[dict]:
    return sorted(
        rows, key=lambda r: r["collective_s"] / max(r["step_s"], 1e-30), reverse=True
    )[:n]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default=None, choices=[None, "16x16", "2x16x16"])
    ap.add_argument("--pick", action="store_true", help="print hillclimb candidates")
    args = ap.parse_args(argv)
    rows = summarize(args.dir, args.mesh)
    print(f"H100 SXM5 80GB: {PEAK_FLOPS:.3e} FLOP/s bf16, {HBM_BW:.3e} B/s HBM, "
          f"{LINK_BW:.3e} B/s a link")
    print(markdown_table(rows))
    records = load_records(args.dir)
    skipped = [r for r in records if r.get("status") == "skipped"]
    errored = [r for r in records if r.get("status") == "error"]
    print(f"\nok={len(rows)} skipped={len(skipped)} error={len(errored)}")
    for r in errored:
        print(f"  ERROR {r['arch']}.{r['cell']}.{r['multi_pod']}: {r['error'][:140]}")
    if args.pick:
        print("\nworst roofline fraction:")
        for r in worst_cells(rows):
            print(f"  {r['arch']}.{r['cell']}.{r['mesh']} frac={r['fraction']:.3f}")
        print("\nmost collective-bound:")
        for r in most_collective_bound(rows):
            print(
                f"  {r['arch']}.{r['cell']}.{r['mesh']} "
                f"coll={r['collective_s']/max(r['step_s'],1e-30):.2f} of step"
            )


if __name__ == "__main__":
    main()
