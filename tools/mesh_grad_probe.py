#!/usr/bin/env python3
"""Gradients of the sharded model against the unsharded one, on the card.

    python3 tools/mesh_grad_probe.py [--layers 2] [--seq 1024] [--out FILE]

From the root of a checkout: qwen3-4b at its published widths (``--layers``
of its 36; ``--smoke``: the smoke config), on the first ``--rows`` rows
of the loader's first batch (the train-procs phase's data:
``SyntheticCorpus(dup_rate=0.05)`` with the local dedup, seed 0).  Four
gloo ranks on the card take the loss's gradients
over a (data, model) = (2, 2) mesh, once on their f32 master blocks and
once on the bf16 compute copy the train step makes
(``transformer.compute_copy``), reduce them over dp as the step does and
gather them whole; this process takes the unsharded gradients of the same
f32 masters.  For the compute's bf16 and f32 configs it prints both
losses, both global norms, the leaves that differ most (max |difference|
over the leaf's largest unsharded entry) and those whose norms differ
most, then one JSON object with all of it; ``--out`` also writes it to a
file.  ``--device cpu`` runs the plain path (a rehearsal).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cases(layers: int, smoke: bool = False) -> dict:
    from repro_torch.configs.base import get_config, get_smoke_config

    cfg = dataclasses.replace((get_smoke_config if smoke else get_config)("qwen3_4b"),
                              num_layers=layers)
    return {"bf16": cfg, "f32": dataclasses.replace(cfg, dtype="float32")}


def _tokens(seq: int, rows: int, smoke: bool = False):
    from repro_torch.launch import train_run

    run = train_run.TrainRunConfig(arch="qwen3_4b", smoke=smoke, seq=seq, batch=4, steps=1,
                                   dedup="local")
    return train_run.draw_batches(run, "cpu")[0][:rows]


def _whole_grads(bundle, params, tokens, copy: bool) -> tuple:
    """(loss, {name: whole f32 gradient, numpy}) of one sharded pass."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.models import transformer
    from repro_torch.train.step import reduce_whole_over_dp

    src = transformer.compute_copy(params) if copy else params
    names = [n for n, _ in src.named_parameters()]
    loss, _ = transformer.loss_fn(src, {"tokens": tokens.to(bundle.device)}, bundle.cfg,
                                  layout=bundle.layout)
    grads = reduce_whole_over_dp(bundle.layout, dict(zip(names, torch.autograd.grad(
        loss, list(src.parameters())))))
    lay = bundle.layout
    return float(loss.detach()), {
        n: sharding.gather(g, lay.specs[n], lay.parallel, (lay.dp, lay.tp)).float().cpu().numpy()
        for n, g in grads.items()}


def _rank(group, layers: int, seq: int, rows: int, device: str, smoke: bool) -> dict:
    import torch

    from repro_torch.distributed.parallel import ParallelConfig
    from repro_torch.launch import mesh
    from repro_torch.models.api import build_model

    out = {}
    tokens = _tokens(seq, rows, smoke)
    for key, cfg in _cases(layers, smoke).items():
        par = ParallelConfig(mesh=mesh.device_mesh((2, 2), ("data", "model")))
        bundle = build_model(cfg, par, device=device)
        params = bundle.init_train(3)
        for copy in (False, True):
            loss, grads = _whole_grads(bundle, params, tokens, copy)
            out[f"{key} {'compute copy' if copy else 'masters'}"] = (
                loss, grads if group.rank == 0 else None)
        del bundle, params
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def _compare(grads: dict, ref: dict) -> dict:
    import numpy as np

    def norm(ts):
        return float(sum(float(np.square(t.astype(np.float64)).sum()) for t in ts) ** 0.5)

    worst = sorted(((float(np.abs(grads[n] - r).max() / max(float(np.abs(r).max()), 1e-30)), n)
                    for n, r in ref.items()), reverse=True)
    leaf_norms = sorted(((abs(norm([grads[n]]) - norm([r])) / max(norm([r]), 1e-30), n,
                          norm([grads[n]]), norm([r])) for n, r in ref.items()), reverse=True)
    return {"norm": norm(grads.values()), "unsharded_norm": norm(ref.values()),
            "worst_leaves": worst[:4], "leaf_norms_off_most": leaf_norms[:4]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain path")
    ap.add_argument("--smoke", action="store_true", help="the smoke config (a CPU rehearsal)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.launch import mesh
    from repro_torch.models.api import build_model

    if args.device is None and not torch.cuda.is_available():
        print("mesh_grad_probe: no CUDA device", file=sys.stderr)
        return 3
    device = args.device or "cuda:0"
    smi = "cpu"
    if torch.device(device).type == "cuda":
        chip_smoke.lm_settings()
        smi = chip_smoke.card_line()
        build.library()
    print(smi, flush=True)
    tokens = _tokens(args.seq, args.rows, args.smoke)
    refs = {}
    for key, cfg in _cases(args.layers, args.smoke).items():
        bundle = build_model(cfg, device=device)
        params = bundle.init_train(3)
        loss, _ = bundle.loss(params, {"tokens": tokens})
        names = [n for n, _ in params.named_parameters()]
        grads = torch.autograd.grad(loss, list(params.parameters()))
        refs[key] = (float(loss.detach()),
                     {n: g.float().cpu().numpy() for n, g in zip(names, grads)})
        del bundle, params, grads
    ranks = mesh.spawn(_rank, 4, "gloo", device,
                       args=(args.layers, args.seq, args.rows, device, args.smoke), timeout_s=600)
    out = {"card": smi, "layers": args.layers, "seq": args.seq, "rows": args.rows, "cases": {}}
    for case, (loss, grads) in ranks[0].items():
        ref_loss, ref = refs[case.split()[0]]
        out["cases"][case] = {"loss": loss, "unsharded_loss": ref_loss, **_compare(grads, ref)}
        print(f"{case}: " + json.dumps(out["cases"][case]), flush=True)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
