"""End-to-end training, on one card or over a mesh of ranks.

    # qwen3-family smoke model on the CPU (every kernel's plain twin)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b --smoke \\
        --steps 20 --batch 4 --seq 64 --device cpu

    # qwen3-4b at full width, 12 of its 36 layers, on the card, with dedup
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b --layers 12 \\
        --seq 2048 --batch 4 --microbatches 2 --steps 4 --dedup local

    # over a (2, 2) mesh of four gloo ranks on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --fake-devices 4 \
        --steps 4 --batch 8 --seq 32 --microbatches 2 --device cpu

The reference's flags, plus ``--device`` (default: the CUDA card; raises
``RuntimeError`` without one, ``cpu`` asks for the plain path).  The data
is ``ShardedLoader`` over ``SyntheticCorpus(dup_rate=0.05)`` drawn on the
device, with the HashGraph dedup under ``--dedup local``.

``--fake-devices N`` (N > 1) keeps the reference's meaning, N devices under
``make_smoke_mesh()`` with ``data`` the dp axis and ``model`` tp where
present: here N ranks (``launch.mesh.spawn``, gloo) on ``--device`` (a
named card puts every rank on it; the default gives rank r card r), each
training its blocks (``train.step`` over the mesh), every rank drawing the
global batch.  ``--grad-compression`` is error feedback on that step.
Rank 0 logs, and ``main`` returns its result.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=0, help="override width (smoke)")
    ap.add_argument("--layers", type=int, default=0, help="override depth")
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--dedup", default=None, choices=[None, "local"])
    ap.add_argument("--fake-devices", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--crash-at-step", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace, log=print):
    """The trainer ``main`` runs: the config with the flags' overrides, its
    bundle on the device, the loader and the train-step settings."""
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.data import ShardedLoader, SyntheticCorpus
    from repro_torch.distributed.parallel import ParallelConfig, single_device_parallel
    from repro_torch.models.api import build_model
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig
    from repro_torch.utils import tree_param_count

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.layers:
        overrides["num_layers"] = args.layers
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if args.fake_devices > 1:
        from repro_torch.launch.mesh import make_smoke_mesh

        mesh = make_smoke_mesh()
        parallel = ParallelConfig(
            mesh=mesh, dp_axes=("data",),
            tp_axis="model" if "model" in mesh.mesh_dim_names else None,
            moe_impl="ep" if cfg.is_moe else "dense", microbatches=args.microbatches,
            grad_compression=args.grad_compression)
    else:
        parallel = dataclasses.replace(single_device_parallel(), microbatches=args.microbatches,
                                       grad_compression=args.grad_compression)
    bundle = build_model(cfg, parallel, device=args.device)
    n = tree_param_count(bundle.param_shapes())
    mesh = dict(zip(parallel.mesh.mesh_dim_names, parallel.mesh.shape)) if parallel.mesh else None
    log(f"[train] arch={cfg.name} layers={cfg.num_layers} params={n / 1e6:.1f}M "
        f"device={bundle.device} mesh={mesh}")
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=args.seq, seed=args.seed,
                             dup_rate=0.05, device=bundle.device)
    loader = ShardedLoader(corpus, batch_size=args.batch, dedup=args.dedup)
    tcfg = TrainStepConfig(peak_lr=args.lr, warmup_steps=max(10, args.steps // 10),
                           total_steps=args.steps)
    return Trainer(
        bundle, loader, tcfg,
        TrainerConfig(
            total_steps=args.steps,
            checkpoint_every=args.checkpoint_every if args.checkpoint_dir else 0,
            checkpoint_dir=args.checkpoint_dir,
            log_every=max(1, args.steps // 20),
            seed=args.seed,
            crash_at_step=args.crash_at_step,
        ),
        log_fn=log,
    )


def _train(args, log=print) -> dict:
    trainer = make_trainer(args, log)
    out = trainer.run()
    mesh = trainer.bundle.parallel.mesh
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None else None
    hist = out["history"]
    if hist:
        log(f"[train] done: step={out['final_step']} loss {hist[0]['loss']:.3f} -> "
            f"{hist[-1]['loss']:.3f} stragglers={out['stragglers']}")
    return out


def _rank(group, argv) -> dict:
    """One spawned rank of ``--fake-devices``: rank 0 logs."""
    return _train(parse(argv), print if group.rank == 0 else (lambda msg: None))


def main(argv=None) -> dict:
    args = parse(argv)
    if args.fake_devices > 1:
        from repro_torch.launch.mesh import spawn

        argv = list(sys.argv[1:] if argv is None else argv)
        return spawn(_rank, args.fake_devices, "gloo", args.device, args=(argv,),
                     timeout_s=600.0)[0]
    return _train(args)


if __name__ == "__main__":
    main()
