"""Batched serving from the command line: continuous batching over a smoke-scale model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b --requests 12 \\
        --slots 4 --prompt-len 32 --max-new 16 [--device cpu]

``--arch`` takes a ported arch (``granite_20b``, ``qwen3_4b``,
``xlstm_1_3b``) and serves its smoke config on one device
(``single_device_parallel()``, as the reference's launcher passes it).  Runs on the CUDA card unless ``--device cpu`` is given (there every kernel
takes its plain twin); without a card and without ``--device cpu`` it
raises.
"""
import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.distributed.parallel import single_device_parallel
    from repro_torch.models.api import build_model
    from repro_torch.serve import ContinuousBatcher, Request, make_prefill_step, make_serve_step

    cfg = get_smoke_config(args.arch)
    bundle = build_model(cfg, single_device_parallel(), device=args.device)
    params = bundle.init(args.seed)
    caches = bundle.init_cache(args.slots, args.cache_len)
    prefill = make_prefill_step(bundle, cache_len=args.cache_len)
    decode = make_serve_step(bundle)

    rng = np.random.default_rng(args.seed)
    batcher = ContinuousBatcher(params, caches, prefill, decode, num_slots=args.slots)
    for uid in range(args.requests):
        batcher.submit(
            Request(
                uid=uid,
                prompt=rng.integers(1, cfg.vocab_size, size=args.prompt_len, dtype=np.int32),
                max_new_tokens=args.max_new,
            )
        )
    t0 = time.perf_counter()
    done = batcher.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(
        f"[serve] arch={cfg.name} device={bundle.device} requests={len(done)} tokens={toks} "
        f"time={dt:.2f}s ({toks/dt:.1f} tok/s, slots={args.slots})"
    )
    if len(done) != args.requests:
        raise RuntimeError(f"{len(done)} of {args.requests} requests finished")


if __name__ == "__main__":
    main()
