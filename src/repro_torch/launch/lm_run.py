"""Language-model serving over a mesh: the pass every rank runs, on the CPU
in the tests (gloo) and on cards in ``chip_smoke.py`` and under torchrun.

:func:`run_lm` builds the model of an :class:`LMRunConfig` (unsharded, or
over a ``(data, model)`` mesh of the process group with the reference's
``production_parallel`` layout), draws its weights from the seed by the
reference's rule (each rank keeps its blocks of the whole draw), and
serves its requests through a ``ContinuousBatcher`` until drained.
It returns, per rank, the logits at every generated position, the tokens,
the collectives and their bytes per prefill and per decode step
(``counting.scoped``), the parameter bytes beside
``sharding.shard_bytes_per_device``, the kernel launches, walls and peak
bytes.  :func:`design_collectives` is the count the design gives per call.

Several cards, one NCCL rank a card::

    torchrun --nproc-per-node=K -m repro_torch.launch.lm_run --arch granite_20b \\
        --mesh 1,K --requests 4 --slots 2 --max-new 16

prints each rank's figures and checks that every rank generated the same
tokens.  Each rank runs on card ``LOCAL_RANK``; without a card it stops,
unless ``--device cpu`` asks for the plain path (gloo).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import counting

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class LMRunConfig:
    """One serving run: the model, the mesh and the traffic."""

    arch: str
    smoke: bool = False
    dtype: Optional[str] = None  # None: the config's
    num_layers: Optional[int] = None  # None: the config's (a cut of depth)
    mesh: tuple = (1, 1)  # (data, model)
    requests: int = 4
    slots: int = 2
    cache_len: int = 4096
    prompt_lens: tuple = (1000, 3000)  # drawn uniformly in [lo, hi]
    first_multiple: int = 1  # the first prompt's length rounded down to a multiple
    max_new: tuple = (16,)  # new tokens of request i: max_new[i % len]
    seed: int = 0


def model_config(cfg: LMRunConfig):
    """The run's ``ArchConfig`` (its dtype and depth cut applied)."""
    from repro_torch.configs.base import get_config, get_smoke_config

    mcfg = (get_smoke_config if cfg.smoke else get_config)(cfg.arch)
    changes = {}
    if cfg.dtype is not None:
        changes["dtype"] = cfg.dtype
    if cfg.num_layers is not None:
        changes["num_layers"] = cfg.num_layers
    return dataclasses.replace(mcfg, **changes) if changes else mcfg


def draw_prompts(cfg: LMRunConfig, vocab_size: int) -> list:
    """The run's prompts from its seed: lengths uniform in ``prompt_lens``,
    the first rounded down to a multiple of ``first_multiple``; token ids
    uniform in [1, vocab)."""
    rng = np.random.default_rng(cfg.seed + 2)
    lens = rng.integers(cfg.prompt_lens[0], cfg.prompt_lens[1] + 1, size=cfg.requests)
    lens[0] -= lens[0] % cfg.first_multiple
    return [rng.integers(1, vocab_size, size=int(n), dtype=np.int32) for n in lens]


def parallel_of(cfg: LMRunConfig):
    """The reference's production layout over a ``(data, model)`` mesh of
    the live group."""
    from repro_torch.launch import mesh as lmesh

    return lmesh.production_parallel(lmesh.device_mesh(cfg.mesh, AXES))


def design_collectives(mcfg, mesh: Sequence[int], kind: str, seq_len: int, batch: int,
                       cache_len: int) -> dict:
    """The collectives one call makes by the design, ``{kind: count}``
    (``kind`` "prefill" of ``batch`` prompts of ``seq_len``, or "decode" of
    ``batch`` slots), on a ``(data, model) = mesh`` layout with
    ``production_parallel``'s sequence parallelism:

    * the embedding: one sum over tp of the vocab blocks (a reduce-scatter
      under sequence parallelism);
    * a layer: the FSDP all-gather of its weight blocks over dp (one);
      attention: two sums over tp of the row-parallel products (``wo``,
      ``w_down``; reduce-scatters under sequence parallelism, which also
      all-gathers the two blocks' inputs), an all-gather of the q/k/v
      blocks that do not hold the heads the rank needs, and in decode over
      a sequence-sharded cache the all-gather of the partial softmaxes;
      mLSTM: all-gathers of ``u`` and the gate blocks, the sum of squares of
      ``out_norm`` and the ``w_down`` sum, and an all-gather of each state
      whose cache block is not the rank's heads, once into the step and once
      out; sLSTM: the all-gather of the gate-major projection and the two
      sums;
    * the head: the all-gather of the vocab blocks, the FSDP gather of an
      untied ``lm_head``, and over dp the all-gather of a sharded batch's
      rows or the broadcast of a replicated one; a sequence-parallel
      prefill broadcasts the last position's row from the last tp rank.

    Every call over an axis of one rank is absent."""
    d, t = mesh
    out: dict = {}

    def add(k, n=1):
        if n:
            out[k] = out.get(k, 0) + n

    h, kv, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim_
    sp = (kind == "prefill" and t > 1 and seq_len % t == 0
          and all(bt == "attn" for bt in mcfg.block_pattern))
    tp_sum = "reduce_scatter" if sp else "all_reduce"
    vocab_split = t > 1 and mcfg.vocab_size % t == 0
    if vocab_split:
        add(tp_sum)
    for _ in range(mcfg.num_periods):
        if d > 1:
            add("all_gather")  # the layer's FSDP blocks
        for bt in mcfg.block_pattern:
            if t == 1:
                continue
            if bt == "attn":
                add(tp_sum, 2)
                if sp:
                    add("all_gather", 2)
                heads_aligned = kv % t == 0
                seq_cache = not heads_aligned and cache_len % t == 0 and cache_len >= t
                kv_split, q_split = (kv * hd) % t == 0, (h * hd) % t == 0
                if kind == "prefill" or not seq_cache:
                    add("all_gather", int(not heads_aligned and kv_split))
                else:  # every q head over the rank's positions, then the combine
                    add("all_gather", int(q_split or kv_split) + 1)
            elif bt == "mlstm":
                from repro_torch.models.ssm import mlstm_dims

                nh, dk, dv = mlstm_dims(mcfg)
                add("all_reduce", 2)
                add("all_gather", int(nh * dv % t == 0) + int(2 * nh % t == 0))  # u, gates
                n_split_off_heads = dk > nh and dk % t == 0
                add("all_gather", int(n_split_off_heads) * (1 if kind == "prefill" else 2))
            else:  # slstm
                add("all_reduce", 2)
                add("all_gather")
    if vocab_split:
        add("all_gather")
    if d > 1 and not mcfg.tie_embeddings:
        add("all_gather")  # lm_head's FSDP block
    if d > 1:
        add("all_gather" if batch % d == 0 else "broadcast")
    if sp:
        add("broadcast")
    return out


def _digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def _forcing(logits: torch.Tensor, tokens) -> torch.Tensor:
    """Rows whose argmax is ``tokens`` (one a row), for the batcher to take."""
    out = torch.zeros_like(logits)
    out[torch.arange(len(tokens)), torch.as_tensor(tokens, dtype=torch.long)] = 1
    return out


def run_lm(cfg: LMRunConfig, *, sharded: bool = True, device=None,
           forced: Optional[dict] = None, keep_logits: bool = True, keep_model: bool = False,
           timeout_s: Optional[float] = None) -> dict:
    """Serve ``cfg``'s requests on this rank (``sharded``: over the live
    group's mesh) on ``device`` (``None``: the card, raising without one),
    with the weights drawn from ``cfg.seed``.  ``forced`` (uid → tokens) teacher-forces the batcher: it takes
    those tokens in place of its argmaxes, so two runs whose logits differ
    by rounding still feed the same sequences; the logits recorded are the
    model's.  Returns the rank's figures (``logits`` by request only with
    ``keep_logits``; their digests always; ``bundle`` and ``params`` with
    ``keep_model``)."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.distributed.parallel import mesh_shape, single_device_parallel
    from repro_torch.kernels import build
    from repro_torch.models.api import build_model, resolve_device
    from repro_torch.serve import (ContinuousBatcher, Request, make_prefill_step,
                                   make_serve_step, make_sharded_serve_step)

    dev = resolve_device(device)
    mcfg = model_config(cfg)
    parallel = parallel_of(cfg) if sharded else single_device_parallel()
    bundle = build_model(mcfg, parallel, device=dev, timeout_s=timeout_s)
    lay = bundle.layout

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    params = bundle.init(cfg.seed)
    sync()
    init_s = time.perf_counter() - t0
    prompts = draw_prompts(cfg, mcfg.vocab_size)
    # Warm-up outside the counted run (libraries, allocator, the kernels' first launch).
    warm_len = min(64, len(prompts[0]) - 1, cfg.cache_len - 1)
    _, warm = bundle.prefill(params, {"tokens": prompts[0][None, :warm_len]},
                             cache_len=warm_len + 1)
    bundle.decode_step(params, warm, prompts[0][None, warm_len:warm_len + 1],
                       np.array([warm_len], np.int32))
    del warm

    prefill = make_prefill_step(bundle, cache_len=cfg.cache_len)
    if sharded:
        decode, _ = make_sharded_serve_step(bundle, cfg.slots, cfg.cache_len)
    else:
        decode = make_serve_step(bundle)
    rec = {"prefill": [], "decode": [], "logits": {i: [] for i in range(cfg.requests)}}

    def scoped_wall(fn):
        sync()
        start = time.perf_counter()
        with counting.scoped() as scope:
            out = fn()
            sync()
        return out, time.perf_counter() - start, scope

    def timed_prefill(p, batch):
        uid = len(rec["prefill"])  # the batcher admits in submission order
        n = int(batch["tokens"].shape[1])
        (logits, cache), secs, scope = scoped_wall(lambda: prefill(p, batch))
        path = ("seq-parallel" if lay.act(mcfg, (1, n))[1]
                else "all-reduce" if lay.tp.size > 1 else "whole")
        rec["prefill"].append({"uid": uid, "len": n, "s": secs, "path": path,
                               "ttft_s": time.perf_counter() - rec["start"],
                               "collectives": dict(scope.collectives),
                               "bytes": dict(scope.collective_bytes)})
        rec["logits"][uid].append(logits[0].float().cpu().numpy())
        if forced is not None:
            logits = _forcing(logits, [forced[uid][0]])
        return logits, cache

    def timed_decode(p, caches, token, pos):
        live = [(i, r.uid) for i, r in enumerate(batcher.slots) if r is not None]
        (logits, caches), secs, scope = scoped_wall(lambda: decode(p, caches, token, pos))
        rec["decode"].append({"live": len(live), "s": secs,
                              "collectives": dict(scope.collectives),
                              "bytes": dict(scope.collective_bytes)})
        host = logits.float().cpu().numpy()
        for i, uid in live:
            rec["logits"][uid].append(host[i])
        if forced is not None:
            logits = _forcing(logits, [
                forced[r.uid][len(r.out_tokens)] if r is not None else 0 for r in batcher.slots])
        return logits, caches

    batcher = ContinuousBatcher(params, bundle.init_cache(cfg.slots, cfg.cache_len),
                                timed_prefill, timed_decode, num_slots=cfg.slots)
    for uid, prompt in enumerate(prompts):
        batcher.submit(Request(uid=uid, prompt=prompt,
                               max_new_tokens=cfg.max_new[uid % len(cfg.max_new)]))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.LAUNCHES.clear()
    sync()
    rec["start"] = time.perf_counter()
    done = batcher.run_until_drained()
    sync()
    total_s = time.perf_counter() - rec["start"]
    launches = dict(build.LAUNCHES)
    if len(done) != cfg.requests:
        raise RuntimeError(f"{len(done)} of {cfg.requests} requests finished")

    shapes = bundle.param_shapes()
    if sharded:
        specs = sharding.param_pspecs(shapes, parallel)
        expect = sharding.shard_bytes_per_device(shapes, specs, mesh_shape(parallel.mesh))
    else:
        expect = sum(t.numel() * t.element_size() for t in shapes.parameters())
    logits = {uid: np.stack(v) for uid, v in rec["logits"].items()}
    rank = dist.get_rank() if sharded and dist.is_initialized() else 0
    out = {
        "rank": rank,
        "mesh": tuple(cfg.mesh) if sharded else None,
        "arch": mcfg.name,
        "layers": mcfg.num_layers,
        "dtype": mcfg.dtype,
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "prompt_lens": [len(p) for p in prompts],
        "tokens": {r.uid: list(r.out_tokens) for r in done},
        "logit_digests": {uid: _digest(v) for uid, v in logits.items()},
        "prefill": rec["prefill"],
        "decode": rec["decode"],
        "param_bytes": sum(t.numel() * t.element_size() for t in params.parameters()),
        "shard_bytes": expect,
        "launches": launches,
        "init_s": init_s,
        "total_s": total_s,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }
    if keep_logits:
        out["logits"] = logits
    if keep_model:
        out["bundle"], out["params"], out["prompts"] = bundle, params, prompts
    return out


def rank_job(group, configs: Sequence[LMRunConfig], device=None,
             timeout_s: Optional[float] = None) -> list:
    """A rank's runs of ``configs`` in turn over the group (a ``spawn``
    target), each model freed before the next is built."""
    import gc

    out = []
    for cfg in configs:
        out.append(run_lm(cfg, device=device, timeout_s=timeout_s))
        gc.collect()
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def _ints(text: str) -> tuple:
    return tuple(int(x) for x in text.split(","))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", default="granite_20b")
    parser.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    parser.add_argument("--dtype", default=None)
    parser.add_argument("--layers", type=int, default=None, help="cut the depth")
    parser.add_argument("--mesh", type=_ints, default=None,
                        help="data,model (default 1,world)")
    parser.add_argument("--requests", type=int, default=4)
    parser.add_argument("--slots", type=int, default=2)
    parser.add_argument("--cache-len", type=int, default=4096)
    parser.add_argument("--prompt-lens", type=_ints, default=(1000, 3000))
    parser.add_argument("--max-new", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", default=None, help="nccl (default on a card) or gloo")
    parser.add_argument("--device", default=None,
                        help="the rank's device (default: card LOCAL_RANK; 'cpu' for the "
                             "plain path)")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh

    group = lmesh.init_shard_group(args.backend, timeout_s=args.timeout, device=args.device)
    device = torch.device(args.device) if args.device else \
        torch.device("cuda", torch.cuda.current_device())
    cfg = LMRunConfig(
        arch=args.arch, smoke=args.smoke, dtype=args.dtype, num_layers=args.layers,
        mesh=args.mesh or (1, group.size),
        requests=args.requests, slots=args.slots, cache_len=args.cache_len,
        prompt_lens=args.prompt_lens, first_multiple=(args.mesh or (1, group.size))[1],
        max_new=(args.max_new,), seed=args.seed,
    )
    try:
        out = run_lm(cfg, device=device, keep_logits=False, timeout_s=args.timeout)
        tokens = [t for uid in sorted(out["tokens"]) for t in out["tokens"][uid]]
        same = group.same([len(tokens), int(_digest(np.asarray(tokens, np.int64))[:12], 16)])
        out["tokens_equal_on_every_rank"] = same
        print(json.dumps({"backend": group.backend, **out}, default=str), flush=True)
        if not same:
            raise RuntimeError("the ranks generated different tokens")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
