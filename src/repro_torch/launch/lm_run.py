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

:func:`run_loss` is the forward-loss run beside them: the model's
``loss`` over a global batch drawn from the seed, each rank taking its
rows (an MoE stack under ``moe_impl="ep"`` exchanges its (token, expert)
rows through the paper's all-to-all), with the rank's row CE, aux, drops,
exchange rounds and bytes per label, collectives and parameter bytes;
``stacked=D`` runs the same on one device over ``StackedGroup(D)``
(``transformer.loss_ep_stacked``), the twin every rank is held to bit for
bit.  :func:`design_loss_collectives` is its design count.

Several cards, one NCCL rank a card::

    torchrun --nproc-per-node=K -m repro_torch.launch.lm_run --arch granite_20b \\
        --mesh 1,K --requests 4 --slots 2 --max-new 16

prints each rank's figures and checks that every rank generated the same
tokens; ``--loss B,S`` runs one forward loss of B rows of S tokens instead
(e.g. ``--arch mixtral_8x22b --layers 2 --mesh K,1 --moe-impl ep --loss
K,2048``: expert parallelism through the exchange) and checks that every
rank has the same loss.  Each rank runs on card ``LOCAL_RANK``; without a card it stops,
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
    num_kv_heads: Optional[int] = None  # None: the config's (a smoke config's kv heads)
    block_pattern: Optional[tuple] = None  # None: the config's (a shorter period, with a cut)
    mesh: tuple = (1, 1)  # (data, model)
    moe_impl: str = "ep"  # an MoE stack's dispatch over the mesh ("dense" | "ep")
    requests: int = 4
    slots: int = 2
    cache_len: int = 4096
    prompt_lens: tuple = (1000, 3000)  # drawn uniformly in [lo, hi]
    lens: tuple = ()  # the prompts' lengths, one a request, in place of prompt_lens' draw
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
    if cfg.num_kv_heads is not None:
        changes["num_kv_heads"] = cfg.num_kv_heads
    if cfg.block_pattern is not None:
        changes["block_pattern"] = tuple(cfg.block_pattern)
    return dataclasses.replace(mcfg, **changes) if changes else mcfg


def draw_prompts(cfg: LMRunConfig, vocab_size: int) -> list:
    """The run's prompts from its seed: lengths ``lens`` where given, else
    uniform in ``prompt_lens`` with the first rounded down to a multiple of
    ``first_multiple``; token ids uniform in [1, vocab)."""
    rng = np.random.default_rng(cfg.seed + 2)
    lens = rng.integers(cfg.prompt_lens[0], cfg.prompt_lens[1] + 1, size=cfg.requests)
    lens[0] -= lens[0] % cfg.first_multiple
    if cfg.lens:
        if len(cfg.lens) != cfg.requests:
            raise ValueError(f"{len(cfg.lens)} lengths for {cfg.requests} requests")
        lens = np.asarray(cfg.lens)
    return [rng.integers(1, vocab_size, size=int(n), dtype=np.int32) for n in lens]


def parallel_of(cfg: LMRunConfig):
    """The reference's production layout over a ``(data, model)`` mesh of
    the live group."""
    from repro_torch.launch import mesh as lmesh

    return lmesh.production_parallel(lmesh.device_mesh(cfg.mesh, AXES), moe_impl=cfg.moe_impl)


def _ep_owners(mcfg, d: int, moe_impl: str) -> bool:
    """Whether the layout deals the experts by owner over ``d`` dp ranks."""
    e = mcfg.num_experts
    return moe_impl == "ep" and e > 0 and d > 1 and (d % e == 0 or e % d == 0)


def design_collectives(mcfg, mesh: Sequence[int], kind: str, seq_len: int, batch: int,
                       cache_len: int, moe_impl: str = "ep") -> dict:
    """The collectives one call makes by the design, ``{kind: count}``
    (``kind`` "prefill" of ``batch`` prompts of ``seq_len``, or "decode" of
    ``batch`` slots), on a ``(data, model) = mesh`` layout with
    ``production_parallel``'s sequence parallelism:

    * the embedding: one sum over tp of the vocab blocks (a reduce-scatter
      under sequence parallelism);
    * a layer: the FSDP all-gather of its weight blocks over dp (one);
      attention (``attn``, ``swa``, ``local``): two sums over tp of the
      row-parallel products (``wo``, ``w_down``; reduce-scatters under
      sequence parallelism, which also all-gathers the two blocks'
      inputs), an all-gather of the q/k/v blocks that do not hold the heads
      the rank needs, and in decode over a sequence-sharded cache (or
      ring) the all-gather of the partial softmaxes;
      mLSTM: all-gathers of ``u`` and the gate blocks, the sum of squares of
      ``out_norm`` and the ``w_down`` sum, and an all-gather of each state
      whose cache block is not the rank's heads, once into the step and once
      out; sLSTM: the all-gather of the gate-major projection and the two
      sums; RG-LRU: the all-gather of ``uf``'s width blocks and the
      ``w_out`` sum, then its MLP's sum; an MoE where the experts are dealt
      by owner (``moe_impl="ep"``) and the rows do not divide over dp: the
      sum of the owners' parts over dp (where they divide, its rows travel
      through the exchange's rounds, counted apart);
    * the head: the all-gather of the vocab blocks, the FSDP gather of an
      untied ``lm_head``, and over dp the all-gather of a sharded batch's
      rows or the broadcast of a replicated one; a sequence-parallel
      prefill broadcasts the last position's row from the last tp rank.

    An encoder-decoder (:func:`_design_encdec`) has no sequence parallelism.
    Every call over an axis of one rank is absent."""
    if mcfg.is_encoder_decoder:
        return _design_encdec(mcfg, mesh, kind, batch, cache_len)
    d, t = mesh
    out: dict = {}

    def add(k, n=1):
        if n:
            out[k] = out.get(k, 0) + n

    attn_types = ("attn", "swa", "local")
    sp = (kind == "prefill" and t > 1 and seq_len % t == 0
          and all(bt in attn_types for bt in mcfg.block_pattern))
    owner_sum = _ep_owners(mcfg, d, moe_impl) and batch % d != 0
    tp_sum = "reduce_scatter" if sp else "all_reduce"
    vocab_split = t > 1 and mcfg.vocab_size % t == 0
    if vocab_split:
        add(tp_sum)
    for _ in range(mcfg.num_periods):
        if d > 1:
            add("all_gather")  # the layer's FSDP blocks
        for bt in mcfg.block_pattern:
            if bt in attn_types and owner_sum:
                add("all_reduce")
            if t == 1:
                continue
            if bt in attn_types:
                sublayers = 1 + int(mcfg.d_ff > 0)  # attention, and the MLP where there is one
                add(tp_sum, sublayers)
                if sp:
                    add("all_gather", sublayers)
                window = {"swa": mcfg.sliding_window, "local": mcfg.local_window}.get(bt)
                add("all_gather", _attn_gathers(mcfg, t, kind, cache_len, window))
            elif bt == "rglru":
                add("all_reduce", 1 + int(mcfg.d_ff > 0))
                add("all_gather", int(mcfg.rnn_width % t == 0))
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


def _attn_gathers(mcfg, t: int, kind: str, cache_len: int, window: Optional[int]) -> int:
    """An attention block's all-gathers over tp: the q/k/v blocks that do not
    hold the rank's heads, and in decode over a cache (or ring of
    ``min(window, cache_len)`` slots) split by positions every q head and
    the partial softmaxes."""
    h, kv, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim_
    heads_aligned = kv % t == 0
    span = cache_len if window is None else min(window, cache_len)
    seq_cache = not heads_aligned and span % t == 0 and span >= t
    kv_split, q_split = (kv * hd) % t == 0, (h * hd) % t == 0
    if kind == "prefill" or not seq_cache:
        return int(not heads_aligned and kv_split)
    return int(q_split or kv_split) + 1  # every q head over the rank's positions, the combine


def _design_encdec(mcfg, mesh: Sequence[int], kind: str, batch: int, cache_len: int) -> dict:
    """``design_collectives`` of an encoder-decoder (``models.encdec``): the
    embedding's sum over tp where the vocab splits; per encoder layer (a
    prefill's) and decoder layer the FSDP all-gather over dp; over tp an
    encoder layer's two row-parallel sums (attention, MLP) and a decoder
    layer's three (self-attention, cross-attention, MLP), with the q/k/v
    blocks' all-gathers where the heads do not line up (a decode step's
    self-attention as :func:`_attn_gathers` counts it, and over a cross
    cache split by frames the gather of every q head and the combine of the
    partial softmaxes); the head's vocab all-gather and over dp the rows'
    all-gather or broadcast."""
    d, t = mesh
    out: dict = {}

    def add(k, n=1):
        if n:
            out[k] = out.get(k, 0) + n

    vocab_split = t > 1 and mcfg.vocab_size % t == 0
    layers = mcfg.num_layers + (mcfg.encoder_layers if kind == "prefill" else 0)
    if vocab_split:
        add("all_reduce")
    if d > 1:
        add("all_gather", layers)
    if t > 1:
        add("all_reduce", 2 * mcfg.encoder_layers if kind == "prefill" else 0)
        add("all_reduce", 3 * mcfg.num_layers)
        gathers = _attn_gathers(mcfg, t, "prefill", 1, None)
        if kind == "prefill":
            add("all_gather", gathers * layers)
            add("all_gather", gathers * mcfg.num_layers)  # encoder k/v
        else:
            h, kv, hd, frames = (mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim_,
                                 mcfg.frontend_len)
            self_gathers = _attn_gathers(mcfg, t, "decode", cache_len, None)
            split = kv % t != 0 and frames % t == 0 and frames >= t
            cross_gathers = int((h * hd) % t == 0) + 1 if split else 0
            add("all_gather", (self_gathers + cross_gathers) * mcfg.num_layers)
    if vocab_split:
        add("all_gather")
    if d > 1:
        add("all_gather" if batch % d == 0 else "broadcast")
    return out


def design_loss_collectives(mcfg, mesh: Sequence[int], batch: int, seq_len: int,
                            moe_impl: str = "ep") -> dict:
    """The collectives one ``loss`` of ``batch`` rows of ``seq_len`` tokens
    makes by the design: a prefill's trunk (:func:`design_collectives`)
    with the rows split over dp where they divide, then the head over every
    position (the sequence blocks gathered under sequence parallelism, the
    vocab blocks gathered), the CE's sum over dp, and over dp the aux's
    one all-gather (EP: every rank's aux and drops) or one all-reduce of
    the routing sums (dense MoE on split rows).  The MoE's exchange rounds
    count apart."""
    d, t = mesh
    split = d > 1 and batch % d == 0
    out = design_collectives(mcfg, mesh, "prefill", seq_len, batch, seq_len, moe_impl)
    sp = (t > 1 and seq_len % t == 0 and not mcfg.is_encoder_decoder
          and all(bt in ("attn", "swa", "local") for bt in mcfg.block_pattern))

    def add(k, n):
        out[k] = out.get(k, 0) + n
        if not out[k]:
            del out[k]

    if d > 1:  # the prefill's logits over dp, not made by a loss
        add("all_gather" if batch % d == 0 else "broadcast", -1)
    if sp:  # the prefill's last row from the last tp rank; the loss gathers the sequence
        add("broadcast", -1)
        add("all_gather", 1)
    if d > 1:
        add("all_reduce", 1)  # the CE
    if mcfg.is_moe and d > 1:
        if _ep_owners(mcfg, d, moe_impl) and split:
            add("all_gather", 1)
        elif split:
            add("all_reduce", 1)
    return out


def _digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def _scoped_wall(fn, sync):
    """``(fn(), its seconds, its counting scope)``, synchronised on both sides."""
    sync()
    start = time.perf_counter()
    with counting.scoped() as scope:
        out = fn()
        sync()
    return out, time.perf_counter() - start, scope


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
    ``keep_model``).

    An encoder-decoder serves its requests as one batch instead
    (``_serve_encdec``: the stub frames of ``draw_frames``, prompts of one
    length)."""
    from repro_torch.distributed.parallel import single_device_parallel
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
    if mcfg.is_encoder_decoder:
        rec = _serve_encdec(cfg, bundle, params, prompts, dev, forced, sync)
        return _lm_result(cfg, bundle, params, prompts, rec, init_s, sharded, keep_logits,
                          keep_model)
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

    def timed_prefill(p, batch):
        uid = len(rec["prefill"])  # the batcher admits in submission order
        n = int(batch["tokens"].shape[1])
        (logits, cache), secs, scope = _scoped_wall(lambda: prefill(p, batch), sync)
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
        (logits, caches), secs, scope = _scoped_wall(lambda: decode(p, caches, token, pos), sync)
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
    rec["launches"] = dict(build.LAUNCHES)
    if len(done) != cfg.requests:
        raise RuntimeError(f"{len(done)} of {cfg.requests} requests finished")
    rec["tokens"] = {r.uid: list(r.out_tokens) for r in done}
    rec["total_s"] = total_s
    return _lm_result(cfg, bundle, params, prompts, rec, init_s, sharded, keep_logits, keep_model)


def draw_frames(cfg: LMRunConfig, frames: int, width: int,
                rows: Optional[int] = None) -> np.ndarray:
    """An encoder-decoder run's stub frames (rows, frames, width), f32
    standard normal from its seed; ``rows`` defaults to its requests."""
    rng = np.random.default_rng(cfg.seed + 4)
    n = cfg.requests if rows is None else rows
    return rng.standard_normal((n, frames, width)).astype(np.float32)


def _serve_encdec(cfg: LMRunConfig, bundle, params, prompts: list, dev, forced, sync) -> dict:
    """An encoder-decoder's serving run: every request's clip (``draw_frames``)
    and prompt (all of one length) in one batched prefill into caches of
    ``cfg.cache_len``, then ``max_new[0] - 1`` greedy decode steps of the
    whole batch (``forced``: the given tokens instead of the argmaxes).
    Each call's wall, collectives and bytes, as the batcher's run records."""
    from repro_torch.kernels import build

    mcfg = bundle.cfg
    lens = {len(p) for p in prompts}
    if len(lens) != 1:
        raise ValueError(f"an encoder-decoder run takes prompts of one length, got {sorted(lens)}")
    n = lens.pop()
    b = cfg.requests
    tokens = np.stack(prompts).astype(np.int32)
    frames = torch.as_tensor(draw_frames(cfg, mcfg.frontend_len, mcfg.d_model), device=dev)
    batch = {"tokens": tokens, "frames": frames}
    # Warm-up outside the counted run: a short prefill and one decode step.
    warm_len = min(8, n)
    _, warm = bundle.prefill(params, {"tokens": tokens[:, :warm_len], "frames": frames},
                             cache_len=warm_len + 1)
    bundle.decode_step(params, warm, tokens[:, :1], np.full((b,), warm_len, np.int32))
    del warm
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = {"prefill": [], "decode": [], "logits": {i: [] for i in range(b)},
           "tokens": {i: [] for i in range(b)}}

    def take(logits):
        host = logits.float().cpu().numpy()
        step = len(rec["tokens"][0])
        for i in range(b):
            rec["logits"][i].append(host[i])
            rec["tokens"][i].append(int(host[i].argmax()) if forced is None
                                    else int(forced[i][step]))
        return np.array([[rec["tokens"][i][-1]] for i in range(b)], np.int32)

    build.LAUNCHES.clear()
    start = time.perf_counter()
    (logits, caches), secs, scope = _scoped_wall(
        lambda: bundle.prefill(params, batch, cache_len=cfg.cache_len), sync)
    rec["prefill"].append({"uid": 0, "rows": b, "len": n, "s": secs, "path": "encoder-decoder",
                           "ttft_s": time.perf_counter() - start,
                           "collectives": dict(scope.collectives),
                           "bytes": dict(scope.collective_bytes)})
    token = take(logits)
    for t in range(cfg.max_new[0] - 1):
        pos = np.full((b,), n + t, np.int32)
        (logits, caches), secs, scope = _scoped_wall(
            lambda: bundle.decode_step(params, caches, token, pos), sync)
        rec["decode"].append({"live": b, "s": secs, "collectives": dict(scope.collectives),
                              "bytes": dict(scope.collective_bytes)})
        token = take(logits)
    rec["total_s"] = time.perf_counter() - start
    rec["launches"] = dict(build.LAUNCHES)
    return rec


def _lm_result(cfg: LMRunConfig, bundle, params, prompts, rec: dict, init_s: float,
               sharded: bool, keep_logits: bool, keep_model: bool) -> dict:
    """A serving run's figures on this rank (``run_lm``'s return)."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.distributed.parallel import mesh_shape

    mcfg, dev, parallel = bundle.cfg, bundle.device, bundle.parallel
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
        "tokens": rec["tokens"],
        "logit_digests": {uid: _digest(v) for uid, v in logits.items()},
        "prefill": rec["prefill"],
        "decode": rec["decode"],
        "param_bytes": sum(t.numel() * t.element_size() for t in params.parameters()),
        "shard_bytes": expect,
        "launches": rec["launches"],
        "init_s": init_s,
        "total_s": rec["total_s"],
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }
    if keep_logits:
        out["logits"] = logits
    if keep_model:
        out["bundle"], out["params"], out["prompts"] = bundle, params, prompts
    return out


def draw_loss_tokens(cfg: LMRunConfig, vocab_size: int, batch: int, seq: int) -> np.ndarray:
    """A loss run's global batch (batch, seq + 1) from its seed: token ids
    uniform in [1, vocab)."""
    rng = np.random.default_rng(cfg.seed + 3)
    return rng.integers(1, vocab_size, size=(batch, seq + 1), dtype=np.int32)


def run_loss(cfg: LMRunConfig, batch: int, seq: int, *, sharded: bool = True,
             stacked: Optional[int] = None, device=None, aux_coef: float = 0.01,
             timeout_s: Optional[float] = None) -> dict:
    """One forward loss of ``batch`` rows of ``seq`` tokens (drawn from the
    seed, the same on every rank; an encoder-decoder's with its stub frames,
    ``draw_frames``) through the model's ``loss`` on this rank
    (``sharded``: over the live group's mesh, each rank its rows), the
    weights drawn from ``cfg.seed``; ``stacked=D``: unsharded on this device
    through ``transformer.loss_ep_stacked`` over D shards.  Returns the
    metrics (``loss_rows``: the rank's row CE plus ``aux_coef`` times the
    aux; per shard when stacked), the exchange rounds and bytes a rank by
    label, the collectives, the parameter bytes beside
    ``shard_bytes_per_device`` and the experts a rank holds, wall and peak."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.distributed.parallel import mesh_shape, single_device_parallel
    from repro_torch.kernels import build
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model, resolve_device

    dev = resolve_device(device)
    mcfg = model_config(cfg)
    parallel = parallel_of(cfg) if sharded else single_device_parallel()
    bundle = build_model(mcfg, parallel, device=dev, timeout_s=timeout_s)
    params = bundle.init(cfg.seed)
    tokens = torch.as_tensor(draw_loss_tokens(cfg, mcfg.vocab_size, batch, seq), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.LAUNCHES.clear()
    sync()
    t0 = time.perf_counter()
    with counting.scoped() as scope:
        if stacked is not None:
            metrics = transformer.loss_ep_stacked(params, tokens, mcfg, stacked, aux_coef)
        else:
            inputs = {"tokens": tokens}
            if mcfg.is_encoder_decoder:  # its stub frames, one a row
                inputs["frames"] = torch.as_tensor(
                    draw_frames(cfg, mcfg.frontend_len, mcfg.d_model, batch), device=dev)
            _, metrics = bundle.loss(params, inputs)
            metrics["loss_rows"] = metrics["ce_rows"] + aux_coef * metrics["moe_aux"]
        sync()
    secs = time.perf_counter() - t0
    shapes = bundle.param_shapes()
    if sharded:
        specs = sharding.param_pspecs(shapes, parallel)
        expect = sharding.shard_bytes_per_device(shapes, specs, mesh_shape(parallel.mesh))
    else:
        expect = sum(t.numel() * t.element_size() for t in shapes.parameters())
    experts = [tuple(t.shape) for name, t in params.named_parameters() if ".moe.w_gate" in name]
    return {
        "rank": dist.get_rank() if sharded and dist.is_initialized() else 0,
        "mesh": tuple(cfg.mesh) if sharded else None,
        "stacked": stacked,
        "arch": mcfg.name,
        "layers": mcfg.num_layers,
        "moe_layers": mcfg.num_layers if mcfg.is_moe else 0,
        "batch": batch,
        "seq": seq,
        "device": str(dev),
        "metrics": {k: v.detach().cpu().numpy() for k, v in metrics.items()},
        "rounds": dict(scope.rounds),
        "round_bytes": dict(scope.round_bytes),
        "collectives": dict(scope.collectives),
        "collective_bytes": dict(scope.collective_bytes),
        "param_bytes": sum(t.numel() * t.element_size() for t in params.parameters()),
        "shard_bytes": expect,
        "expert_shapes": experts[:1],
        "launches": dict(build.LAUNCHES),
        "s": secs,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


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
    parser.add_argument("--moe-impl", default="ep", choices=("ep", "dense"))
    parser.add_argument("--loss", type=_ints, default=None,
                        help="batch,seq: one forward loss instead of serving")
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
        max_new=(args.max_new,), seed=args.seed, moe_impl=args.moe_impl,
    )
    try:
        if args.loss is not None:
            out = run_loss(cfg, *args.loss, device=device, timeout_s=args.timeout)
            loss = out["metrics"]["loss"]
            same = group.same([int(np.asarray(loss, np.float32).view(np.int32))])
            print(json.dumps({"backend": group.backend, "loss_equal_on_every_rank": same, **out},
                             default=lambda v: v.tolist() if hasattr(v, "tolist") else str(v)),
                  flush=True)
            if not same:
                raise RuntimeError("the ranks computed different losses")
            return 0
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
