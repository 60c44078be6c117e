"""The train step (port of ``repro.train.step``): gradient accumulation
over microbatches, remat, optional int8 error feedback, clipping, the
schedule and AdamW, on one card or over a mesh of ranks.

``make_train_step(bundle, tcfg)`` returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

where ``params`` are the bundle's f32 masters (``bundle.init_train``),
updated in place, and ``opt_state`` the AdamW state (``adamw_init``):

* the batch's rows split into ``parallel.microbatches`` equal parts, run
  one after another (one part's activations live at a time); each part's
  gradients are added in f32 divided by k into one buffer a parameter, and
  its metrics likewise;
* with ``parallel.grad_compression`` the accumulated gradients go through
  ``error_feedback_compress`` with the residual in ``opt_state["ef_error"]``
  (bf16, as in the reference);
* global-norm clip, the learning rate of step ``opt_state["step"] + 1``
  (the schedule counts from 1) and AdamW.

Over a mesh (a bundle built with a ``ParallelConfig`` whose mesh spans the
process group) the step is the reference's GSPMD step, written out: every
rank takes the same global batch, and

* the masters, their gradients' accumulator and the AdamW moments are the
  rank's blocks of each parameter's spec (ZeRO-3 with tensor parallelism;
  ``make_train_state`` builds them);
* once a step the f32 matrices are cast to a bf16 compute copy
  (``transformer.compute_copy``, the reference's ``_compute_copy``): the
  FSDP gathers and the gradient reductions move bf16 (an MoE stack keeps
  its f32 masters, as the reference's step does);
* microbatch j is rows [j b/k, (j+1) b/k) of the global batch, of which
  each rank takes its dp block (the reference's ``_split_microbatches``);
* each microbatch's gradients come back reduced over dp into the rank's
  blocks: the FSDP gather's backward reduce-scatters the dp-sharded
  leaves, and the leaves whole over dp are all-reduced (one call a dtype);
  tp's reductions are the model's collectives' backward passes;
* error feedback quantizes each block with its whole leaf's scale, the
  clip's norm counts each distinct block once over the group, and AdamW
  updates the rank's blocks.

A mesh of one rank runs the one-card step.

Under expert parallelism (``moe_impl="ep"``) a rank's expert stacks are
the experts it owns (``sharding.Owners``): their gradients come whole from
the rows the rank received through the exchange, so they take no
reduction over dp; where more ranks than experts repeat each expert, the
repeats' gradients are summed over them.  :func:`make_ep_stacked_train_step`
is the step's stacked twin on one device, every shard's rows on the card
and the MoE's exchange over ``StackedGroup`` (the ranks' oracle).

The batch is ``{"tokens": (B, S+1)}`` with, for an encoder-decoder, its
stub ``"frames"`` (B, T, d): every entry is cut into the same microbatch
rows.

Metrics are f32 scalar tensors on the card, the same on every rank:
``loss``, ``ce``, ``moe_aux``, ``grad_norm``, ``lr`` and ``tokens``, and
for an MoE stack on the compute copy's step ``moe_dropped`` (the (token,
expert) rows the EP layers dropped, summed over the step).  The
optimizer's part runs inside the profiler range ``OPTIMIZER_RANGE``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed.parallel import mesh_shape
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    error_feedback_compress,
    warmup_cosine,
)

METRICS = ("loss", "ce", "moe_aux")
# The profiler range around error feedback, the clip and AdamW.
OPTIMIZER_RANGE = "train.optimizer"


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    adamw: AdamWConfig = AdamWConfig()
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0

    def lr_at(self, step):
        return warmup_cosine(step, peak_lr=self.peak_lr, warmup_steps=self.warmup_steps,
                             total_steps=self.total_steps)


def on_mesh(bundle) -> bool:
    """Whether ``bundle`` is one rank's part of a model sharded over a mesh
    of more than one rank.  Raises ``ValueError`` for a mesh of several
    devices the bundle was not built over (``build_model(cfg, parallel)`` on
    every rank binds it)."""
    parallel, lay = bundle.parallel, bundle.layout
    if parallel is None or parallel.mesh is None:
        return False
    size = math.prod(mesh_shape(parallel.mesh).values())
    if size > 1 and not lay.sharded:
        raise ValueError(f"the bundle's mesh of {size} devices is not bound to a process group: "
                         "build it with build_model(cfg, parallel) on every rank of the group")
    return lay.sharded


def train_state_specs(bundle) -> dict:
    """Dotted name → spec of every leaf of ``{"params": params, "opt":
    opt_state}`` as ``make_train_state`` builds them over the bundle's mesh
    (``sharding.opt_state_pspecs``)."""
    from repro_torch.distributed import sharding

    pspecs = bundle.layout.specs
    compress = bool(bundle.parallel is not None and bundle.parallel.grad_compression)
    return sharding.flat_pspecs({"params": pspecs,
                                 "opt": sharding.opt_state_pspecs(pspecs, compress)})


def make_train_state(bundle, tcfg: TrainStepConfig, seed: int) -> tuple[Any, dict]:
    """``(params, opt_state)`` on the bundle's device: f32 masters drawn from
    ``seed`` (``bundle.init_train``; over a mesh the rank's blocks) and the
    AdamW state of the same blocks, with the error-feedback residual where
    ``parallel.grad_compression``."""
    on_mesh(bundle)
    params = bundle.init_train(seed)
    opt_state = adamw_init(params, tcfg.adamw)
    if bundle.parallel is not None and bundle.parallel.grad_compression:
        opt_state["ef_error"] = {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                                 for n, p in params.named_parameters()}
    return params, opt_state


def _microbatches(batch: dict, k: int) -> list:
    """``batch``'s entries cut into ``k`` equal parts of rows, as dicts."""
    b = batch["tokens"].shape[0]
    if b % k:
        raise ValueError(f"batch {b} not divisible by microbatches {k}")
    parts = {n: t.reshape(k, b // k, *t.shape[1:]) for n, t in batch.items()}
    return [{n: t[j] for n, t in parts.items()} for j in range(k)]


def _on_device(batch: dict, device) -> dict:
    """The step's inputs on ``device``: the tokens and, where given, an
    encoder-decoder's frames."""
    return {n: torch.as_tensor(batch[n], device=device)
            for n in ("tokens", "frames") if batch.get(n) is not None}


def _tokens_metric(tokens: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(tokens.shape[0] * (tokens.shape[1] - 1)), dtype=torch.float32,
                        device=tokens.device)


def make_train_step(bundle, tcfg: TrainStepConfig) -> Callable[[Any, dict, dict], tuple]:
    if on_mesh(bundle):
        return _make_mesh_step(bundle, tcfg)
    parallel = bundle.parallel
    k = parallel.microbatches if parallel is not None else 1
    compress = parallel is not None and parallel.grad_compression

    def value_and_grad(params, names, leaves, inputs):
        loss, metrics = bundle.loss(params, inputs)
        grads = torch.autograd.grad(loss, leaves)
        return {m: metrics[m].detach().float() for m in METRICS}, dict(zip(names, grads))

    def train_step(params, opt_state, batch):
        inputs = _on_device(batch, bundle.device)
        tokens = inputs["tokens"]
        named = {n: p for n, p in params.named_parameters() if p.requires_grad}
        names, leaves = list(named), list(named.values())
        if k > 1:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in named.items()}
            metrics = {m: torch.zeros((), dtype=torch.float32, device=tokens.device)
                       for m in METRICS}
            for mb in _microbatches(inputs, k):
                mb_metrics, mb_grads = value_and_grad(params, names, leaves, mb)
                for n, g in mb_grads.items():
                    grads[n].add_(g.float() / k)
                del mb_grads
                for m in METRICS:
                    metrics[m] = metrics[m] + mb_metrics[m] / k
        else:
            metrics, grads = value_and_grad(params, names, leaves, inputs)
            grads = {n: g.float() for n, g in grads.items()}
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            if compress:
                grads, new_err = error_feedback_compress(grads, opt_state["ef_error"])
            grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
            lr = tcfg.lr_at(opt_state["step"] + 1)
            _, new_opt = adamw_update(named, grads,
                                      {kk: opt_state[kk] for kk in ("step", "m", "v")}, lr,
                                      tcfg.adamw)
            del grads
        if compress:
            new_opt["ef_error"] = new_err
        metrics.update(grad_norm=gnorm, lr=lr, tokens=_tokens_metric(tokens))
        return params, new_opt, metrics

    return train_step


def _dp_entry(lay, spec) -> Optional[object]:
    """The entry of ``spec`` on the dp axes: their tuple, an
    ``sharding.Owners`` over them, or None (whole over dp)."""
    from repro_torch.distributed import sharding

    dp = tuple(lay.parallel.dp_axes)
    for e in spec:
        if isinstance(e, sharding.Owners):
            return e
        if e is not None and tuple((e,) if isinstance(e, str) else e) == dp:
            return e
    return None


def reduce_whole_over_dp(lay, grads: dict) -> dict:
    """All-reduce over dp the gradients of the leaves whole over dp (each dp
    rank's holds its rows' part), one call a dtype; the dp-sharded leaves'
    come back reduced from the FSDP gather's backward.  A rank's owned
    experts (``sharding.Owners``) hold their whole gradient; where the dp
    ranks outnumber the experts, each expert's repeats sum theirs (one more
    all-reduce a dtype)."""
    from repro_torch.distributed import sharding

    if lay.dp.size == 1:
        return grads
    entries = {n: _dp_entry(lay, lay.specs[n]) for n in grads}
    whole = [n for n in grads if entries[n] is None]
    out = _all_reduce_packed(lay.dp, grads, whole)
    repeated = [n for n in grads if isinstance(entries[n], sharding.Owners)
                and lay.dp.size > entries[n].experts]
    if repeated:  # rank r holds expert r % E: scatter into E slots, sum, take its own
        placed = {}
        for n in repeated:
            e = entries[n].experts
            slots = torch.zeros((e,) + tuple(grads[n].shape[1:]), dtype=grads[n].dtype,
                                device=grads[n].device)
            slots[lay.dp.index % e] = grads[n][0]
            placed[n] = slots
        summed = _all_reduce_packed(lay.dp, placed, repeated)
        for n in repeated:
            out[n] = summed[n][lay.dp.index % entries[n].experts][None]
    return out


def _all_reduce_packed(axis, grads: dict, names) -> dict:
    """``grads`` with the leaves ``names`` all-reduced over ``axis``, packed
    into one call a dtype."""
    by_dtype: dict = {}
    for n in names:
        by_dtype.setdefault(grads[n].dtype, []).append(n)
    out = dict(grads)
    for group in by_dtype.values():
        summed = axis.all_reduce(torch.cat([grads[n].reshape(-1) for n in group]))
        at = 0
        for n in group:
            size = grads[n].numel()
            out[n] = summed[at:at + size].reshape(grads[n].shape)
            at += size
    return out


def _copy_step(bundle, tcfg: TrainStepConfig, k: int, loss_of, reduce, counted, axis,
               compress: bool):
    """A step on the bf16 compute copy of the f32 masters (``_make_mesh_step``
    and its stacked EP twin): ``loss_of(copy, microbatch)`` gives ``(loss,
    metrics)``, ``reduce(grads)`` the gradients' reductions, ``counted`` and
    ``axis`` the clip's block counting."""
    from repro_torch.models import transformer

    def train_step(params, opt_state, batch):
        inputs = _on_device(batch, bundle.device)
        tokens = inputs["tokens"]
        named = dict(params.named_parameters())
        copy = transformer.compute_copy(params, cast=not bundle.cfg.is_moe)
        leaves = dict(copy.named_parameters())
        names = list(leaves)
        grads = {}  # f32 sums of the microbatches' gradients over k (one microbatch: its own)
        metrics = {m: torch.zeros((), dtype=torch.float32, device=tokens.device) for m in METRICS}
        for mb in _microbatches(inputs, k):
            loss, mb_metrics = loss_of(copy, mb)
            # An expert that got no rows this microbatch has no gradient: zero.
            got = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
            mb_grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                        for n, g in zip(names, got)}
            for n, g in reduce(mb_grads).items():
                if k == 1:
                    grads[n] = g.float()
                    continue
                if n not in grads:
                    grads[n] = torch.zeros(named[n].shape, dtype=torch.float32,
                                           device=named[n].device)
                grads[n].add_(g.float() / k)
            del mb_grads, loss, got
            for m in METRICS:
                metrics[m] = metrics[m] + mb_metrics[m].detach().float() / k
            if "moe_dropped" in mb_metrics:  # rows the EP layers dropped, summed
                dropped = mb_metrics["moe_dropped"].detach().sum().float()
                metrics["moe_dropped"] = metrics.get("moe_dropped", 0) + dropped
        del copy, leaves
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            if compress:
                grads, new_err = error_feedback_compress(grads, opt_state["ef_error"], axis=axis)
            grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm, counted=counted, axis=axis)
            lr = tcfg.lr_at(opt_state["step"] + 1)
            _, new_opt = adamw_update(named, grads,
                                      {kk: opt_state[kk] for kk in ("step", "m", "v")}, lr,
                                      tcfg.adamw)
            del grads
        if compress:
            new_opt["ef_error"] = new_err
        metrics.update(grad_norm=gnorm, lr=lr, tokens=_tokens_metric(tokens))
        return params, new_opt, metrics

    return train_step


def _make_mesh_step(bundle, tcfg: TrainStepConfig):
    from repro_torch.distributed import collectives, sharding

    lay, parallel = bundle.layout, bundle.parallel
    counted = {n: sharding.counts_block(spec, parallel.mesh, lay.coord)
               for n, spec in lay.specs.items()}
    return _copy_step(bundle, tcfg, parallel.microbatches, bundle.loss,
                      lambda grads: reduce_whole_over_dp(lay, grads), counted,
                      collectives.world(), parallel.grad_compression)


def make_ep_stacked_train_step(bundle, tcfg: TrainStepConfig, shards: int,
                               aux_coef: float = 0.01):
    """The stacked twin of the EP train step over ``shards`` dp ranks
    (``moe_impl="ep"`` on a ``(shards, 1)`` mesh), on one device with an
    unsharded ``bundle``: the same compute copy (f32 for an MoE stack), each microbatch's rows
    split over the shards, every block but the MoE run on each shard's rows
    alone and the MoE exchanged over ``StackedGroup(shards)``
    (``transformer.loss_ep_stacked``); its gradients are the whole model's,
    so nothing is reduced.  The ranks' oracle: a rank's owned experts get
    the gradients this step gives them, bit for bit."""
    from repro_torch.models import transformer

    cfg = bundle.cfg
    k = bundle.parallel.microbatches if bundle.parallel is not None else 1

    def loss_of(copy, mb):
        m = transformer.loss_ep_stacked(copy, mb["tokens"], cfg, shards, aux_coef)
        return m["loss"], m

    return _copy_step(bundle, tcfg, k, loss_of, lambda grads: grads, None, None, False)
