"""The train step (port of ``repro.train.step``): gradient accumulation
over microbatches, remat, optional int8 error feedback, clipping, the
schedule and AdamW, on one card.

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

Metrics are f32 scalar tensors on the card: ``loss``, ``ce``, ``moe_aux``,
``grad_norm``, ``lr`` and ``tokens``.  The optimizer's part runs inside the
profiler range ``OPTIMIZER_RANGE``.  A ``parallel`` with a mesh raises
``NotImplementedError``: training over a mesh is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed.parallel import TRAIN_MESH_SLICE
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


def _check_single_card(bundle) -> None:
    parallel = bundle.parallel
    if parallel is not None and parallel.mesh is not None:
        raise NotImplementedError(f"training over a mesh belongs to {TRAIN_MESH_SLICE}")


def make_train_state(bundle, tcfg: TrainStepConfig, seed: int) -> tuple[Any, dict]:
    """``(params, opt_state)`` on the bundle's device: f32 masters drawn from
    ``seed`` (``bundle.init_train``) and the AdamW state, with the
    error-feedback residual where ``parallel.grad_compression``."""
    _check_single_card(bundle)
    params = bundle.init_train(seed)
    opt_state = adamw_init(params, tcfg.adamw)
    if bundle.parallel is not None and bundle.parallel.grad_compression:
        opt_state["ef_error"] = {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                                 for n, p in params.named_parameters()}
    return params, opt_state


def make_train_step(bundle, tcfg: TrainStepConfig) -> Callable[[Any, dict, dict], tuple]:
    _check_single_card(bundle)
    parallel = bundle.parallel
    k = parallel.microbatches if parallel is not None else 1
    compress = parallel is not None and parallel.grad_compression

    def value_and_grad(params, names, leaves, tokens):
        loss, metrics = bundle.loss(params, {"tokens": tokens})
        grads = torch.autograd.grad(loss, leaves)
        return {m: metrics[m].detach().float() for m in METRICS}, dict(zip(names, grads))

    def train_step(params, opt_state, batch):
        tokens = torch.as_tensor(batch["tokens"], device=bundle.device)
        named = {n: p for n, p in params.named_parameters() if p.requires_grad}
        names, leaves = list(named), list(named.values())
        if k > 1:
            b = tokens.shape[0]
            if b % k:
                raise ValueError(f"batch {b} not divisible by microbatches {k}")
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in named.items()}
            metrics = {m: torch.zeros((), dtype=torch.float32, device=tokens.device)
                       for m in METRICS}
            for mb in tokens.reshape(k, b // k, *tokens.shape[1:]):
                mb_metrics, mb_grads = value_and_grad(params, names, leaves, mb)
                for n, g in mb_grads.items():
                    grads[n].add_(g.float() / k)
                del mb_grads
                for m in METRICS:
                    metrics[m] = metrics[m] + mb_metrics[m] / k
        else:
            metrics, grads = value_and_grad(params, names, leaves, tokens)
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
        metrics.update(grad_norm=gnorm, lr=lr,
                       tokens=torch.tensor(float(tokens.shape[0] * (tokens.shape[1] - 1)),
                                           dtype=torch.float32, device=tokens.device))
        return params, new_opt, metrics

    return train_step
