"""GPipe-style pipeline parallelism over a mesh axis, dense archs (port of
``repro.train.pipeline``).

The layer stack is split across the ``stage`` axis: each stage owns
``num_periods / S`` contiguous periods (the reference's stacked
``params["layers"]`` sharded on the stage axis; the port's stage holds
them as its own ``layers`` list).  A step runs ``M + S - 1`` ticks; at tick
``t`` stage ``s`` runs microbatch ``t - s`` through its periods (each under
remat), then hands its f32 activation to stage ``s + 1`` with
``collectives.ppermute``, whose backward sends the gradient the other way:
autograd runs the reversed schedule through the same hops.  Stage 0 embeds
microbatch ``t`` at the first M ticks and takes zeros in the drain ticks;
the last stage's head scores microbatch ``t - (S - 1)`` once it arrives;
ticks outside a stage's microbatches (the bubble, ``(S-1)/(M+S-1)`` of
them) run its periods on what arrives, as in the reference, and never
reach the loss.

Embedding, head and final norm are replicated on every stage; their
gradients are summed over the stage axis.  The loss is the mean of the
microbatches' ce on the last stage, shared with every stage.

**A deliberate difference from the reference:** the port's gradients are
those of the mean loss, equal to the single-device gradients, and
``grad_norm`` is the global norm over every stage's blocks (each counted
once).  The reference's ``psum`` of the loss inside its ``shard_map``
transposes into a second sum over stages, which scales its gradients by
the stage count, and its ``grad_norm`` is each stage's local norm; Adam's
first step is nearly invariant to that scale, so its own check cannot see
it.
"""
from __future__ import annotations

import torch

from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.train.step import OPTIMIZER_RANGE, TrainStepConfig


def pipeline_param_specs(stage_axis: str):
    """The spec of a top-level parameter key: ``layers`` on the stage axis,
    everything else replicated (the reference's in_specs hint)."""

    def spec_for(path_key: str):
        return (stage_axis,) if path_key == "layers" else ()

    return spec_for


def _stage_axis(bundle, stage_axis: str, timeout_s=None):
    from repro_torch.distributed import collectives
    from repro_torch.distributed.parallel import mesh_shape

    parallel = bundle.parallel
    if parallel is None or parallel.mesh is None:
        raise ValueError("the pipeline runs over a mesh with a stage axis")
    if bundle.cfg.is_moe:
        raise ValueError("the pipeline covers dense archs; MoE uses expert parallelism")
    stages = mesh_shape(parallel.mesh)[stage_axis]
    if bundle.cfg.num_periods % stages:
        raise ValueError(f"{bundle.cfg.num_periods} periods not divisible by {stages} stages")
    return collectives.axis_of(parallel.mesh, (stage_axis,), timeout_s)


def stage_periods(cfg, stages: int, stage: int) -> range:
    """The global periods stage ``stage`` of ``stages`` owns."""
    n = cfg.num_periods // stages
    return range(stage * n, (stage + 1) * n)


def stage_params(params, stages: int, stage: int):
    """A stage's parameters of a whole model ``params``: its periods (as its
    own ``layers``, numbered from 0) and the replicated leaves, sharing the
    tensors."""
    from torch import nn

    from repro_torch.models import transformer

    cfg = params.cfg
    mine = list(stage_periods(cfg, stages, stage))
    model = transformer.Transformer(cfg, dtype=params.embed.dtype, device="meta")
    model.layers = nn.ModuleList(params.layers[i] for i in mine)
    for name in ("embed", "final_norm", "lm_head"):
        if hasattr(params, name):
            setattr(model, name, getattr(params, name))
    return model


def make_pp_train_state(bundle, tcfg: TrainStepConfig, seed: int, *,
                        stage_axis: str = "stage") -> tuple:
    """``(params, opt_state)`` of this rank's stage: its periods and the
    replicated leaves of the whole f32 masters drawn from ``seed``, and
    their AdamW state."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.parallel import mesh_shape
    from repro_torch.models import transformer

    stages = mesh_shape(bundle.parallel.mesh)[stage_axis]
    stage = collectives.coordinate(bundle.parallel.mesh)[stage_axis]
    gen = torch.Generator(device=bundle.device).manual_seed(int(seed))
    whole = transformer.trainable_params(transformer.init_params(
        bundle.cfg, gen, device=bundle.device, dtype=torch.float32))
    params = stage_params(whole, stages, stage)
    del whole
    return params, adamw_init(params, tcfg.adamw)


def make_pp_value_and_grad(bundle, *, stage_axis: str = "stage", num_microbatches: int = 4,
                           timeout_s=None):
    """``value_and_grad(params, tokens) -> (loss, grads)`` of this rank's
    stage: the pipelined forward and backward of the global batch
    ``tokens`` cut into ``num_microbatches`` consecutive row blocks.  ``loss``
    is the mean ce over the microbatches, the same on every stage;
    ``grads`` (f32, by the stage's names) are its gradients, the
    replicated leaves' summed over the stages (one all-reduce).  The
    function's ``axis`` attribute is the stage axis."""
    from repro_torch.distributed import collectives
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm

    cfg, m = bundle.cfg, num_microbatches
    axis = _stage_axis(bundle, stage_axis, timeout_s)
    s_stages, stage = axis.size, axis.index
    first, last = stage == 0, stage == s_stages - 1
    remat = bundle.parallel.remat
    dt = tfm.compute_dtype(cfg)

    def run_periods(params, x, positions):
        for period in params.layers:
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    tfm._period_train, period, x, positions, cfg, L.SINGLE, False,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x = tfm._period_train(period, x, positions, cfg, L.SINGLE, False)
        return x

    def head_ce(params, y, labels):
        return L.softmax_cross_entropy_logits(tfm._head(params, y, cfg), labels)

    def pipelined_loss(params, tokens):
        b, sp1 = tokens.shape
        if b % m:
            raise ValueError(f"batch {b} % microbatches {m}")
        mb, seq = b // m, sp1 - 1
        toks = tokens.reshape(m, mb, sp1)
        positions = tfm._positions(mb, seq, tokens.device)
        zeros = torch.zeros((mb, seq, cfg.d_model), dtype=torch.float32, device=tokens.device)
        x_in, loss = zeros, None
        for t in range(m + s_stages - 1):
            x = x_in.to(dt)
            if first:  # x_in is zeros on stage 0: nothing is sent to it
                x = x + (tfm._embed(params, toks[t, :, :-1], cfg) if t < m else zeros.to(dt))
            y = run_periods(params, x, positions)
            idx = t - (s_stages - 1)
            if last and 0 <= idx < m:
                ce = (torch.utils.checkpoint.checkpoint(
                    head_ce, params, y, toks[idx, :, 1:], use_reentrant=False,
                    preserve_rng_state=False) if remat else head_ce(params, y, toks[idx, :, 1:]))
                loss = ce if loss is None else loss + ce
            if t < m + s_stages - 2:
                x_in = collectives.ppermute(axis, y.float(), 1)
        # Every stage's root reaches its last tick's activation, so every
        # stage runs the whole chain of hops backward, in the same order.
        anchor = (y.float() * 0.0).sum()
        local = loss / m if loss is not None else torch.zeros((), device=tokens.device)
        return local + anchor

    def value_and_grad(params, tokens):
        named = dict(params.named_parameters())
        objective = pipelined_loss(params, tokens)
        grads = dict(zip(named, torch.autograd.grad(objective, list(named.values()),
                                                    allow_unused=True)))
        grads = {n: (g if g is not None else torch.zeros_like(named[n])).float()
                 for n, g in grads.items()}
        shared = [n for n in grads if not n.startswith("layers.")]
        summed = axis.all_reduce(torch.cat([grads[n].reshape(-1) for n in shared]))
        at = 0
        for n in shared:
            size = grads[n].numel()
            grads[n] = summed[at:at + size].reshape(grads[n].shape)
            at += size
        loss = axis.all_reduce(objective.detach().reshape(1))[0]  # the last stage's
        return loss, grads

    value_and_grad.axis = axis
    return value_and_grad


def make_pp_train_step(bundle, tcfg: TrainStepConfig, *, stage_axis: str = "stage",
                       num_microbatches: int = 4, timeout_s=None):
    """The step ``(params, opt_state, batch) -> (params, opt_state, metrics)``
    of this rank's stage (``make_pp_train_state``'s params).  ``batch
    ["tokens"]`` is the global batch on every stage, cut into
    ``num_microbatches`` consecutive row blocks.  Metrics, the same on every
    stage: ``loss`` = ``ce`` (the mean over the microbatches), ``moe_aux``
    0, ``grad_norm`` (global, before the clip) and ``lr``."""
    value_and_grad = make_pp_value_and_grad(bundle, stage_axis=stage_axis,
                                            num_microbatches=num_microbatches,
                                            timeout_s=timeout_s)
    axis = value_and_grad.axis

    def step(params, opt_state, batch):
        tokens = torch.as_tensor(batch["tokens"], device=bundle.device)
        named = dict(params.named_parameters())
        loss, grads = value_and_grad(params, tokens)
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            # each distinct block once: a stage's periods, the replicated leaves on stage 0
            counted = {n: n.startswith("layers.") or axis.index == 0 for n in grads}
            grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm, counted=counted, axis=axis)
            lr = tcfg.lr_at(opt_state["step"] + 1)
            _, new_opt = adamw_update(named, grads,
                                      {k: opt_state[k] for k in ("step", "m", "v")}, lr,
                                      tcfg.adamw)
            del grads
        metrics = {"loss": loss, "ce": loss,
                   "moe_aux": torch.zeros((), dtype=torch.float32, device=loss.device),
                   "grad_norm": gnorm, "lr": lr}
        return params, new_opt, metrics

    return step
