"""Manual data-parallel train step with the int8-compressed gradient
all-reduce (port of ``repro.train.manual_dp``).

Unlike the GSPMD-style step (``train.step`` over a mesh), where the model's
collectives reduce the gradients, this step runs the unsharded model on
each rank's rows and reduces the gradients itself, leaf by leaf, through
``optim.compress.compressed_psum_int8`` over the dp axis: the wire carries
int8 (one byte a gradient element a hop, and a scale a chunk), about a
quarter of an f32 all-reduce's bytes.  Error feedback is carried per rank
in ``opt_state["ef_error"]`` (bf16, updated in place, as AdamW's moments
are).  Without ``grad_compression`` each
leaf is mean-reduced by a plain f32 all-reduce.

Params and optimizer state are replicated (classic DP): each rank holds the
whole f32 masters, 16 bytes a parameter with the moments and the
gradient.  This is the configuration the paper's "communication primitives
that are prohibitive in distributed settings" argument maps to: dense
all-to-alls on a fast fabric beat sparse parameter-server schemes.
"""
from __future__ import annotations

import torch

from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compressed_psum_int8, dequantize_int8, quantize_int8)
from repro_torch.train.step import METRICS, OPTIMIZER_RANGE, TrainStepConfig


def make_manual_dp_train_state(bundle, tcfg: TrainStepConfig, seed: int) -> tuple:
    """``(params, opt_state)`` replicated on every rank: the whole f32 masters
    drawn from ``seed`` (the same on every rank), the AdamW state and a zero
    bf16 ``ef_error``."""
    from repro_torch.models import transformer

    gen = torch.Generator(device=bundle.device).manual_seed(int(seed))
    params = transformer.trainable_params(transformer.init_params(
        bundle.cfg, gen, device=bundle.device, dtype=torch.float32))
    opt_state = adamw_init(params, tcfg.adamw)
    opt_state["ef_error"] = {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                             for n, p in params.named_parameters()}
    return params, opt_state


def make_manual_dp_train_step(bundle, tcfg: TrainStepConfig):
    """The step ``(params, opt_state, batch) -> (params, opt_state, metrics)``
    over the bundle's dp axis (``bundle.layout.dp``): ``batch["tokens"]`` is
    the global batch, of which each rank takes its dp block of rows; the
    metrics are the mean over dp, the grad norm that of the reduced
    gradient."""
    from repro_torch.models import transformer

    parallel = bundle.parallel
    if parallel is None or parallel.mesh is None:
        raise ValueError("the manual data-parallel step runs over a mesh")
    cfg, dp = bundle.cfg, bundle.layout.dp
    compress = parallel.grad_compression

    def reduce_leaf(g: torch.Tensor, e: torch.Tensor):
        gf = g.float()  # the f32 master's gradient itself: updated in place
        if not compress:
            return dp.all_reduce(gf) / dp.size, e
        gf.add_(e)
        sent = dequantize_int8(*quantize_int8(gf))
        total = compressed_psum_int8(sent, dp)
        return total, e.copy_(gf.sub_(sent))  # the residual, in place

    def step(params, opt_state, batch):
        tokens = torch.as_tensor(batch["tokens"], device=bundle.device)
        if tokens.shape[0] % dp.size:
            raise ValueError(f"batch {tokens.shape[0]} does not divide over {dp.size} dp ranks")
        local = dp.block(tokens, 0)
        named = dict(params.named_parameters())
        loss, metrics = transformer.loss_fn(params, {"tokens": local}, cfg,
                                            remat=parallel.remat)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        del loss
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            ef = opt_state.get("ef_error")
            if ef is None:
                ef = {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                      for n, p in named.items()}
            new_ef = {}
            for n in list(grads):
                total, new_ef[n] = reduce_leaf(grads[n], ef[n])
                grads[n] = total.to(grads[n].dtype)
            grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
            lr = tcfg.lr_at(opt_state["step"] + 1)
            _, new_opt = adamw_update(named, grads,
                                      {k: opt_state[k] for k in ("step", "m", "v")}, lr,
                                      tcfg.adamw)
            del grads
        new_opt["ef_error"] = new_ef
        means = dp.all_reduce(torch.stack([metrics[m].detach().float() for m in METRICS])) / dp.size
        out = dict(zip(METRICS, means))
        out.update(grad_norm=gnorm, lr=lr)
        return params, new_opt, out

    return step
