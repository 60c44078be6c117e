"""Unified model API: build init/prefill/decode closures per arch (port of
``repro.models.api``).

``build_model(cfg, parallel, device=...)`` returns a :class:`ModelBundle`
whose members are functions over a parameter module.  Decoder-only models.
``init`` draws the serving copy (compute type, no gradients);
``init_train`` the f32 masters a trainer updates, and ``loss`` is the
reference's ``loss_fn`` over either.
``device=None`` means the CUDA card and raises without one; ``"cpu"`` runs
every kernel's plain twin.

With a ``ParallelConfig`` whose mesh spans the process group, the bundle's
functions are one rank's part of the sharded model: ``init`` keeps the
rank's block of every parameter, ``init_cache`` allocates the rank's block
of every cache (``distributed.sharding``), and ``prefill`` /
``decode_step`` / ``forward_train`` issue the collectives that make their
logits the unsharded model's, whole on every rank.  ``parallel=None`` or
``single_device_parallel()`` is the unsharded model.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.parallel import ParallelConfig
from repro_torch.models import layers, transformer


def resolve_device(device) -> torch.device:
    """``None`` → the CUDA card (raises without one); else ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the LM runs on the CUDA card by default and none is available; "
                "pass device='cpu' for the plain path"
            )
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init: Callable[[int], transformer.Transformer]
    prefill: Callable[..., tuple]
    decode_step: Callable[..., tuple]
    init_cache: Callable[[int, int], dict]
    forward_train: Callable[..., tuple]
    loss: Callable[..., tuple]
    init_train: Callable[[int], transformer.Transformer]
    parallel: Optional[ParallelConfig] = None
    layout: layers.Layout = layers.SINGLE

    def param_shapes(self) -> transformer.Transformer:
        """The whole parameters on the meta device (the port's dtypes)."""
        return transformer.Transformer(self.cfg, dtype=transformer.compute_dtype(self.cfg),
                                       device="meta")


def build_model(cfg: ArchConfig, parallel: Optional[ParallelConfig] = None, *, device=None,
                timeout_s: Optional[float] = None) -> ModelBundle:
    """Closures of a decoder-only model on ``device``.

    ``init(seed)`` draws the parameters on the device from a
    ``torch.Generator`` seeded with ``seed``; ``prefill(params, {"tokens":
    (B, L)}, cache_len)`` → (logits (B, V), caches); ``decode_step(params,
    caches, token (B, 1), pos (B,))`` → (logits, caches) with the caches
    updated in place; ``init_cache(batch, cache_len)``; ``forward_train(params,
    tokens (B, S+1))`` → (logits (B, S, V), aux), differentiable;
    ``loss(params, {"tokens": (B, S+1)})`` → (loss, metrics);
    ``init_train(seed)`` the same draws as ``init`` kept in f32 with
    ``requires_grad=True`` (over a mesh the rank's f32 master blocks of the
    whole draw).  ``parallel.remat`` (default True) recomputes each period
    in the backward pass.

    A ``parallel`` mesh must span the ``torch.distributed`` group
    (``ValueError`` otherwise); building binds the rank's tp and dp groups
    (a collective, with ``timeout_s``), so every rank builds alike.
    ``moe_impl="ep"`` on an MoE config deals each layer's experts to the
    ranks that own them and runs the MoE through the exchange where the
    reference's condition holds and the batch rows divide over the ep ranks
    (``models.moe``); elsewhere it runs dense."""
    transformer.check_supported(cfg)
    dev = resolve_device(device)
    layout = layers.SINGLE
    if parallel is not None and parallel.mesh is not None:
        from repro_torch.distributed import collectives, sharding

        dp, tp = collectives.bind(parallel, timeout_s)
        meta = transformer.Transformer(cfg, dtype=transformer.compute_dtype(cfg), device="meta")
        layout = layers.Layout(
            parallel, dp, tp, sharding.param_pspecs(meta, parallel),
            {name: tuple(t.shape) for name, t in meta.named_parameters()},
            collectives.coordinate(parallel.mesh),
        )

    def as_tokens(t) -> torch.Tensor:
        return torch.as_tensor(t, device=dev)

    def init(seed: int) -> transformer.Transformer:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return transformer.init_params(cfg, gen, device=dev, layout=layout)

    def prefill_fn(params, batch, cache_len=None):
        return transformer.prefill(params, as_tokens(batch["tokens"]), cfg, cache_len=cache_len,
                                   layout=layout)

    def decode_fn(params, caches, token, pos):
        return transformer.decode_step(params, caches, as_tokens(token), as_tokens(pos), cfg,
                                       layout=layout)

    def init_cache(batch, cache_len):
        return transformer.init_cache(cfg, batch, cache_len, device=dev, layout=layout)

    remat = parallel.remat if parallel is not None else True

    def forward_fn(params, tokens):
        return transformer.forward_train(params, as_tokens(tokens), cfg, layout=layout,
                                         remat=remat)

    def loss_fn(params, batch):
        return transformer.loss_fn(params, {"tokens": as_tokens(batch["tokens"])}, cfg,
                                   layout=layout, remat=remat)

    def init_train(seed: int) -> transformer.Transformer:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return transformer.trainable_params(
            transformer.init_params(cfg, gen, device=dev, dtype=torch.float32, layout=layout))

    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=init,
        prefill=prefill_fn,
        decode_step=decode_fn,
        init_cache=init_cache,
        forward_train=forward_fn,
        loss=loss_fn,
        init_train=init_train,
        parallel=parallel,
        layout=layout,
    )
