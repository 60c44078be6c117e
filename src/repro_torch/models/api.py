"""Unified model API: build init/prefill/decode closures per arch (port of
``repro.models.api``).

``build_model(cfg, device=...)`` returns a :class:`ModelBundle` whose
members are functions over a parameter module.  Decoder-only models on one
device only: ``parallel`` must be ``None`` (sharding over several cards is
a later slice), and the loss and the dry-run input specs come with the
training slice.  ``device=None`` means the CUDA card and raises without
one; ``"cpu"`` runs every kernel's plain twin.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

MULTI_CARD_SLICE = "the multi-card LM slice (sharded weights and caches)"


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


def build_model(cfg: ArchConfig, parallel=None, *, device=None) -> ModelBundle:
    """Closures of a decoder-only model on ``device``.

    ``init(seed)`` draws the parameters on the device from a
    ``torch.Generator`` seeded with ``seed``; ``prefill(params, {"tokens":
    (B, L)}, cache_len)`` → (logits (B, V), caches); ``decode_step(params,
    caches, token (B, 1), pos (B,))`` → (logits, caches) with the caches
    updated in place; ``init_cache(batch, cache_len)``; ``forward_train(params,
    tokens (B, S+1))`` → (logits (B, S, V), aux), a forward pass only.
    """
    transformer.check_supported(cfg)
    if parallel is not None:
        raise NotImplementedError(f"parallel configs belong to {MULTI_CARD_SLICE}")
    dev = resolve_device(device)

    def as_tokens(t) -> torch.Tensor:
        return torch.as_tensor(t, device=dev)

    def init(seed: int) -> transformer.Transformer:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return transformer.init_params(cfg, gen, device=dev)

    def prefill_fn(params, batch, cache_len=None):
        return transformer.prefill(params, as_tokens(batch["tokens"]), cfg, cache_len=cache_len)

    def decode_fn(params, caches, token, pos):
        return transformer.decode_step(params, caches, as_tokens(token), as_tokens(pos), cfg)

    def init_cache(batch, cache_len):
        return transformer.init_cache(cfg, batch, cache_len, device=dev)

    def forward_fn(params, tokens):
        return transformer.forward_train(params, as_tokens(tokens), cfg)

    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=init,
        prefill=prefill_fn,
        decode_step=decode_fn,
        init_cache=init_cache,
        forward_train=forward_fn,
    )
