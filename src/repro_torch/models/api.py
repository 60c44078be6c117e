"""Unified model API: build init/prefill/decode closures per arch (port of
``repro.models.api``).

``build_model(cfg, parallel, device=...)`` returns a :class:`ModelBundle`
whose members are functions over a parameter module: decoder-only models
(``models/transformer.py``, a VLM's patch embeddings in ``batch["patch_emb"]``)
and, where ``cfg.is_encoder_decoder``, ``models/encdec.py`` (the audio
frames in ``batch["frames"]``), as the reference dispatches.
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
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed.parallel import ParallelConfig
from repro_torch.models import encdec, layers, transformer


class TensorSpec(NamedTuple):
    """The shape and type of one model input (the reference's
    ``ShapeDtypeStruct``): nothing is allocated."""

    shape: torch.Size
    dtype: torch.dtype


def _specs_of(tree):
    """The :class:`TensorSpec` of every tensor of a (nested) cache tree."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tree.shape, tree.dtype)
    if isinstance(tree, dict):
        return {k: _specs_of(v) for k, v in tree.items()}
    return type(tree)(*(_specs_of(t) for t in tree))


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


def model_class(cfg: ArchConfig):
    """The parameter module of ``cfg``'s model."""
    return encdec.EncoderDecoder if cfg.is_encoder_decoder else transformer.Transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init: Callable[[int], torch.nn.Module]
    prefill: Callable[..., tuple]
    decode_step: Callable[..., tuple]
    init_cache: Callable[[int, int], dict]
    forward_train: Callable[..., tuple]
    loss: Callable[..., tuple]
    init_train: Callable[[int], torch.nn.Module]
    parallel: Optional[ParallelConfig] = None
    layout: layers.Layout = layers.SINGLE

    def param_shapes(self) -> torch.nn.Module:
        """The whole parameters on the meta device (the port's dtypes)."""
        return model_class(self.cfg)(self.cfg, dtype=transformer.compute_dtype(self.cfg),
                                     device="meta")

    # -- model inputs, as shapes and types (nothing allocated) ---------------------
    def train_input_specs(self, cell: ShapeCell) -> dict:
        b, s = cell.global_batch, cell.seq_len
        return {"tokens": TensorSpec(torch.Size((b, s + 1)), torch.int32),
                **self._frontend_specs(b)}

    def prefill_input_specs(self, cell: ShapeCell) -> dict:
        b, s = cell.global_batch, cell.seq_len
        return {"tokens": TensorSpec(torch.Size((b, s)), torch.int32), **self._frontend_specs(b)}

    def decode_input_specs(self, cell: ShapeCell) -> dict:
        """The token, its position and the caches of ``cell``'s batch and
        length (the caches' specs from ``init_cache`` on the meta device)."""
        b, s = cell.global_batch, cell.seq_len
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            caches = encdec.init_cache(cfg, b, s, device="meta")
        else:
            caches = transformer.init_cache(cfg, b, s, device="meta")
        return {"token": TensorSpec(torch.Size((b, 1)), torch.int32),
                "pos": TensorSpec(torch.Size((b,)), torch.int32), "caches": _specs_of(caches)}

    def _frontend_specs(self, b: int) -> dict:
        cfg = self.cfg
        shape = TensorSpec(torch.Size((b, cfg.frontend_len, cfg.d_model)),
                           transformer.compute_dtype(cfg))
        if cfg.frontend == "patch_stub":
            return {"patch_emb": shape}
        if cfg.frontend == "audio_stub":
            return {"frames": shape}
        return {}


def build_model(cfg: ArchConfig, parallel: Optional[ParallelConfig] = None, *, device=None,
                timeout_s: Optional[float] = None) -> ModelBundle:
    """Closures of ``cfg``'s model on ``device`` (an encoder-decoder where
    ``cfg.is_encoder_decoder``: :func:`_build_encdec`).

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
    (``models.moe``); elsewhere it runs dense.

    A VLM's (``frontend="patch_stub"``) ``prefill``, ``forward_train`` and
    ``loss`` take the patch embeddings (B, P, d) as ``batch["patch_emb"]``
    (``forward_train(params, tokens, patch_emb=...)``) before the tokens.
    Every family runs over a mesh: Griffin's recurrent blocks on their
    width blocks (``rglru.rglru_block``), the encoder-decoder's blocks on
    their heads (``models.encdec``)."""
    if cfg.is_encoder_decoder:
        return _build_encdec(cfg, parallel, device, timeout_s)
    transformer.check_supported(cfg)
    dev = resolve_device(device)
    layout = _bind_layout(cfg, parallel, timeout_s)

    def as_tokens(t) -> torch.Tensor:
        return torch.as_tensor(t, device=dev)

    def init(seed: int) -> transformer.Transformer:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return transformer.init_params(cfg, gen, device=dev, layout=layout)

    def as_prefix(t) -> Optional[torch.Tensor]:
        return None if t is None else torch.as_tensor(t, device=dev)

    def prefill_fn(params, batch, cache_len=None):
        return transformer.prefill(params, as_tokens(batch["tokens"]), cfg, cache_len=cache_len,
                                   layout=layout, prefix_emb=as_prefix(batch.get("patch_emb")))

    def decode_fn(params, caches, token, pos):
        return transformer.decode_step(params, caches, as_tokens(token), as_tokens(pos), cfg,
                                       layout=layout)

    def init_cache(batch, cache_len):
        return transformer.init_cache(cfg, batch, cache_len, device=dev, layout=layout)

    remat = parallel.remat if parallel is not None else True

    def forward_fn(params, tokens, patch_emb=None):
        return transformer.forward_train(params, as_tokens(tokens), cfg, layout=layout,
                                         remat=remat, prefix_emb=as_prefix(patch_emb))

    def loss_fn(params, batch):
        inputs = {"tokens": as_tokens(batch["tokens"]),
                  "patch_emb": as_prefix(batch.get("patch_emb"))}
        return transformer.loss_fn(params, inputs, cfg, layout=layout, remat=remat)

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


def _bind_layout(cfg: ArchConfig, parallel: Optional[ParallelConfig],
                 timeout_s: Optional[float]) -> layers.Layout:
    """This rank's :class:`~repro_torch.models.layers.Layout` of ``cfg``'s
    model over ``parallel``'s mesh (binding its tp and dp groups, a
    collective), or the unsharded one."""
    if parallel is None or parallel.mesh is None:
        return layers.SINGLE
    from repro_torch.distributed import collectives, sharding

    dp, tp = collectives.bind(parallel, timeout_s)
    meta = model_class(cfg)(cfg, dtype=transformer.compute_dtype(cfg), device="meta")
    return layers.Layout(
        parallel, dp, tp, sharding.param_pspecs(meta, parallel),
        {name: tuple(t.shape) for name, t in meta.named_parameters()},
        collectives.coordinate(parallel.mesh),
    )


def _build_encdec(cfg: ArchConfig, parallel: Optional[ParallelConfig], device,
                  timeout_s: Optional[float] = None) -> ModelBundle:
    """The encoder-decoder's closures (the reference's ``build_model`` for
    ``cfg.is_encoder_decoder``): ``prefill(params, {"tokens", "frames"},
    cache_len)``, ``decode_step(params, caches, token, pos)``,
    ``forward_train(params, tokens, frames)`` → (logits, 0), ``loss(params,
    {"tokens", "frames"})``, ``init_cache(batch, cache_len)``; over a mesh
    one rank's part, as :func:`build_model`'s."""
    encdec.check_supported(cfg)
    dev = resolve_device(device)
    layout = _bind_layout(cfg, parallel, timeout_s)

    def as_tensor(t) -> torch.Tensor:
        return torch.as_tensor(t, device=dev)

    def init(seed: int, dtype=None) -> encdec.EncoderDecoder:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return encdec.init_params(cfg, gen, device=dev, dtype=dtype, layout=layout)

    def prefill_fn(params, batch, cache_len=None):
        return encdec.prefill(params, as_tensor(batch["tokens"]), as_tensor(batch["frames"]), cfg,
                              cache_len=cache_len, layout=layout)

    def decode_fn(params, caches, token, pos):
        return encdec.decode_step(params, caches, as_tensor(token), as_tensor(pos), cfg,
                                  layout=layout)

    def init_cache(batch, cache_len):
        return encdec.init_cache(cfg, batch, cache_len, device=dev, layout=layout)

    def forward_fn(params, tokens, frames):
        logits = encdec.forward_train(params, as_tensor(tokens), as_tensor(frames), cfg,
                                      layout=layout)
        return logits, torch.zeros((), dtype=torch.float32, device=dev)

    def loss_fn(params, batch):
        return encdec.loss_fn(params, {"tokens": as_tensor(batch["tokens"]),
                                       "frames": as_tensor(batch["frames"])}, cfg, layout=layout)

    def init_train(seed: int) -> encdec.EncoderDecoder:
        return transformer.trainable_params(init(seed, torch.float32))

    return ModelBundle(cfg=cfg, device=dev, init=lambda seed: init(seed),
                       prefill=prefill_fn, decode_step=decode_fn,
                       init_cache=init_cache, forward_train=forward_fn, loss=loss_fn,
                       init_train=init_train, parallel=parallel, layout=layout)
