"""Prefill and decode steps for serving (port of ``repro.serve.engine``).

Plain functions: PyTorch runs eagerly, so there is no ``jit``.  The decode
step updates the caches it is given in place, as the reference's donated
buffers let XLA do.

Over a mesh (a bundle built with a ``ParallelConfig``) each rank runs the
same step on its blocks: :class:`ServeMesh` holds this rank's specs of the
parameters, caches, token, position and logits (the reference's
``NamedSharding``s, from ``distributed.sharding``): batch on the dp axes,
kv heads on ``model`` when ``kv_heads % tp == 0``, else the cache is
**sequence-sharded** over ``model`` and decode combines the ranks' partial
softmaxes (flash-decode style) — the kv_heads=1 archs (granite) need it.
The step takes the whole batch's token and position on every rank and
returns the whole logits on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.parallel import ParallelConfig
from repro_torch.models import transformer
from repro_torch.models.api import ModelBundle


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """This rank's specs for one (bundle × batch × cache_len) serving
    configuration; :meth:`block` cuts a whole tensor into the rank's block."""

    params: dict
    caches: dict
    token: tuple
    pos: tuple
    logits: tuple
    parallel: ParallelConfig
    slots: tuple  # the batch rows [lo, hi) this rank's caches hold

    @staticmethod
    def build(bundle: ModelBundle, batch: int, cache_len: int) -> "ServeMesh":
        parallel = bundle.parallel
        if parallel is None or parallel.mesh is None:
            raise ValueError("ServeMesh needs a bundle built over a mesh")
        specs, slots = transformer.cache_specs(bundle.cfg, batch, cache_len, bundle.layout)
        return ServeMesh(
            params=sharding.param_pspecs(bundle.param_shapes(), parallel),
            caches=specs,
            token=sharding.batch_pspec(2, parallel),
            pos=sharding.batch_pspec(1, parallel),
            logits=sharding.batch_pspec(2, parallel),
            parallel=parallel,
            slots=slots,
        )

    def block(self, full: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of a whole tensor under ``spec`` (a view)."""
        return sharding.block(full, spec, self.parallel.mesh)


def serving_compute_copy(params):
    """The parameters with every f32 matrix (ndim >= 2, the sLSTM's 4-D
    ``r`` included) as bf16, vectors (norms, the sLSTM bias) as they are.
    Parameters already in bf16 are shared, not copied, so at full width
    (weights stored in bf16) this costs nothing.  A rank's blocks stay its
    blocks."""
    named = dict(params.named_parameters())
    if not any(t.dtype == torch.float32 and t.ndim >= 2 for t in named.values()):
        return params
    copy = type(params)(params.cfg, dtype=torch.bfloat16, device="meta")
    return transformer.set_params(copy, {
        name: t.detach().to(torch.bfloat16) if t.dtype == torch.float32 and t.ndim >= 2
        else t.detach()
        for name, t in named.items()
    })


def make_prefill_step(bundle: ModelBundle, cache_len: Optional[int] = None):
    """prefill: (params, batch dict) → (last-token logits, caches), run on
    the serving copy of the parameters."""

    def prefill(params, batch):
        return bundle.prefill(serving_compute_copy(params), batch, cache_len=cache_len)

    return prefill


def make_serve_step(bundle: ModelBundle):
    """Single-token decode: (params, caches, token, pos) → (logits, caches);
    the caches are updated in place."""

    def serve_step(params, caches, token, pos):
        return bundle.decode_step(params, caches, token, pos)

    return serve_step


def make_sharded_serve_step(bundle: ModelBundle, batch: int, cache_len: int):
    """The decode step of a bundle over a mesh for ``batch`` slots of
    ``cache_len`` positions, and its :class:`ServeMesh`: ``(step, sm)``.
    The step takes the rank's caches (``bundle.init_cache(batch,
    cache_len)``) and refuses others."""
    sm = ServeMesh.build(bundle, batch, cache_len)

    def serve_step(params, caches, token, pos):
        held = getattr(caches, "slots", (0, batch))
        if held != sm.slots or token.shape[0] != batch:
            raise ValueError(f"the step serves {batch} slots, this rank's rows {sm.slots}; got "
                             f"caches of rows {held} and {token.shape[0]} tokens")
        return bundle.decode_step(params, caches, token, pos)

    return serve_step, sm
