"""Int8 gradient compression with error feedback (port of
``repro.optim.compress``).

``error_feedback_compress`` quantizes ``grad + error`` per leaf to int8 with
one f32 scale and carries the residual into the next step, which keeps
Adam's gradient stream unbiased in expectation; the state rides in the
optimizer state (``opt_state["ef_error"]``).

``compressed_psum_int8`` is the mean all-reduce over a data-parallel axis
with int8 on the wire, the reference's two hops (1-bit Adam / DeepSpeed
lineage): quantize each of D chunks to int8 with its own f32 scale,
all-to-all the int8 chunks and all-gather the scales, dequantize and sum
the chunk this rank owns; requantize it and all-gather the int8 chunks with
their scales.  Each hop moves one byte a gradient element (and a scale a
chunk), a quarter of an f32 ring all-reduce's.
"""
from __future__ import annotations

import torch

from repro_torch.utils import named_leaves


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns ``(q, scale)``."""
    xf = x.float()
    scale = _scale(_amax(xf))
    return _quantize(xf, scale), scale


def _amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| without an |x| temporary."""
    return torch.maximum(x.amax(), -x.amin())


def _quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """``clamp(round(x / scale), -127, 127)`` as int8, one f32 temporary."""
    t = x / scale
    return t.round_().clamp_(-127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax / 127.0, min=1e-12)


@torch.no_grad()
def error_feedback_compress(grads: dict, error: dict, axis=None) -> tuple[dict, dict]:
    """Quantize ``grads + error`` per leaf.  Returns ``(dequantized in the
    gradients' types, new error in the error's types)``, dicts by name.

    Over a mesh the leaves are a rank's blocks of whole tensors: ``axis``
    (a ``distributed.collectives.Axis`` over the group) takes each leaf's
    max |value| over every rank's block (one all-reduce for all leaves), so
    each block is quantized with its whole tensor's scale, as the
    reference's per-tensor quantization of the global array."""
    leaves = named_leaves(grads)
    amax = {}
    if axis is not None and axis.size > 1 and leaves:
        local = torch.stack([(g.float() + error[name].float()).abs().max()
                             for name, g in leaves.items()])
        amax = dict(zip(leaves, axis.all_reduce(local, op="max")))
    deq, err = {}, {}
    for name, g in leaves.items():  # one leaf's temporaries at a time
        gf = g.float() + error[name].float()
        scale = _scale(amax[name] if amax else _amax(gf))
        d = dequantize_int8(_quantize(gf, scale), scale)
        deq[name] = d.to(leaves[name].dtype)
        err[name] = (gf - d).to(error[name].dtype)
    return deq, err


@torch.no_grad()
def compressed_psum_int8(x: torch.Tensor, axis) -> torch.Tensor:
    """The mean of every rank's ``x`` over ``axis`` (a
    ``distributed.collectives.Axis``; the reference's ``axis_names``) with
    int8 wire traffic; every rank returns the same bits, in ``x``'s type.

    Hop 1 (reduce-scatter): ``x`` flattened and padded to D equal chunks,
    each quantized with its own scale (max |chunk| / 127); ``all_to_all`` of
    the int8 chunks and ``all_gather`` of the D scales; this rank's chunk is
    the sum over sources of ``q * scale``, over D.  Hop 2 (all-gather): that
    chunk requantized with one scale, then the int8 chunks and their scales
    all-gathered in one call and dequantized.  The f32 temporaries are a
    chunk's."""
    d = axis.size
    shape = x.shape
    flat = x.float().reshape(-1)
    n = flat.numel()
    if n % d:
        flat = torch.nn.functional.pad(flat, (0, (-n) % d))
    chunks = flat.reshape(d, -1)
    scales = torch.clamp(torch.maximum(chunks.amax(dim=1), -chunks.amin(dim=1)), min=1e-12) / 127.0
    q = torch.empty(chunks.shape, dtype=torch.int8, device=x.device)
    for i in range(d):
        q[i] = _quantize(chunks[i], scales[i])
    q_recv = axis.all_to_all(q)  # row = source rank, this rank's chunk
    s_all = axis.all_gather(scales[None], 0)  # [source, chunk]
    mine = s_all[:, axis.index]
    reduced = torch.zeros(chunks.shape[1], dtype=torch.float32, device=x.device)
    for i in range(d):
        reduced += q_recv[i].float() * mine[i]
    reduced /= d
    s2 = torch.clamp(_amax(reduced), min=1e-12) / 127.0
    q2 = _quantize(reduced, s2)
    s2_all, q_all = axis.all_gather_bytes([s2.reshape(1), q2])  # the f32 scale first: aligned
    out = torch.empty(chunks.shape, dtype=x.dtype, device=x.device)
    for i in range(d):
        out[i] = q_all[i].float() * s2_all[i]
    return out.reshape(-1)[:n].reshape(shape)
