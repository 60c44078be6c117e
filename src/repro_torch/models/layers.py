"""Shared neural-net building blocks (port of ``repro.models.layers``).

Every function rounds to its input's type where the reference does: rmsnorm
and rope compute in f32 and cast back, each matrix product rounds to the
activation type.

:class:`Layout` is a rank's view of a model sharded over a mesh, and the
helpers after it are the pieces its blocks share: column blocks gathered
where they do not hold the heads a rank computes, row-parallel sums, the
RMSNorm of a column block and the vocab-parallel embedding.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F


def truncated_normal_(t: torch.Tensor, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with the reference's init rule
    (``layers.truncated_normal_init``): a standard normal truncated to
    [-2, 2] times ``scale / sqrt(fan_in)``, ``fan_in = shape[0]`` for a
    matrix and 1 for a vector.  The draw is in f32 on ``t``'s device and is
    then rounded to ``t``'s type."""
    stddev = scale / math.sqrt(t.shape[0] if t.ndim > 1 else 1.0)
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        t.copy_(draw.mul_(stddev))
    return t


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with cast back to the input type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x·Wg) * (x·Wu) · Wd."""
    dtype = x.dtype
    g = x @ w_gate.to(dtype)
    u = x @ w_up.to(dtype)
    return (F.silu(g) * u) @ w_down.to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate the two halves of the channels. ``x``: (..., S, head_dim);
    positions broadcast against (..., S).  Computed in f32, cast back."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# tensor and data parallelism (a rank's view of a sharded model)
# ---------------------------------------------------------------------------
RECURRENT_TYPES = ("mlstm", "slstm", "rglru")


class Layout:
    """A rank's view of a model sharded over a mesh: the parallel config, its
    ``dp`` and ``tp`` axes (``distributed.collectives.Axis``) and each
    parameter's spec and whole shape by name.  :data:`SINGLE` is the
    unsharded model's: every weight whole, every collective absent.

    The block code reads a weight through :meth:`w` (its tp block, gathered
    over dp where FSDP shards it; :meth:`gathered` gathers a whole layer in
    one call first) and asks :meth:`cols` / :meth:`rows` which block of the
    whole matrix that is.  Bind a layout to a parameter module with
    :meth:`view` before a pass."""

    def __init__(self, parallel=None, dp=None, tp=None, specs=None, full_shapes=None,
                 coord=None):
        from repro_torch.distributed import collectives

        self.parallel = parallel
        self.dp = dp or collectives.SINGLE
        self.tp = tp or collectives.SINGLE
        self.specs = specs or {}
        self.full_shapes = full_shapes or {}
        self.coord = coord or {}
        self._names: dict = {}
        self._gathered: dict = {}

    @property
    def sharded(self) -> bool:
        return self.dp.size > 1 or self.tp.size > 1

    def view(self, params) -> "Layout":
        """This layout bound to ``params``' tensors (by identity)."""
        if not self.sharded:
            return self
        out = Layout(self.parallel, self.dp, self.tp, self.specs, self.full_shapes, self.coord)
        out._names = {id(t): name for name, t in params.named_parameters()}
        return out

    # -- parameters -------------------------------------------------------------
    def block_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block (a view) of parameter ``name``'s whole tensor."""
        from repro_torch.distributed import sharding

        return sharding.block(full, self.specs[name], self.parallel.mesh, self.coord)

    def _dim_of(self, p, role: str):
        """The dim of ``p`` sharded over ``role`` ("tp" or "dp"), or None."""
        name = self._names.get(id(p))
        if name is None:
            return None
        want = self.parallel.tp_axis if role == "tp" else tuple(self.parallel.dp_axes)
        for dim, entry in enumerate(self.specs[name]):
            if entry is not None and entry == want:
                return dim
        return None

    def w(self, p: torch.Tensor) -> torch.Tensor:
        """``p``'s tp block: the stored block, gathered over dp where FSDP
        shards it."""
        got = self._gathered.get(id(p))
        if got is not None:
            return got
        if self.dp.size == 1 or self._dim_of(p, "dp") is None:
            return p
        return self._gather_dp([p])[id(p)]

    def _gather_dp(self, params) -> dict:
        parts = self.dp.all_gather_bytes([p.detach() for p in params])
        return {id(p): torch.cat(ps, dim=self._dim_of(p, "dp")) for p, ps in zip(params, parts)}

    @contextlib.contextmanager
    def gathered(self, module):
        """Gather every dp-sharded weight of ``module`` in one all-gather for
        the block inside; the gathered copies are dropped after it."""
        if self.dp.size == 1:
            yield
            return
        params = [p for p in module.parameters() if self._dim_of(p, "dp") is not None]
        self._gathered = self._gather_dp(params) if params else {}
        try:
            yield
        finally:
            self._gathered = {}

    def _block(self, p, dim: int) -> tuple[int, int, int]:
        name = self._names.get(id(p))
        n = self.full_shapes[name][dim] if name is not None else p.shape[dim]
        if self._dim_of(p, "tp") != dim % p.ndim:
            return 0, n, n
        b = n // self.tp.size
        return self.tp.index * b, (self.tp.index + 1) * b, n

    def cols(self, p) -> tuple[int, int, int]:
        """``(lo, hi, n)``: ``p``'s tp block holds columns [lo, hi) of n."""
        return self._block(p, p.ndim - 1)

    def rows(self, p) -> tuple[int, int, int]:
        """``(lo, hi, n)`` of ``p``'s rows (dim -2)."""
        return self._block(p, p.ndim - 2)

    # -- activations --------------------------------------------------------------
    def act(self, cfg, shape, seq: bool = True) -> tuple[bool, bool]:
        """``(batch over dp, sequence over tp)`` of a ``(B, S, ...)``
        activation: the reference's ``shard_act`` constraint
        (``ParallelConfig.act_spec``), the sequence only where asked (not in
        decode) and for pure attention stacks (its ``_act_seq_dim``)."""
        if not self.sharded:
            return False, False
        recurrent = any(bt in RECURRENT_TYPES for bt in cfg.block_pattern)
        spec = self.parallel.act_spec(tuple(shape), seq_dim=1 if seq and not recurrent else None)
        return spec[0] is not None, spec[1] is not None

    def batch_rows(self, t: torch.Tensor, sharded: bool) -> torch.Tensor:
        """This rank's rows of ``t`` where the batch is sharded over dp."""
        return self.dp.block(t, 0) if sharded else t

    def gather_batch(self, x: torch.Tensor, sharded: bool) -> torch.Tensor:
        """Every rank's rows back (a sharded batch), or dp index 0's copy (a
        batch every dp rank computed): the same bits on every rank."""
        if self.dp.size == 1:
            return x
        return self.dp.all_gather(x, 0) if sharded else self.dp.broadcast(x, 0)


SINGLE = Layout()


def take_cols(lay: Layout, items) -> list:
    """Columns ``[a, b)`` of products of which a rank holds a block:
    ``items`` are ``(y, (lo, hi, n), (a, b))`` with ``y`` holding columns
    [lo, hi) of n (its tp block, or all).  A block that does not hold
    [a, b) is all-gathered over tp (one call for all of them)."""
    out, need = [], []
    for i, (y, (lo, hi, n), (a, b)) in enumerate(items):
        if lo <= a and b <= hi:
            out.append(y if (a, b) == (lo, hi) else y[..., a - lo:b - lo])
        else:
            out.append(None)
            need.append(i)
    if need:
        full = lay.tp.all_gather_cols([items[i][0] for i in need])
        for i, f in zip(need, full):
            a, b = items[i][2]
            out[i] = f if (a, b) == (0, f.shape[-1]) else f[..., a:b]
    return out


def reduce_rows(lay: Layout, out: torch.Tensor, partial: bool, sp: bool) -> torch.Tensor:
    """A row-parallel product's result: ``partial`` sums are all-reduced over
    tp, or reduce-scattered along the sequence (dim 1) under sequence
    parallelism; a whole result keeps the rank's sequence block then."""
    if partial:
        return lay.tp.reduce_scatter(out, 1) if sp else lay.tp.all_reduce(out)
    return lay.tp.block(out, 1) if sp else out


def rmsnorm_cols(lay: Layout, x: torch.Tensor, w: torch.Tensor, have: tuple,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over a dim of which ``x`` holds columns ``have = (lo, hi, n)``;
    ``w`` is the whole (n,) weight.  A block takes the mean of squares over
    tp (one all-reduce of the sums)."""
    lo, hi, n = have
    if (lo, hi) == (0, n):
        return rmsnorm(x, w, eps)
    xf = x.float()
    var = lay.tp.all_reduce(xf.square().sum(dim=-1, keepdim=True)) / n
    out = xf * torch.rsqrt(var + eps) * w[lo:hi].float()
    return out.to(x.dtype)


def embed_tokens(lay: Layout, embed: torch.Tensor, tokens: torch.Tensor, dtype,
                 sp: bool) -> torch.Tensor:
    """The embedding rows of ``tokens``.  A vocab-parallel block looks up
    the ids in its range and zeros the others, then the ranks' rows are
    summed over tp (reduce-scattered along the sequence under sequence
    parallelism): one rank holds each id, so the sum is exact."""
    lo, hi, v = lay.rows(embed)
    ids = tokens.to(torch.long)
    if (lo, hi) == (0, v):
        x = embed[ids].to(dtype)
        return lay.tp.block(x, 1) if sp else x
    local = ids - lo
    ok = (local >= 0) & (local < hi - lo)
    x = torch.where(ok[..., None], embed[local.clamp(0, hi - lo - 1)], 0).to(dtype)
    return lay.tp.reduce_scatter(x, 1) if sp else lay.tp.all_reduce(x)


def tp_range(lay: Layout, n: int) -> tuple[int, int, int]:
    """``(lo, hi, n)``: the rank's tp block of a dim of n."""
    b = n // lay.tp.size
    return lay.tp.index * b, (lay.tp.index + 1) * b, n


def from_block(lay: Layout, t: torch.Tensor, tp_dim: Optional[int], dim: int,
               want: tuple[int, int]) -> torch.Tensor:
    """Entries ``[a, b)`` along ``dim`` (all of every other dim) of a tensor
    of which ``t`` is the rank's spec block: its tp block along ``tp_dim``
    (None: whole).  Gathers over tp where the block does not hold them."""
    a, b = want
    n = t.shape[dim] * (lay.tp.size if tp_dim == dim else 1)
    if tp_dim == dim and tp_range(lay, n)[:2] == (a, b):
        return t
    full = t if tp_dim is None else lay.tp.all_gather(t, tp_dim)
    return full if (a, b) == (0, n) else full.narrow(dim, a, b - a)


def to_block(lay: Layout, t: torch.Tensor, dim: int, have: tuple[int, int, int],
             tp_dim: Optional[int]) -> torch.Tensor:
    """The rank's spec block (tp block along ``tp_dim``, None: whole) of a
    tensor of which ``t`` holds entries ``have = (lo, hi, n)`` along ``dim``
    (all of every other dim; a partial ``have`` is the rank's tp block)."""
    lo, hi, n = have
    if tp_dim == dim and tp_range(lay, n) == have:
        return t
    full = t if (lo, hi) == (0, n) else lay.tp.all_gather(t, dim)
    return full if tp_dim is None else lay.tp.block(full, tp_dim)
