"""Mixture-of-Experts layer (port of ``repro.models.moe``): grok-1 and
mixtral, 8 experts, top-2.

Router: f32 logits, softmax over all experts, top-k, renormalised weights;
the Switch-style load-balance aux from each token's primary expert.

Two dispatch implementations, as in the reference:

* :func:`moe_dense` — every token through the experts it is routed to.
  The reference computes every expert for every token and keeps the
  selected rows (:func:`moe_dense_all`, kept as the oracle); the port sorts
  the (token, expert) rows by expert and runs one SwiGLU chain per expert
  on its rows only: the same function with ``E / k`` of the work.
* :func:`moe_ep` — expert parallelism through the **paper's exchange**:
  each (token, expert) row travels to the shard that owns its expert with
  the capacity-padded all-to-all of :mod:`repro_torch.core.exchange`
  (Alg. 2, Phases 2–3, experts in the role of hash ranges), the owner runs
  its experts on what it received, and ``combine`` sends the rows back.
  Expert ``e`` lives on shard ``e % D`` when D < E (each shard owns E / D)
  and shard ``r`` holds expert ``r % E`` when D >= E (the reference's
  rule).  Each slot holds ``capacity`` rows a (source, destination) pair
  (``ep_capacity``); rows beyond it are dropped, contribute zero and are
  counted (``num_dropped``), as in the reference, which discards the count.

Deliberate differences:

* Under EP a rank holds only the experts it owns (``sharding`` deals the
  expert axis over the ep ranks); the reference replicates the stacks into
  its ``shard_map`` and lets GSPMD gather them.  The values are the same.
* Over a mesh the aux is finished once a forward pass (:class:`AuxParts`):
  the dense path's routing counts are summed over dp, the EP path's local
  auxes are averaged over the ep ranks in rank order, so the MoE itself
  issues no collective but its two exchange rounds.
* EP trains: the exchange's rounds carry the gradients of the rows they
  move (``exchange.exchange_many``), so a backward pass adds two rounds a
  MoE layer (and remat's recomputation two more).  A rank's owned experts
  get their whole gradient from the rows it received, with no reduction;
  the aux's mean over the ep ranks passes each rank's share of the
  gradient (1 / D) to its own aux.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import exchange
from repro_torch.models import layers

# The label the MoE's exchange rounds are counted under (exchange.CALLS).
LABEL = "moe"
# ``record_function`` ranges of a profile: the router and top-k, the
# experts' grouped products (their sort by expert included).
ROUTE_RANGE, EXPERTS_RANGE = "moe.route", "moe.experts"


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class MoE(nn.Module):
    """The reference's ``init_moe`` layout: ``router`` (d, E) and the expert
    stacks ``w_gate`` / ``w_up`` (E, d, f) and ``w_down`` (E, f, d)."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype, device):
        super().__init__()
        d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
        self.router = _param((d, e), dtype, device)
        self.w_gate = _param((e, d, f), dtype, device)
        self.w_up = _param((e, d, f), dtype, device)
        self.w_down = _param((e, f, d), dtype, device)


class Routing(NamedTuple):
    w: torch.Tensor  # (T, k) renormalised weights, in x's type
    ids: torch.Tensor  # (T, k) int64 expert ids, best first
    probs: torch.Tensor  # (T, E) f32 softmax


def route(router: torch.Tensor, x2d: torch.Tensor, cfg: ArchConfig) -> Routing:
    """Top-k routing of ``x2d`` (T, d): f32 logits, softmax, top-k, the
    weights renormalised (at least 1e-9 below) and cast to x's type."""
    with torch.profiler.record_function(ROUTE_RANGE):
        probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
        w, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return Routing(w.to(x2d.dtype), ids, probs)


def route_stats(r: Routing, num_experts: int) -> torch.Tensor:
    """``(2, E)`` f32: each expert's count of primary assignments and its
    summed probability over the routed tokens (sums, so ranks add them)."""
    primary = r.ids[:, 0].long()  # an integer scatter-add: exact, and traceable on meta
    counts = torch.zeros(num_experts, dtype=torch.int64, device=primary.device).scatter_add_(
        0, primary, torch.ones_like(primary)).float()
    return torch.stack([counts, r.probs.sum(dim=0)])


def switch_aux(stats: torch.Tensor, tokens: int, num_experts: int) -> torch.Tensor:
    """The Switch load-balance term ``E · Σ_e frac_e · mean_prob_e`` from
    :func:`route_stats` summed over ``tokens`` tokens."""
    frac, mean_p = stats[0] / tokens, stats[1] / tokens
    return num_experts * (frac * mean_p).sum()


def _route(router: torch.Tensor, x2d: torch.Tensor, cfg: ArchConfig):
    """The reference's ``_route``: (weights (T, k), ids (T, k), aux)."""
    r = route(router, x2d, cfg)
    return r.w, r.ids, switch_aux(route_stats(r, cfg.num_experts), x2d.shape[0], cfg.num_experts)


def _expert_ffn(x, wg, wu, wd):
    return layers.swiglu(x, wg, wu, wd)


def balanced_edges(rows: int, experts: int) -> list:
    """``[lo_0, hi_0, lo_1, hi_1, ...]``: ``rows`` rows split as evenly as
    they go over ``experts`` experts, in order (balanced routing)."""
    cuts = [rows * i // experts for i in range(experts + 1)]
    return [c for i in range(experts) for c in (cuts[i], cuts[i + 1])]


def grouped_ffn(x: torch.Tensor, eids: torch.Tensor, stacks, experts: dict,
                real_rows: Optional[int] = None) -> torch.Tensor:
    """Each row of ``x`` (N, d) through expert ``eids[n]``, zero where this
    call holds no such expert (``eids`` -1 marks padding).  ``stacks`` are
    ``(w_gate, w_up, w_down)`` and ``experts`` maps an expert id to its
    index in them.  Rows are sorted by expert once; each expert runs one
    SwiGLU chain on its rows (one host read of the boundaries).

    On the meta device (the dry run) there are no ids to read: the held
    experts take ``real_rows`` rows (default N), split evenly
    (:func:`balanced_edges`): the balanced routing the capacity design
    assumes."""
    wg, wu, wd = stacks
    with torch.profiler.record_function(EXPERTS_RANGE):
        order = torch.argsort(eids, stable=True)
        sorted_ids = eids[order]
        owned = sorted(experts)
        if x.is_meta:
            edges = balanced_edges(x.shape[0] if real_rows is None else real_rows, len(owned))
        else:
            bounds = torch.tensor([[e, e + 1] for e in owned], dtype=sorted_ids.dtype,
                                  device=x.device).reshape(-1)
            edges = torch.searchsorted(sorted_ids, bounds).tolist()
        out = torch.zeros_like(x)
        if x.requires_grad:  # + 0: x reaches the output even where no row is this call's,
            out = out + x[:0].sum()  # so the exchange's backward runs on every rank

        for i, e in enumerate(owned):
            lo, hi = edges[2 * i], edges[2 * i + 1]
            if hi == lo:
                continue
            rows = order[lo:hi]
            j = experts[e]
            out = out.index_copy(0, rows, _expert_ffn(x[rows], wg[j], wu[j], wd[j]))
    return out


def _weighted_sum(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``Σ_k w[t, k] · rows[t, k]`` (rows (T, k, d)), in the rows' type as
    the reference combines."""
    return (rows * w[:, :, None].to(rows.dtype)).sum(dim=1)


def _dense(router, stacks, x: torch.Tensor, cfg: ArchConfig, experts: dict):
    """The routed experts of ``experts`` for every token of ``x`` (B, S, d):
    ``(out (B, S, d), route_stats)``; experts not held give zero."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    r = route(router, x2, cfg)
    k = cfg.experts_per_token
    held = b * s * k * len(experts) // cfg.num_experts  # the held experts' rows, balanced
    rows = grouped_ffn(x2.repeat_interleave(k, dim=0), r.ids.reshape(-1), stacks, experts,
                       real_rows=held)
    out = _weighted_sum(rows.reshape(b * s, k, d), r.w)
    return out.reshape(b, s, d), route_stats(r, cfg.num_experts)


def _stacks(p: MoE) -> tuple:
    return p.w_gate, p.w_up, p.w_down


def moe_dense(p: MoE, x: torch.Tensor, cfg: ArchConfig):
    """Every token through its top-k experts; exact. x (B, S, d) → (out, aux)."""
    out, stats = _dense(p.router, _stacks(p), x, cfg, {e: e for e in range(cfg.num_experts)})
    return out, switch_aux(stats, x.shape[0] * x.shape[1], cfg.num_experts)


def moe_dense_all(p: MoE, x: torch.Tensor, cfg: ArchConfig):
    """The reference's dense form: every expert on every token, the (T, E,
    f) intermediate, the selected rows combined (the oracle of
    :func:`moe_dense`; smoke scale, or one layer's input at full width)."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    w, ids, aux = _route(p.router, x2, cfg)
    dt = x.dtype
    g = torch.einsum("td,edf->tef", x2, p.w_gate.to(dt))
    u = torch.einsum("td,edf->tef", x2, p.w_up.to(dt))
    o = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * u, p.w_down.to(dt))
    sel = torch.gather(o, 1, ids[:, :, None].expand(-1, -1, d))
    return _weighted_sum(sel, w).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# expert parallelism through the paper's exchange
# ---------------------------------------------------------------------------
def ep_applies(parallel, cfg: ArchConfig) -> bool:
    """The reference's condition for EP: ``moe_impl == "ep"``, a mesh, more
    than one ep device and ``D % E == 0 or E % D == 0``."""
    if parallel is None or parallel.moe_impl != "ep" or parallel.mesh is None or not cfg.is_moe:
        return False
    dvs = parallel.num_devices(parallel.ep_axes_)
    e = cfg.num_experts
    return dvs > 1 and (dvs % e == 0 or e % dvs == 0)


def owned_experts(rank: int, dvs: int, num_experts: int) -> list:
    """The experts shard ``rank`` of ``dvs`` owns: ``rank, rank + D, ...``
    when D < E, else expert ``rank % E``."""
    return list(range(rank % num_experts, num_experts, dvs))


def ep_capacity(tokens_local: int, cfg: ArchConfig) -> int:
    """Rows a (source, destination) slot holds: ``cdiv(t·k, E)`` times the
    capacity factor, plus 8, rounded up to a multiple of 8 (the
    reference's ``moe_ep``)."""
    cap = -(-tokens_local * cfg.experts_per_token // cfg.num_experts)
    cap = int(cap * cfg.moe_capacity_factor) + 8
    return -(-cap // 8) * 8


def _destinations(ids: torch.Tensor, shards: list, dvs: int, num_experts: int) -> torch.Tensor:
    """The shard each (token, expert) row of ``ids`` (local, N) goes to."""
    if dvs >= num_experts:  # one expert a shard; groups of E shards, stay in the group
        base = torch.tensor([(r // num_experts) * num_experts for r in shards],
                            dtype=ids.dtype, device=ids.device)
        return base[:, None] + ids
    return ids % dvs


def _ep(router, stacks, xs: torch.Tensor, cfg: ArchConfig, group):
    """EP over ``group`` for ``xs`` (local, t, d), one row of tokens per
    local shard: ``(out (local, t, d), aux (local,) f32, num_dropped (local,))``.
    ``stacks`` hold every expert (E along dim 0) or the shard's own, in the
    order of ``owned_experts``."""
    local, t, d = xs.shape
    e, k, dvs = cfg.num_experts, cfg.experts_per_token, group.size
    shards = [group.rank + i for i in range(local)]
    routes = [route(router, xs[i], cfg) for i in range(local)]
    aux = torch.stack([switch_aux(route_stats(r, e), t, e) for r in routes])
    ids = torch.stack([r.ids for r in routes]).reshape(local, t * k)
    xk = xs.repeat_interleave(k, dim=1)
    capacity = ep_capacity(t, cfg)
    whole = stacks[0].shape[0] == e
    with exchange.counting_as(LABEL):
        (rx, rids), rt = exchange.dispatch(
            (xk, ids), _destinations(ids, shards, dvs, e), capacity,
            fills=(0, -1), group=group)
        outs = []
        for i, shard in enumerate(shards):
            mine = owned_experts(shard, dvs, e)
            experts = {eid: eid for eid in mine} if whole else \
                {eid: j for j, eid in enumerate(mine)}
            if not whole and stacks[0].shape[0] != len(mine):
                raise ValueError(f"shard {shard} holds {stacks[0].shape[0]} experts, owns "
                                 f"{len(mine)}")
            # a shard receives t k rows with a value under balanced routing
            outs.append(grouped_ffn(rx[i], rids[i], stacks, experts, real_rows=t * k))
        back = exchange.combine(torch.stack(outs), rt, fill=0)
    out = torch.stack([_weighted_sum(back[i].reshape(t, k, d), routes[i].w)
                       for i in range(local)])
    return out, aux, rt.num_dropped


def moe_ep(p: MoE, xs: torch.Tensor, cfg: ArchConfig, group=None):
    """Expert-parallel MoE of ``xs`` (local, t, d), the tokens of each local
    shard of ``group`` (``None``: the stacked group of ``xs.shape[0]``
    shards; a ``torch.distributed`` group or ``exchange.ProcessGroup``: one
    shard a rank).  Returns ``(out (local, t, d), aux (local,), num_dropped
    (local,))``: each shard's own aux (the reference's ``pmean`` of them is
    their mean over the shards) and its dropped rows.  Two exchange rounds,
    counted under :data:`LABEL`."""
    group = exchange.as_group(group, xs.shape[0])
    return _ep(p.router, _stacks(p), xs, cfg, group)


def moe(p: MoE, x: torch.Tensor, cfg: ArchConfig, parallel=None):
    """The reference's ``moe`` on one device: :func:`moe_dense` (EP needs a
    mesh over ranks: ``build_model(cfg, parallel)`` runs it through the
    model's layout)."""
    if ep_applies(parallel, cfg):
        raise ValueError("expert parallelism runs inside a model built over a mesh "
                         "(build_model(cfg, parallel)) or through moe_ep with a group")
    return moe_dense(p, x, cfg)


# ---------------------------------------------------------------------------
# the model's MoE residual and its aux over a pass
# ---------------------------------------------------------------------------
class AuxParts:
    """The MoE layers' aux and drops over one forward pass, finished once
    (:meth:`finish`).  Dense layers give their routing sums (summed over dp
    where the batch is split there); EP layers their local aux and drops
    (averaged and summed over the ep ranks, in rank order)."""

    def __init__(self, num_experts: int):
        self.e = num_experts
        self.dense: list = []  # (stats (2, E), tokens, summed over dp)
        self.ep_aux: Optional[torch.Tensor] = None  # (local,) Σ over layers
        self.ep_dropped: list = []  # per EP layer, (local,)

    def add_dense(self, stats: torch.Tensor, tokens: int, split: bool) -> None:
        self.dense.append((stats, tokens, split))

    def add_ep(self, aux: torch.Tensor, dropped: torch.Tensor) -> None:
        self.ep_aux = aux if self.ep_aux is None else self.ep_aux + aux
        self.ep_dropped.append(dropped)

    def finish(self, lay: layers.Layout, device) -> tuple:
        """``(Σ over layers of each layer's aux (f32 scalar), the dropped
        rows per EP layer summed over the ep ranks (int64 (L_ep,)))``."""
        from repro_torch.distributed import collectives

        total = torch.zeros((), dtype=torch.float32, device=device)
        if self.dense:
            stats = torch.stack([s for s, _, _ in self.dense])
            if any(split for _, _, split in self.dense):
                stats = collectives.sum_partials(lay.dp, stats)
            for i, (_, tokens, split) in enumerate(self.dense):
                n = tokens * (lay.dp.size if split else 1)
                total = total + switch_aux(stats[i], n, self.e)
        dropped = torch.zeros(0, dtype=torch.int64, device=device)
        if self.ep_aux is not None:
            drops = torch.stack(self.ep_dropped, dim=1).to(torch.int64)  # (local, L_ep)
            parts, per = self.ep_aux, drops
            if lay.dp.size > 1:  # one all-gather: every rank's aux and drops
                got = lay.dp.all_gather_bytes([drops.contiguous(),
                                               self.ep_aux.detach().contiguous()])
                per, parts = torch.cat(got[0]), torch.cat(got[1])
            mean = parts.sum() / parts.shape[0]
            if lay.dp.size > 1 and self.ep_aux.requires_grad:
                # + 0 in value: the rank's own aux carries its 1 / D of the gradient
                mean = mean + (self.ep_aux - self.ep_aux.detach()).sum() / parts.shape[0]
            total = total + mean
            dropped = per.sum(dim=0)
        return total, dropped


class Context:
    """How a pass runs its MoE layers: ``rows_split`` (the batch is split
    over dp, so EP may apply) and ``aux`` (an :class:`AuxParts` to fill, or
    None where the aux is not wanted: prefill and decode)."""

    def __init__(self, rows_split: bool = False, aux: Optional[AuxParts] = None):
        self.rows_split, self.aux = rows_split, aux


def apply(p: MoE, x: torch.Tensor, cfg: ArchConfig, lay: layers.Layout,
          ctx: Optional[Context]) -> torch.Tensor:
    """The MoE of a block's normed input ``x`` (the rank's rows, whole
    sequence) on a rank: EP over the dp ranks where :func:`ep_applies` and
    the rows are split, else the dense form over the experts the rank
    holds, summed over dp where the layout deals experts by owner.  Where
    the experts' ``f`` is split over tp the result is this rank's partial
    sum (the caller sums it over tp, as the MLP's ``w_down``)."""
    ctx = ctx or Context()
    router = lay.w(p.router)
    stacks = tuple(lay.w(w) for w in _stacks(p))
    owners = ep_applies(lay.parallel, cfg)
    e = cfg.num_experts
    if owners and ctx.rows_split:
        b, s, d = x.shape
        out, aux, dropped = _ep(router, stacks, x.reshape(1, b * s, d), cfg,
                                exchange.ProcessGroup(lay.dp.pg))
        if ctx.aux is not None:
            ctx.aux.add_ep(aux, dropped)
        return out.reshape(b, s, d)
    if owners:  # the rank's experts on every token, summed over the ep ranks
        from repro_torch.distributed import collectives

        mine = owned_experts(lay.dp.index, lay.dp.size, e)
        out, stats = _dense(router, stacks, x, cfg, {eid: j for j, eid in enumerate(mine)})
        out = collectives.sum_partials(lay.dp, out)
    else:
        out, stats = _dense(router, stacks, x, cfg, {eid: eid for eid in range(e)})
    if ctx.aux is not None:
        ctx.aux.add_dense(stats, x.shape[0] * x.shape[1], ctx.rows_split and lay.dp.size > 1)
    return out
