"""Dry run: every (arch x shape cell x mesh) traced on the meta device, one
rank standing for all (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 fake XLA devices and
reads the compiled program.  The port has no compiler to ask: it starts a
``torch.distributed`` group of the ``fake`` backend in this one process
(``torch.testing._internal.distributed.fake_pg``, a ``FakeStore``, rank 0
of 256 or 512), builds ``production_parallel`` over
``make_production_mesh``, and runs rank 0's train step, prefill or decode
step on meta tensors: the rank's blocks of every parameter
(``layout.block_of`` of the bundle's meta model), its optimizer state, its
caches (``init_cache``) and the cell's inputs.  Every collective goes
through the fake group (it moves nothing and returns the rank's own input)
and is counted by ``counting.record_collective``; nothing is allocated and
no card is needed.

What the record holds, per rank (the reference's field names where
``roofline.derive`` reads them: ``arch``, ``cell``, ``multi_pod``,
``chips``, ``status``, ``microbatches``, ``moe_impl``, ``terms_s``,
``bottleneck``, ``model_flops_global``, ``useful_flops_ratio``,
``params_total``, ``memory_analysis``):

* ``flops_per_rank`` (the reference's ``hlo_flops_per_device``):
  ``torch.utils.flop_counter.FlopCounterMode`` over the traced step, plus
  the work of kernels 6 and 7 (``kernel_work``), which trace as one call
  each: attention at its live (query, key) pairs (causal or windowed), not
  at the plain twin's whole score matrix, and the sLSTM recurrence at its
  recurrent products, each as its wrapper records it on meta tensors
  (``counting.record_kernel``).  Their backward passes are counted as a
  fused backward kernel would do them (``backward_work`` of each kernel);
  the port's backward today is the plain twin's, which materialises the
  score matrix, so a train cell's count is the design's, not today's.
* ``bytes_per_rank`` (``hlo_bytes_per_device``): each aten op's inputs
  plus outputs, views and allocations free, an in-place result counted
  once; kernels 6 and 7 at their reads and writes.  No fusion is modelled,
  so this is an upper bound of the HBM traffic.
* ``wire_bytes_per_rank``, ``wire_by_kind``, ``collective_op_counts`` and
  ``collective_bytes_by_kind`` (``collectives_lineparse``): every
  collective's count, input bytes and wire bytes by kind
  (``counting.wire_bytes``: the reference's model per kind), and an MoE's
  exchange rounds as ``"exchange"`` (an all-to-all of what the shard
  sends).
* ``memory_analysis``: ``param_bytes`` (the rank's parameter blocks,
  ``sharding.shard_bytes_per_device``), ``opt_state_bytes`` (AdamW's
  moments, the same specs), ``input_bytes`` (the batch or the token and
  positions), ``cache_bytes`` (the rank's caches), their sum as
  ``argument_size_in_bytes``, and ``temp_size_in_bytes``: the peak of the
  bytes of tensors made during the step and still alive (each storage
  tracked from the op that made it until it is freed).
* ``trace_s`` (the reference's ``lower_s`` / ``compile_s``): the seconds
  the trace took.
* ``terms_s`` with the H100 constants of ``analysis.roofline``.

Values the trace cannot read, and what the dry run takes for them:

* the decode step's write of the new token into a cache split by
  positions (each rank writes the rows whose position it holds) is traced
  as a write of every row (``attention.attention``): an upper bound;
* an MoE's rows per expert (``moe.grouped_ffn`` reads them from the ids):
  the balanced split the capacity design assumes (``moe.balanced_edges``);
* the exchange's and the table's ``agree`` reductions return the rank's
  own values (the fake group), which every rank of the design agrees on.

``model_flops`` is the reference's 6·N·D (train) / 2·N·D (inference)
convention over the whole parameters (an MoE's expert weights counted k/E,
found by the reference's rule).  The reference's ``--save-hlo`` and its
HLO cost parser (``analysis/hlo_cost.py``) have no counterpart.

    python -m repro_torch.launch.dryrun --arch all --cell all --mesh both [--out DIR]

writes one JSON a cell under ``--out`` (default ``results/dryrun``), skips
cells already written, and exits 1 if any cell errored; it needs no card.
``--arch`` and ``--cell`` also take comma lists.  A train cell runs
``--microbatches`` (default 8, the reference's) forward and backward
passes, each traced op by op: the sweep's train cells take most of its
time.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import counting
from repro_torch.analysis.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.configs.base import ARCH_IDS, SHAPE_SUITE, ArchConfig, ShapeCell, get_config
from repro_torch.configs.base import shape_cell

# Ops that move no bytes: allocations (their first write is counted) and
# metadata.
_FREE_OPS = {
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "_unsafe_view",
    "lift_fresh", "detach", "alias", "set_", "resize_", "_local_scalar_dense", "is_same_size",
    "_has_compatible_shallow_copy_type", "sym_size", "sym_stride", "sym_numel",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class Traffic(TorchDispatchMode):
    """Bytes each aten op reads and writes (inputs plus outputs; views,
    allocations and collectives free; an output that is one of the inputs
    counted once), and the peak of the bytes of the storages made inside
    the mode and still alive."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if func.is_view or name in _FREE_OPS or func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        ins = _tensors((args, kwargs))
        outs = [t for t in _tensors(out) if not any(t is i for i in ins)]
        self.bytes += sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        for t in outs:
            storage = t.untyped_storage()
            key = id(storage)
            if key not in self._sizes:
                self._sizes[key] = storage.nbytes()
                self.live += storage.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(storage, self._free, key)
        return out


@contextlib.contextmanager
def fake_group(world: int):
    """A ``torch.distributed`` default group of the fake backend: this
    process is rank 0 of ``world``; every collective returns at once."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake group: a process group is live")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# model-flops convention
# ---------------------------------------------------------------------------
def model_flops(cfg: ArchConfig, params: torch.nn.Module, cell: ShapeCell) -> float:
    """6·N·D (train) / 2·N·D (inference), N = active params (an MoE's expert
    weights, leaves of 3 or more dims with E at dim -3 under ``moe``, count
    k/E)."""
    named = dict(params.named_parameters())
    n_total = sum(p.numel() for p in named.values())
    n_active = n_total
    if cfg.is_moe:
        n_exp = sum(p.numel() for name, p in named.items()
                    if p.ndim >= 3 and p.shape[-3] == cfg.num_experts and "moe" in name)
        n_active = n_total - n_exp + n_exp * cfg.experts_per_token / cfg.num_experts
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch  # decode: one token a sequence


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def _rank_params(bundle, dtype: torch.dtype, trainable: bool) -> torch.nn.Module:
    """The rank's blocks of every parameter, on the meta device."""
    from repro_torch.models import api, transformer

    model = api.model_class(bundle.cfg)(bundle.cfg, dtype=dtype, device="meta")
    lay = bundle.layout
    if lay.sharded:
        blocks = {n: lay.block_of(n, p).clone() for n, p in model.named_parameters()}
        transformer.set_params(model, blocks)
    return transformer.trainable_params(model) if trainable else model


def _meta_inputs(specs: dict) -> dict:
    return {n: torch.zeros(s.shape, dtype=s.dtype, device="meta") for n, s in specs.items()}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _wire(scope: counting.Scope, exchange_group: int) -> tuple:
    """``(wire by kind, op counts by kind, input bytes by kind)`` of a
    scope, the exchange's rounds as ``"exchange"``."""
    wire = {k: float(v) for k, v in scope.collective_wire.items()}
    counts = dict(scope.collectives)
    nbytes = {k: int(v) for k, v in scope.collective_bytes.items()}
    if scope.exchange_rounds:
        g = max(exchange_group, 1)
        wire["exchange"] = scope.exchange_bytes * (g - 1) / g
        counts["exchange"] = scope.exchange_rounds
        nbytes["exchange"] = scope.exchange_bytes
    return wire, counts, nbytes


def trace_step(cfg: ArchConfig, cell: ShapeCell, mesh_shape: tuple, axis_names: tuple, *,
               microbatches: int = 8, moe_impl: str = "ep", seq_parallel: bool = True,
               seq_shard_decode: bool = False, act_barrier: bool = False) -> dict:
    """Rank 0's ``cell`` step of ``cfg`` over a mesh of ``mesh_shape`` with
    ``axis_names`` (the production layout, ``production_parallel``), traced
    on the meta device under a fake group of the mesh's size; the counts of
    the module docstring (no ``status``, ``arch`` or ``cell`` fields)."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import TrainStepConfig, make_train_step
    from torch.utils.flop_counter import FlopCounterMode

    chips = math.prod(mesh_shape)
    k = microbatches if cell.kind == "train" else 1
    dp = math.prod(s for s, a in zip(mesh_shape, axis_names) if a in ("pod", "data"))
    if cell.kind == "train" and cell.global_batch % (k * dp):
        k = 1
    with fake_group(chips):
        mesh = lmesh.device_mesh(mesh_shape, axis_names)
        parallel = lmesh.production_parallel(mesh, moe_impl=moe_impl, microbatches=k,
                                             seq_parallel=seq_parallel, act_barrier=act_barrier)
        if seq_shard_decode:
            parallel = dataclasses.replace(parallel, seq_shard_decode=True)
        bundle = build_model(cfg, parallel, device="meta")
        whole = bundle.param_shapes()
        train = cell.kind == "train"
        params = _rank_params(bundle, torch.float32 if train else transformer.compute_dtype(cfg),
                              trainable=train)
        memory = {"param_bytes": _nbytes(params.parameters()), "opt_state_bytes": 0,
                  "input_bytes": 0, "cache_bytes": 0}
        t0 = time.time()
        with counting.scoped() as scope, FlopCounterMode(display=False) as flops, \
                Traffic() as traffic:
            if train:
                tcfg = TrainStepConfig()
                opt = adamw_init(params, tcfg.adamw)
                memory["opt_state_bytes"] = _nbytes(list(opt["m"].values())
                                                    + list(opt["v"].values()))
                batch = _meta_inputs(bundle.train_input_specs(cell))
                memory["input_bytes"] = _nbytes(batch.values())
                make_train_step(bundle, tcfg)(params, opt, batch)
            elif cell.kind == "prefill":
                batch = _meta_inputs(bundle.prefill_input_specs(cell))
                memory["input_bytes"] = _nbytes(batch.values())
                bundle.prefill(params, batch, cache_len=cell.seq_len)
            else:
                b = cell.global_batch
                caches = bundle.init_cache(b, cell.seq_len)
                memory["cache_bytes"] = _nbytes(_tensors(dict(caches)))
                token = torch.zeros((b, 1), dtype=torch.int32, device="meta")
                pos = torch.zeros((b,), dtype=torch.int32, device="meta")
                memory["input_bytes"] = _nbytes((token, pos))
                bundle.decode_step(params, caches, token, pos)
        trace_s = time.time() - t0
        ep_group = bundle.layout.dp.size
    memory["argument_size_in_bytes"] = (memory["param_bytes"] + memory["opt_state_bytes"]
                                        + memory["input_bytes"] + memory["cache_bytes"])
    memory["temp_size_in_bytes"] = int(traffic.peak)
    kernel_flops = float(sum(scope.kernel_flops.values()))
    kernel_bytes = float(sum(scope.kernel_bytes.values()))
    total_flops = float(flops.get_total_flops()) + kernel_flops
    total_bytes = float(traffic.bytes) + kernel_bytes
    wire, counts, in_bytes = _wire(scope, ep_group)
    wire_total = float(sum(wire.values()))
    terms = {
        "compute_s": total_flops / PEAK_FLOPS,
        "memory_s": total_bytes / HBM_BW,
        "collective_s": wire_total / LINK_BW,
    }
    mf = model_flops(cfg, whole, cell)
    return {
        "chips": chips,
        "mesh_shape": list(mesh_shape),
        "microbatches": k,
        "moe_impl": moe_impl,
        "trace_s": round(trace_s, 3),
        "flops_per_rank": total_flops,
        "bytes_per_rank": total_bytes,
        "wire_bytes_per_rank": wire_total,
        "wire_by_kind": wire,
        "collective_op_counts": counts,
        "collective_bytes_by_kind": in_bytes,
        "kernel_work": {n: {"flops": float(scope.kernel_flops[n]),
                            "bytes": float(scope.kernel_bytes[n])}
                        for n in sorted(scope.kernel_flops)},
        "memory_analysis": memory,
        "terms_s": terms,
        "bottleneck": max(terms, key=terms.get),
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(total_flops * chips, 1.0),
        "params_total": sum(p.numel() for p in whole.parameters()),
    }


def dryrun_cell(arch: str, cell_name: str, multi_pod: bool, *, microbatches: int = 8,
                moe_impl: str = "ep", seq_shard_decode: bool = False, seq_parallel: bool = True,
                act_barrier: bool = False) -> dict:
    """One production cell: ``status`` ``skipped`` where ``supports_cell``
    refuses it, else :func:`trace_step` on the single-pod ``(16, 16)`` or
    multi-pod ``(2, 16, 16)`` mesh."""
    from repro_torch.launch.mesh import production_mesh_shape

    cfg = get_config(arch)
    cell = shape_cell(cell_name)
    ok, why = cfg.supports_cell(cell)
    if not ok:
        return {"arch": arch, "cell": cell_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    shape, names = production_mesh_shape(multi_pod)
    rec = trace_step(cfg, cell, shape, names, microbatches=microbatches, moe_impl=moe_impl,
                     seq_parallel=seq_parallel, seq_shard_decode=seq_shard_decode,
                     act_barrier=act_barrier)
    return {"arch": arch, "cell": cell_name, "multi_pod": multi_pod, "status": "ok", **rec}


def _human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} TiB"


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, help=f"one of {list(ARCH_IDS)}, a comma list, or all")
    ap.add_argument("--cell", default="all",
                    help=f"one of {[c.name for c in SHAPE_SUITE]}, a comma list, or all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--moe-impl", default="ep", choices=["ep", "dense"])
    ap.add_argument("--seq-shard-decode", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--act-barrier", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    cells = [c.name for c in SHAPE_SUITE] if args.cell == "all" else args.cell.split(",")
    for name, known in ((archs, ARCH_IDS), (cells, [c.name for c in SHAPE_SUITE])):
        bad = [x for x in name if x not in known]
        if bad:
            ap.error(f"unknown {bad}: choose from {list(known)}")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_all = time.time()
    for arch in archs:
        for cell in cells:
            for mp in meshes:
                tag = f"{arch}.{cell}.{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] {tag}: cached")
                    continue
                try:
                    rec = dryrun_cell(arch, cell, mp, microbatches=args.microbatches,
                                      moe_impl=args.moe_impl,
                                      seq_shard_decode=args.seq_shard_decode,
                                      seq_parallel=not args.no_seq_parallel,
                                      act_barrier=args.act_barrier)
                except Exception as e:  # record and go on with the sweep
                    failures += 1
                    rec = {"arch": arch, "cell": cell, "multi_pod": mp, "status": "error",
                           "error": repr(e), "traceback": traceback.format_exc()[-4000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    t = rec["terms_s"]
                    print(f"[dryrun] {tag}: OK trace={rec['trace_s']}s "
                          f"compute={t['compute_s']:.3e}s memory={t['memory_s']:.3e}s "
                          f"collective={t['collective_s']:.3e}s bottleneck={rec['bottleneck']} "
                          f"temp={_human(rec['memory_analysis']['temp_size_in_bytes'])}",
                          flush=True)
                elif rec["status"] == "skipped":
                    print(f"[dryrun] {tag}: SKIPPED ({rec['reason'][:90]})", flush=True)
                else:
                    print(f"[dryrun] {tag}: ERROR {rec['error'][:200]}", flush=True)
    print(f"[dryrun] sweep took {time.time() - t_all:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
