"""Training over a mesh: the pass every rank runs, on the CPU in the tests
(gloo) and on the card in ``chip_smoke.py``'s ``train-procs`` phase.

A :class:`TrainRunConfig` names the model, the kind of step and its mesh:

* ``"gspmd"``: the reference's GSPMD step written out (``train.step`` over
  a ``(data, model)`` mesh: ZeRO-3 over ``data``, tensor parallelism over
  ``model``);
* ``"manual_dp"``: the manual data-parallel step over ``(data,)`` with the
  int8 all-reduce (``train.manual_dp``);
* ``"pipeline"``: the GPipe step over ``(stage,)`` (``train.pipeline``).

:func:`run_train` builds the model (over the live group, or unsharded on
one card with ``sharded=False``), takes the weights from the seed by the
reference's rule (each rank its blocks of the whole f32 draw) or from the
reference's numpy masters, and runs ``steps`` steps on the same global
batches.  It returns, per rank, each step's metrics, wall, collectives and
their bytes (``counting.PROCESS``: a backward on the card runs on
autograd's own thread) and the digests of the rank's blocks,
the parameter and state bytes beside ``shard_bytes_per_device`` of their
specs, the kernel launches and peak bytes.  :func:`design_collectives` is
the count the design gives a step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch import counting

AXES = {"gspmd": ("data", "model"), "manual_dp": ("data",), "pipeline": ("stage",)}
DEDUP_HASH_RANGE = 1 << 16  # the loader's table over the group


@dataclasses.dataclass(frozen=True)
class TrainRunConfig:
    """One training run: the model, the kind of step, its mesh and data."""

    arch: str
    kind: str = "gspmd"  # "gspmd" | "manual_dp" | "pipeline"
    smoke: bool = False
    dtype: Optional[str] = None  # None: the config's
    num_layers: Optional[int] = None  # None: the config's (a cut of depth)
    mesh: tuple = (1, 1)  # the sizes of AXES[kind]
    batch: int = 4  # the global batch
    seq: int = 64
    microbatches: int = 1  # gspmd: accumulation; pipeline: the pipeline's
    steps: int = 2
    grad_compression: bool = False
    seq_parallel: bool = False
    lr: float = 1e-3
    warmup_steps: int = 1
    total_steps: int = 10
    dedup: Optional[str] = None  # None | "local" | "distributed" (the group's table)
    capacity_factor: Optional[float] = None  # None: the config's moe_capacity_factor
    clip_norm: float = 1.0
    seed: int = 0


def model_config(cfg: TrainRunConfig):
    """The run's ``ArchConfig`` (its dtype and depth cut applied)."""
    from repro_torch.configs.base import get_config, get_smoke_config

    mcfg = (get_smoke_config if cfg.smoke else get_config)(cfg.arch)
    changes = {}
    if cfg.dtype is not None:
        changes["dtype"] = cfg.dtype
    if cfg.num_layers is not None:
        changes["num_layers"] = cfg.num_layers
    if cfg.capacity_factor is not None:
        changes["moe_capacity_factor"] = cfg.capacity_factor
    return dataclasses.replace(mcfg, **changes) if changes else mcfg


def train_config(cfg: TrainRunConfig):
    from repro_torch.train import TrainStepConfig

    return TrainStepConfig(peak_lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                           total_steps=cfg.total_steps, clip_norm=cfg.clip_norm)


def parallel_of(cfg: TrainRunConfig):
    """The run's ``ParallelConfig`` over a mesh of the live group."""
    from repro_torch.distributed.parallel import ParallelConfig
    from repro_torch.launch import mesh as lmesh

    mesh = lmesh.device_mesh(cfg.mesh, AXES[cfg.kind])
    return ParallelConfig(
        mesh=mesh, dp_axes=("data",) if cfg.kind != "pipeline" else (),
        tp_axis="model" if cfg.kind == "gspmd" else None,
        microbatches=cfg.microbatches if cfg.kind == "gspmd" else 1,
        grad_compression=cfg.grad_compression, seq_parallel=cfg.seq_parallel,
        moe_impl="ep")  # the reference's production layout: an MoE trains through the exchange


def unsharded_microbatches(cfg: TrainRunConfig) -> int:
    """The one-card step's accumulation that averages the same rows as the
    run's step: the gspmd and pipeline microbatches, manual DP's ranks."""
    return cfg.mesh[0] if cfg.kind == "manual_dp" else cfg.microbatches


def draw_batches(cfg: TrainRunConfig, device, group=None) -> list:
    """The run's global batches, one a step: ``ShardedLoader`` over
    ``SyntheticCorpus(dup_rate=0.05)`` drawn on ``device`` from the seed,
    with the HashGraph dedup of ``cfg.dedup`` ("distributed": over a
    ``DistributedHashTable`` of ``group``, each rank passing its rows; on
    one card the local dedup, the same mask)."""
    from repro_torch.data import ShardedLoader, SyntheticCorpus

    mcfg = model_config(cfg)
    corpus = SyntheticCorpus(vocab_size=mcfg.vocab_size, seq_len=cfg.seq, seed=cfg.seed,
                             dup_rate=0.05, device=device)
    dedup, table = cfg.dedup, None
    if dedup == "distributed":
        if group is None:
            dedup = "local"
        else:
            from repro_torch import DistributedHashTable

            table = DistributedHashTable(group=group, hash_range=DEDUP_HASH_RANGE, device=device)
    loader = ShardedLoader(corpus, cfg.batch, dedup=dedup, dedup_table=table)
    return [loader.next_batch()["tokens"] for _ in range(cfg.steps)]


def draw_frames(cfg: TrainRunConfig, device) -> list:
    """An encoder-decoder run's stub frames, one (batch, frontend_len,
    d_model) f32 standard-normal draw a step from the seed (None else)."""
    mcfg = model_config(cfg)
    if not mcfg.is_encoder_decoder:
        return [None] * cfg.steps
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 7)
    return [torch.randn((cfg.batch, mcfg.frontend_len, mcfg.d_model), generator=gen,
                        device=device) for _ in range(cfg.steps)]


# ---------------------------------------------------------------------------
# the design
# ---------------------------------------------------------------------------
def _ep_applies(mcfg, d: int) -> bool:
    """Whether an MoE stack's layers run through the exchange over ``d`` dp
    ranks (``models.moe.ep_applies``; the train step's rows divide)."""
    e = mcfg.num_experts
    return mcfg.is_moe and d > 1 and (d % e == 0 or e % d == 0)


def design_rounds(mcfg, mesh: Sequence[int], microbatches: int, *, remat: bool = True) -> dict:
    """The exchange rounds one ``"gspmd"`` step makes by the design, by
    label: an MoE layer under expert parallelism dispatches and combines
    (two rounds) in the forward pass, sends the gradients back the same
    two ways in the backward pass, and under remat runs its two forward
    rounds again in the recomputation: six a MoE layer a microbatch."""
    d = mesh[0]
    if not _ep_applies(mcfg, d):
        return {}
    from repro_torch.models import moe

    return {moe.LABEL: (4 + 2 * int(remat)) * mcfg.num_layers * microbatches}


def design_collectives(mcfg, mesh: Sequence[int], kind: str, seq: int, batch: int,
                       microbatches: int, *, grad_compression: bool = False,
                       seq_parallel: bool = False, remat: bool = True) -> dict:
    """The collectives one step makes by the design, ``{kind: count}``, for
    ``mcfg`` on ``mesh`` (the sizes of ``AXES[kind]``), a global batch of
    ``batch`` sequences of ``seq`` tokens:

    * ``"gspmd"`` on ``(d, t)``, per microbatch: the embedding's sum over tp
      (a reduce-scatter under sequence parallelism, whose backward
      all-gathers); a period's FSDP all-gather over dp, twice under remat
      (the forward and its recomputation), and its reduce-scatter in the
      backward; per attention and MLP over tp: the input's entry (under
      sequence parallelism an all-gather forward, a reduce-scatter
      backward, and the norm's all-reduce backward; else an all-reduce
      backward), the row-parallel sum (an all-reduce, or a reduce-scatter
      whose backward all-gathers; the recomputation stops at the last
      operation that keeps a tensor for the backward, so a period's last
      row-parallel sum runs once), the qk norms' all-reduces backward, the
      q/k/v blocks' all-gather where the kv heads do not divide over tp
      (its backward a reduce-scatter); an mLSTM or sLSTM block's own
      (``_recurrent_block``); the head's entry (an all-reduce
      backward) and the all-gather of the vocab blocks; over dp the loss's
      all-reduce and, after the backward, one all-reduce a dtype of the
      leaves whole over dp; an MoE stack's aux over dp (EP: one all-gather
      of every rank's; its exchange rounds count apart, :func:`design_rounds`;
      dense: one all-reduce of the routing sums).  Once a step: the clip's
      all-reduce over the group, and error feedback's maximum;
    * ``"manual_dp"`` on ``(d,)``: per parameter leaf an all-to-all and two
      all-gathers (int8 compression) or one all-reduce; the metrics'
      all-reduce;
    * ``"pipeline"`` on ``(S,)``: ``M + S - 2`` hops forward and as many
      backward, and three all-reduces (the replicated leaves' gradients,
      the norm, the loss).

    Every call over an axis of one rank is absent."""
    out: dict = {}

    def add(k, n=1):
        if n:
            out[k] = out.get(k, 0) + n

    if kind == "pipeline":
        (s,) = mesh
        if s > 1:
            add("ppermute", 2 * (microbatches + s - 2))
            add("all_reduce", 3)
        return out
    if kind == "manual_dp":
        (d,) = mesh
        if d > 1:
            from repro_torch.models import transformer

            leaves = sum(1 for _ in transformer.Transformer(mcfg, dtype=torch.float32,
                                                            device="meta").parameters())
            if grad_compression:
                add("all_to_all", leaves)
                add("all_gather", 2 * leaves)
            else:
                add("all_reduce", leaves)
            add("all_reduce")
        return out
    d, t = mesh
    k = microbatches
    sp = seq_parallel and t > 1 and seq % t == 0
    passes = 2 if remat else 1
    vocab_split = t > 1 and mcfg.vocab_size % t == 0
    for _ in range(k):
        if vocab_split:
            add("reduce_scatter" if sp else "all_reduce")
            add("all_gather", int(sp))
        elif sp:
            add("all_gather")  # the split's backward
        for _ in range(mcfg.num_periods):
            if d > 1:
                add("all_gather", passes)
                add("reduce_scatter")
            if t == 1:
                continue
            for j, bt in enumerate(mcfg.block_pattern):
                # the period's last row-parallel sum keeps no tensor: not recomputed
                last = passes if j < len(mcfg.block_pattern) - 1 else 1
                if bt in ("attn", "swa", "local"):
                    _attn_block(add, mcfg, t, sp, passes, last)
                else:
                    _recurrent_block(add, mcfg, bt, t, passes, last)
        if sp:
            add("all_gather")  # the trunk's end, whole for the head
        if vocab_split:
            add("all_gather")
            add("all_reduce")  # the head's entry, backward
        if d > 1:
            if not mcfg.tie_embeddings:
                add("all_gather")  # lm_head's FSDP block
                add("reduce_scatter")
            add("all_reduce")  # the loss
            # the leaves whole over dp, one call a dtype: bf16 matrices and f32
            # vectors (an MoE stack trains on its f32 masters: one)
            add("all_reduce", 1 if mcfg.is_moe else 2)
            if mcfg.is_moe:  # the aux: EP's all-gather of every rank's, dense's routing sums
                add("all_gather" if _ep_applies(mcfg, d) else "all_reduce")
                add("all_reduce", int(_ep_applies(mcfg, d) and d > mcfg.num_experts))
    if d * t > 1:
        add("all_reduce", 1 + int(grad_compression))
    return out


def _attn_block(add, mcfg, t: int, sp: bool, passes: int, last: int) -> None:
    """An attention block's collectives over tp (``design_collectives``)."""
    h, kv, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim_
    sublayers = ("attn", "mlp") if mcfg.d_ff > 0 else ("attn",)  # d_ff 0: attention alone
    for sublayer in sublayers:
        rows = h * hd if sublayer == "attn" else mcfg.d_ff
        partial = rows % t == 0
        sums = last if sublayer == sublayers[-1] else passes
        if sp:
            add("all_gather", passes)  # the input's sequence blocks
            add("all_reduce")  # the norm's gradient
            add("reduce_scatter" if partial else "all_gather")  # the input's backward
            if partial:
                add("reduce_scatter", sums)
                add("all_gather")
            else:
                add("all_gather")  # the split's backward
        elif partial:
            add("all_reduce")  # the input's backward
            add("all_reduce", sums)
        if sublayer == "attn" and partial:
            add("all_reduce", 2 * int(mcfg.qk_norm))
            if kv % t and (kv * hd) % t == 0:
                add("all_gather", passes)
                add("reduce_scatter")


def _recurrent_block(add, mcfg, bt: str, t: int, passes: int, last: int) -> None:
    """An mLSTM or sLSTM block's collectives over tp, its heads and widths
    dividing over tp (``design_collectives``): the input's entry (an
    all-reduce backward), the gathers of the projections whose blocks do
    not line up with the heads (mLSTM: ``u`` and the gates; sLSTM: the
    gate-major projection; reduce-scatters backward), the out-norm's sum of
    squares (an all-reduce, and two backward: the sum's and the norm
    weight's), the replicated weights applied to a rank's heads (sLSTM's
    ``b`` and ``r``: all-reduces backward) and the row-parallel sum."""
    if bt == "mlstm":
        from repro_torch.models.ssm import mlstm_dims

        nh, _, dv = mlstm_dims(mcfg)
        gathers = int(nh * dv % t == 0) + int(2 * nh % t == 0)
        shared = 0
    else:
        gathers, shared = int(4 * mcfg.d_model % t == 0), 2
    add("all_gather", gathers * passes)
    add("reduce_scatter", gathers)
    add("all_reduce", 1 + passes + 2 + shared + last)


def int8_wire_bytes(numels: Sequence[int], d: int) -> dict:
    """The bytes a rank's input carries in one int8 all-reduce of each leaf
    of ``numels`` elements over ``d`` ranks (``compressed_psum_int8``): the
    all-to-all one byte an element of the padded leaf; the all-gathers the
    ``d`` f32 scales, then one byte an element of the rank's chunk and its
    f32 scale."""
    a2a = ag = 0
    for n in numels:
        padded = n + (-n) % d
        a2a += padded
        ag += 4 * d + padded // d + 4
    return {"all_to_all": a2a, "all_gather": ag}


def expected_bytes(cfg: TrainRunConfig, sharded: bool = True) -> tuple[int, int]:
    """``(parameter, state)`` bytes a rank holds by ``shard_bytes_per_device``
    of their specs: f32 masters and moments, a bf16 ``ef_error`` where the
    step keeps one, the 4-byte step."""
    from repro_torch.distributed import sharding
    from repro_torch.models.api import model_class

    mcfg = model_config(cfg)
    meta = model_class(mcfg)(mcfg, dtype=torch.float32, device="meta")
    leaves = dict(meta.named_parameters())
    shape = dict(zip(AXES[cfg.kind], cfg.mesh)) if sharded else {}
    if sharded and cfg.kind == "gspmd":
        from repro_torch.distributed.parallel import AbstractMesh, ParallelConfig

        par = ParallelConfig(mesh=AbstractMesh(tuple(cfg.mesh), AXES["gspmd"]), moe_impl="ep")
        specs = sharding.param_pspecs(meta, par)
    elif sharded and cfg.kind == "pipeline":  # the periods stacked, on the stage axis
        from repro_torch.train.pipeline import pipeline_param_specs

        spec_for = pipeline_param_specs("stage")
        stacked = {}
        for name, p in leaves.items():
            if name.startswith("layers."):
                rest = name.split(".", 2)[2]
                stacked[f"layers.{rest}"] = torch.empty((mcfg.num_periods, *p.shape),
                                                        dtype=p.dtype, device="meta")
            else:
                stacked[name] = p
        leaves = stacked
        specs = {n: spec_for(n.split(".")[0]) for n in leaves}
    else:
        specs = {n: () for n in leaves}
    params = sharding.shard_bytes_per_device(leaves, specs, shape)
    if not sharded:
        ef = cfg.grad_compression and cfg.kind == "gspmd"
    else:
        ef = {"gspmd": cfg.grad_compression, "manual_dp": True, "pipeline": False}[cfg.kind]
    return params, 2 * params + (params // 2 if ef else 0) + 4


DIGEST_CHUNK = 1 << 22


def _digest(t: torch.Tensor) -> str:
    """A checksum of ``t``'s bits on its device: the sum of its 16- or 32-bit
    words and their sum weighted by position (as int64), a chunk at a
    time; equal tensors give equal digests, and two that differ in a word
    almost surely do not."""
    words = t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
    total = weighted = 0
    for at in range(0, words.numel(), DIGEST_CHUNK):
        w = words[at:at + DIGEST_CHUNK].to(torch.int64)
        pos = torch.arange(at + 1, at + 1 + w.numel(), dtype=torch.int64, device=w.device)
        total += int(w.sum())
        weighted += int((w * pos).sum())
    return f"{t.dtype}:{tuple(t.shape)}:{total}:{weighted}"


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
def _global_name(cfg: TrainRunConfig, name: str, stage: Optional[int]) -> str:
    """A pipeline stage's local parameter name as the whole model's (``stage``
    None: the whole model's already)."""
    if cfg.kind != "pipeline" or stage is None or not name.startswith("layers."):
        return name
    from repro_torch.train.pipeline import stage_periods

    _, i, rest = name.split(".", 2)
    return f"layers.{stage_periods(model_config(cfg), cfg.mesh[0], stage)[int(i)]}.{rest}"


def _state(cfg: TrainRunConfig, bundle, tcfg, sharded: bool, weights,
           stacked: Optional[int] = None):
    """``(params, opt_state, step_fn, stage)`` of this rank (``stacked``: the
    stacked EP step over that many shards, on one card)."""
    from repro_torch.models import convert, transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_state, make_train_step
    from repro_torch.train import manual_dp, pipeline

    dev, mcfg = bundle.device, bundle.cfg
    kind = cfg.kind if sharded else "one-card"
    stage = None

    def whole_from(tree, parallel=None):
        return transformer.trainable_params(convert.params_from_numpy(
            tree, mcfg, device=dev, dtype=torch.float32, parallel=parallel))

    def with_ef(params, opt):
        if kind == "manual_dp" or bundle.parallel.grad_compression:
            opt["ef_error"] = {n: torch.zeros(p.shape, dtype=torch.bfloat16, device=dev)
                               for n, p in params.named_parameters()}
        return params, opt

    if kind == "pipeline":
        from repro_torch.distributed import collectives

        stage = collectives.coordinate(bundle.parallel.mesh)["stage"]
        step = pipeline.make_pp_train_step(bundle, tcfg, num_microbatches=cfg.microbatches)
        if weights is None:
            params, opt = pipeline.make_pp_train_state(bundle, tcfg, cfg.seed)
        else:
            params = pipeline.stage_params(whole_from(weights), cfg.mesh[0], stage)
            opt = adamw_init(params, tcfg.adamw)
        return params, opt, step, stage
    if kind == "manual_dp":
        step = manual_dp.make_manual_dp_train_step(bundle, tcfg)
        if weights is None:
            params, opt = manual_dp.make_manual_dp_train_state(bundle, tcfg, cfg.seed)
        else:
            params = whole_from(weights)
            params, opt = with_ef(params, adamw_init(params, tcfg.adamw))
        return params, opt, step, stage
    if stacked is not None:
        from repro_torch.train.step import make_ep_stacked_train_step

        step = make_ep_stacked_train_step(bundle, tcfg, stacked)
    else:
        step = make_train_step(bundle, tcfg)
    if weights is None:
        params, opt = make_train_state(bundle, tcfg, cfg.seed)
    else:
        params = whole_from(weights, bundle.parallel if kind == "gspmd" else None)
        params, opt = with_ef(params, adamw_init(params, tcfg.adamw))
    return params, opt, step, stage


def run_train(cfg: TrainRunConfig, *, sharded: bool = True, device=None, weights=None,
              batches=None, group=None, keep_blocks: bool = False, on_step=None,
              extra_step=None, stacked: Optional[int] = None,
              timeout_s: Optional[float] = None) -> dict:
    """Run ``cfg``'s steps on this rank (``sharded``: over the live group's
    mesh; else the one-card step with ``unsharded_microbatches``) on
    ``device`` (``None``: the card, raising without one).  ``weights``: the
    reference's numpy masters (f32, its pytree layout), else the seeded
    draw; ``batches``: the global token batches, else ``draw_batches`` (with
    ``group`` for the distributed dedup).  ``on_step(i, params, opt,
    bundle)``, where given, runs after step ``i`` (from 0) outside the
    step's counts and its result is kept as that step's ``"check"``;
    ``extra_step(step, params, opt, batch)`` runs one more step on the first
    batch after the counted ones (a profile), its result kept as
    ``"extra"``.  ``stacked=D`` (with ``sharded=False``) runs the stacked
    twin of the EP step over D shards (``make_ep_stacked_train_step``)
    instead of the one-card step.  An encoder-decoder's steps take the stub
    frames of ``draw_frames``.
    Returns the rank's figures; with ``keep_blocks`` also its parameter
    blocks and first moments after the last step as numpy, by the whole
    model's names."""
    import torch.distributed as dist

    from repro_torch.core import exchange
    from repro_torch.distributed.parallel import single_device_parallel
    from repro_torch.kernels import build
    from repro_torch.models.api import build_model, resolve_device
    from repro_torch.utils import tree_size_bytes

    dev = resolve_device(device)
    mcfg, tcfg = model_config(cfg), train_config(cfg)
    if sharded:
        parallel = parallel_of(cfg)
    else:
        parallel = dataclasses.replace(
            single_device_parallel(), microbatches=unsharded_microbatches(cfg),
            grad_compression=cfg.grad_compression and cfg.kind == "gspmd")
    bundle = build_model(mcfg, parallel, device=dev, timeout_s=timeout_s)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    params, opt, step, stage = _state(cfg, bundle, tcfg, sharded, weights, stacked)
    sync()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build.LAUNCHES.clear()
    if batches is None:
        batches = draw_batches(cfg, dev, group if sharded else None)
    batches = [torch.as_tensor(b, device=dev) for b in batches]
    frames = draw_frames(cfg, dev)
    sync()
    data_s = time.perf_counter() - t0
    data_launches = dict(build.LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.LAUNCHES.clear()
    steps = []
    for i, toks in enumerate(batches):
        sync()
        start = time.perf_counter()
        scope = counting.PROCESS  # the backward's collectives run on autograd's thread
        scope.collectives.clear()
        scope.collective_bytes.clear()
        exchange.CALLS.clear()  # every thread's rounds, by label
        params, opt, metrics = step(params, opt, {"tokens": toks, "frames": frames[i]})
        sync()
        secs = time.perf_counter() - start
        steps.append({
            "step": i + 1, "s": secs,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "collectives": dict(scope.collectives), "bytes": dict(scope.collective_bytes),
            "rounds": dict(exchange.CALLS),
            "digests": {_global_name(cfg, n, stage): _digest(p)
                        for n, p in params.named_parameters()},
        })
        if on_step is not None:
            steps[-1]["check"] = on_step(i, params, opt, bundle)
    launches = dict(build.LAUNCHES)
    extra = None if extra_step is None else extra_step(
        step, params, opt, {"tokens": batches[0], "frames": frames[0]})
    expect = expected_bytes(cfg, sharded)
    rank = dist.get_rank() if sharded and dist.is_initialized() else 0
    out = {
        "rank": rank, "kind": cfg.kind, "mesh": tuple(cfg.mesh) if sharded else None,
        "arch": mcfg.name, "layers": mcfg.num_layers, "dtype": mcfg.dtype,
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "stage": stage, "coord": dict(bundle.layout.coord) if sharded else {},
        "steps": steps,
        "batch_digests": [_digest(b) for b in batches],
        "param_bytes": tree_size_bytes(params), "state_bytes": tree_size_bytes(opt),
        "expected_param_bytes": expect[0], "expected_state_bytes": expect[1],
        "block_slices": {}, "launches": launches, "data_launches": data_launches,
        "init_s": init_s, "data_s": data_s, "extra": extra,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }
    if sharded and cfg.kind == "gspmd":
        from repro_torch.distributed import sharding

        lay = bundle.layout
        out["block_slices"] = {
            n: [(sl.start or 0) for sl in sharding.block_slices(lay.full_shapes[n], lay.specs[n],
                                                                 parallel.mesh, lay.coord)]
            for n in lay.specs}
    if keep_blocks:
        named = dict(params.named_parameters())
        out["blocks"] = {_global_name(cfg, n, stage): p.detach().cpu().numpy()
                         for n, p in named.items()}
        out["m"] = {_global_name(cfg, n, stage): opt["m"][n].cpu().numpy() for n in named}
    return out


def rank_job(group, configs: Sequence[TrainRunConfig], device=None,
             timeout_s: Optional[float] = None) -> list:
    """A rank's runs of ``configs`` in turn over the group (a ``spawn``
    target), each freed before the next."""
    import gc

    out = []
    for cfg in configs:
        out.append(run_train(cfg, device=device, group=group, timeout_s=timeout_s))
        gc.collect()
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out
