"""Training over a mesh of gloo ranks, held against the JAX package's steps
on Auto-axis meshes of fake CPU devices.

* Every collective that carries a gradient (``distributed.collectives``:
  ``gather``, ``gather_whole``, ``scatter_sum``, ``split``,
  ``sum_partials``, ``enter_sharded``, ``all_to_all``, ``ppermute``,
  ``gather_cols``, ``gather_blocks``) over the data and model axes of a
  (2, 2) mesh and over the whole group: its forward and its backward
  against the sum or concatenation it stands for, computed from every
  rank's seeded inputs (1e-6: f32 sums of four terms in another order).
* ``compressed_psum_int8`` at (4,) on the reference's own (4, 1000) draw
  against the reference's (both quantize the same f32 values with the
  same rounding; 1e-6 of the mean's scale, a requantization step where a
  value lands on a rounding tie apart), and within the reference's 5 % of
  the exact mean; every rank the same bits, one byte a padded element on
  the all-to-all.
* The GSPMD step (``train.step`` over the mesh: ZeRO-3 over ``data``,
  tensor parallelism over ``model``, the bf16 compute copy) on (2, 2)
  with 2 microbatches (and again with sequence parallelism, held against
  the same reference), (4, 1) and (1, 2), 2 steps on the reference's f32
  masters of the smoke qwen3-4b, and on (2, 2) of the smoke xlstm-1.3b
  (its mLSTM and sLSTM blocks over tp) (f32 compute, so the compute copy's
  bf16 rounding is the only one): ``loss`` and ``ce`` within 1e-4 relative
  (the same bf16 weights, summed in another order), ``grad_norm`` within
  1e-2 (bf16 gradient reductions in another order); each rank's blocks of
  the first moment after 2 steps within ``BF16_CEILING`` (5e-2) of each
  leaf's largest reference entry, and of the parameters within 2 lr of the
  reference's over the two steps (AdamW's early steps move a weight by
  about lr whatever its gradient's size, so a gradient within a bf16
  rounding of 0 may move it the other way).  Every rank's replicated
  blocks are the same bits, and its parameter and state bytes equal
  ``shard_bytes_per_device`` of their specs.
* Manual DP over (4,), with and without int8 compression, 3 steps, against
  the reference's ``make_manual_dp_train_step``: loss within 1e-4 and
  grad norm within 1e-3 relative (f32 throughout; the two packages'
  gradients agree within 1e-3 of each leaf's scale, as on one device,
  ``tests/test_torch_train.py``), every parameter within 2 lr of the
  reference's over the steps (AdamW's sign-like early steps, or a
  quantization tie rounded the other way) and, without compression, 99 %
  of the entries within 1e-5.
* Every step's collectives equal ``train_run.design_collectives``; the
  optimizer's specs (ZeRO) and the clip's block counting.
* ``launch/train.py --fake-devices 4 --smoke --device cpu``.

One spawn a world size (4 and 2; ``file://`` stores under ``tmp_path``);
the references run on a thread meanwhile.
"""
import dataclasses
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch import train_run  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

TIMEOUT_S = 120.0
SEQ, BATCH = 32, 8
LR, STEPS_GSPMD, STEPS_DP = 1e-3, 2, 3
BF16_CEILING = 5e-2
COLL_TOL = 1e-6
BASE = dict(smoke=True, dtype="float32", seq=SEQ, batch=BATCH, lr=LR, warmup_steps=1,
            total_steps=10)
ARCHS = ("qwen3_4b", "xlstm_1_3b")
WORLD4 = (
    ("gspmd-2x2", dict(kind="gspmd", mesh=(2, 2), microbatches=2, steps=STEPS_GSPMD)),
    ("xlstm-2x2", dict(arch="xlstm_1_3b", kind="gspmd", mesh=(2, 2), microbatches=2,
                       steps=STEPS_GSPMD)),
    ("gspmd-2x2-sp", dict(kind="gspmd", mesh=(2, 2), microbatches=2, steps=STEPS_GSPMD,
                          seq_parallel=True)),
    ("gspmd-4x1", dict(kind="gspmd", mesh=(4, 1), steps=STEPS_GSPMD)),
    ("dp-int8", dict(kind="manual_dp", mesh=(4,), grad_compression=True, steps=STEPS_DP)),
    ("dp-f32", dict(kind="manual_dp", mesh=(4,), steps=STEPS_DP)),
)
WORLD2 = (("gspmd-1x2", dict(kind="gspmd", mesh=(1, 2), steps=STEPS_GSPMD)),)
# Runs held against another run's reference: sequence parallelism changes
# where the sums run, not what they are.
REFERENCE_OF = {"gspmd-2x2-sp": "gspmd-2x2"}


def _cfg(kw) -> train_run.TrainRunConfig:
    return train_run.TrainRunConfig(**{"arch": "qwen3_4b", **BASE, **kw})


def _tokens(steps: int) -> list:
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, (BATCH, SEQ + 1), dtype=np.int32) for _ in range(steps)]


# ---------------------------------------------------------------------------
# the rank jobs
# ---------------------------------------------------------------------------
def _draw(tag: int, rank: int, shape) -> torch.Tensor:
    g = torch.Generator().manual_seed(1000 * tag + rank)
    return torch.randn(shape, generator=g)


def _check_functions(axis, tag: int) -> dict:
    """Each gradient-carrying collective over ``axis``: forward and gradient
    against what every rank's seeded inputs give.  Returns name → (forward
    error, gradient error)."""
    from repro_torch.distributed import collectives as C

    n, r = axis.size, axis.index
    out = {}

    def run(name, fn, x, upstream):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (g,) = torch.autograd.grad((y * upstream).sum(), [x])
        return y.detach(), g

    def err(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    xs = [_draw(tag, i, (4, 6)) for i in range(n)]  # every rank's input
    ws = [_draw(tag + 50, i, (4 * n, 6)) for i in range(n)]  # every rank's upstream
    same = _draw(tag + 99, 0, (4 * n, 6))
    # gather: the result feeds each rank's own compute (partial upstreams)
    y, g = run("gather", lambda x: C.gather(axis, x, 0), xs[r], ws[r])
    out["gather"] = (err(y, torch.cat(xs)), err(g, sum(w[4 * r:4 * r + 4] for w in ws)))
    y, g = run("gather_whole", lambda x: C.gather_whole(axis, x, 0), xs[r], same)
    out["gather_whole"] = (err(y, torch.cat(xs)), err(g, same[4 * r:4 * r + 4]))
    big = [_draw(tag + 7, i, (4 * n, 6)) for i in range(n)]
    y, g = run("scatter_sum", lambda x: C.scatter_sum(axis, x, 0), big[r], ws[r][:4])
    out["scatter_sum"] = (err(y, sum(b[4 * r:4 * r + 4] for b in big)),
                          err(g, torch.cat([w[:4] for w in ws])))
    y, g = run("split", lambda x: C.split(axis, x, 0), same, ws[r][:4])
    out["split"] = (err(y, same[4 * r:4 * r + 4]), err(g, torch.cat([w[:4] for w in ws])))
    y, g = run("sum_partials", lambda x: C.sum_partials(axis, x), xs[r], same[:4])
    out["sum_partials"] = (err(y, sum(xs)), err(g, same[:4]))
    y, g = run("enter_sharded", lambda x: C.enter_sharded(axis, x), same[:4], ws[r][:4])
    out["enter_sharded"] = (err(y, same[:4]), err(g, sum(w[:4] for w in ws)))
    rows = [_draw(tag + 11, i, (n, 3)) for i in range(n)]
    y, g = run("all_to_all", lambda x: C.all_to_all(axis, x), rows[r], ws[r][:n, :3])
    out["all_to_all"] = (err(y, torch.stack([rows[i][r] for i in range(n)])),
                         err(g, torch.stack([ws[j][:n, :3][r] for j in range(n)])))
    y, g = run("ppermute", lambda x: C.ppermute(axis, x, 1), xs[r], ws[r][:4])
    want_y = xs[r - 1] if r > 0 else torch.zeros(4, 6)
    want_g = ws[r + 1][:4] if r + 1 < n else torch.zeros(4, 6)
    out["ppermute"] = (err(y, want_y), err(g, want_g))
    cols = [_draw(tag + 13, i, (2, 3)) for i in range(n)]
    wc = [_draw(tag + 17, i, (2, 3 * n)) for i in range(n)]
    y, g = run("gather_cols", lambda x: torch.cat(C.gather_cols(axis, [x, 2 * x]), 0),
               cols[r], torch.cat([wc[r], wc[r]]))
    want = sum(3 * w[:, 3 * r:3 * r + 3] for w in wc)
    out["gather_cols"] = (err(y[:2], torch.cat(cols, 1)), err(g, want))
    y, g = run("gather_blocks", lambda x: C.gather_blocks(axis, [x], [0])[0], xs[r], ws[r])
    out["gather_blocks"] = (err(y, torch.cat(xs)), err(g, sum(w[4 * r:4 * r + 4] for w in ws)))
    return out


def _psum(group, x: np.ndarray) -> dict:
    from repro_torch.counting import scoped
    from repro_torch.distributed import collectives
    from repro_torch.optim import compressed_psum_int8

    with scoped() as s:
        got = compressed_psum_int8(torch.from_numpy(x[group.rank]).reshape(-1),
                                   collectives.world())
    return {"got": got.numpy(), "bytes": dict(s.collective_bytes),
            "calls": dict(s.collectives)}


def _specs_and_clip() -> dict:
    """The optimizer's specs over (2, 2) and the clip's counting of blocks."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.distributed import collectives, sharding
    from repro_torch.models.api import build_model
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.train import make_train_state, TrainStepConfig

    cfg = _cfg(dict(kind="gspmd", mesh=(2, 2), grad_compression=True))
    bundle = build_model(train_run.model_config(cfg), train_run.parallel_of(cfg), device="cpu")
    params, opt = make_train_state(bundle, TrainStepConfig(), 0)
    lay = bundle.layout
    specs = sharding.opt_state_pspecs(lay.specs, True)
    shapes_ok = all(opt[k][n].shape == p.shape for k in ("m", "v", "ef_error")
                    for n, p in params.named_parameters())
    grads = {n: torch.ones_like(p) for n, p in params.named_parameters()}
    counted = {n: sharding.counts_block(sp, bundle.parallel.mesh, lay.coord)
               for n, sp in lay.specs.items()}
    _, norm = clip_by_global_norm(grads, 1e9, counted=counted, axis=collectives.world())
    whole = sum(math.prod(s) for s in lay.full_shapes.values())
    return {"specs": specs, "param_specs": dict(lay.specs), "shapes_ok": shapes_ok,
            "step_spec": specs["step"], "norm": float(norm), "whole": whole,
            "ef_dtype": str(next(iter(opt["ef_error"].values())).dtype)}


def world4_job(group, weights, tokens, cfgs, psum_x) -> dict:
    from repro_torch.distributed import collectives
    from repro_torch.distributed.parallel import ParallelConfig

    out = {"rank": group.rank}
    par = ParallelConfig(mesh=lmesh.device_mesh((2, 2), ("data", "model")))
    dp, tp = collectives.bind(par)
    out["functions"] = {"data": _check_functions(dp, 1), "model": _check_functions(tp, 2),
                        "world": _check_functions(collectives.world(), 3)}
    out["psum"] = _psum(group, psum_x)
    out["specs"] = _specs_and_clip()
    out["runs"] = [train_run.run_train(c, device="cpu", weights=weights[c.arch],
                                       batches=tokens[:c.steps], keep_blocks=True,
                                       timeout_s=TIMEOUT_S) for c in cfgs]
    return out


def world2_job(group, weights, tokens, cfgs) -> dict:
    from repro_torch.distributed import collectives

    out = {"rank": group.rank, "functions": {"world": _check_functions(collectives.world(), 4)}}
    out["runs"] = [train_run.run_train(c, device="cpu", weights=weights[c.arch],
                                       batches=tokens[:c.steps], keep_blocks=True,
                                       timeout_s=TIMEOUT_S) for c in cfgs]
    return out


# ---------------------------------------------------------------------------
# the references (JAX on Auto-axis meshes of the first fake devices)
# ---------------------------------------------------------------------------
def _flat(tree: dict, num_periods: int) -> dict:
    """A reference pytree by the port's parameter names (periods unstacked)."""
    out = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{name}.{k}" if name else k)
            return
        arr = np.asarray(node, np.float32)
        if name.startswith("layers."):
            for i in range(num_periods):
                out[f"layers.{i}.{name[len('layers.'):]}"] = arr[i]
        else:
            out[name] = arr

    walk(tree, "")
    return out


def _jax_mesh(shape, names):
    import jax
    from jax.sharding import AxisType

    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:math.prod(shape)])


def _jax_cfg(arch: str):
    from repro.configs.base import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def reference_weights(arch: str) -> dict:
    """The reference's f32 masters of a smoke config (its init), numpy."""
    import jax

    from repro.distributed.parallel import single_device_parallel
    from repro.models.api import build_model

    params = build_model(_jax_cfg(arch), single_device_parallel()).init(jax.random.key(3))
    return jax.tree.map(np.asarray, params)


def reference_run(cfg: train_run.TrainRunConfig, weights: dict, tokens: list) -> dict:
    """The reference's steps of ``cfg`` on an Auto-axis mesh: metrics per
    step, the parameters and first moments after the last (by the port's
    names)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed import sharding as jshd
    from repro.distributed.parallel import ParallelConfig
    from repro.models.api import build_model
    from repro.optim import adamw_init
    from repro.train import TrainStepConfig
    from repro.train.manual_dp import make_manual_dp_train_step
    from repro.train.step import make_train_step

    jcfg = _jax_cfg(cfg.arch)
    tcfg = TrainStepConfig(peak_lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                           total_steps=cfg.total_steps)
    names = train_run.AXES[cfg.kind]
    mesh = _jax_mesh(cfg.mesh, names)
    par = ParallelConfig(mesh=mesh, dp_axes=("data",),
                         tp_axis="model" if cfg.kind == "gspmd" else None,
                         microbatches=cfg.microbatches, grad_compression=cfg.grad_compression)
    bundle = build_model(jcfg, par)
    params = jax.tree.map(jnp.asarray, weights)
    if cfg.kind == "gspmd":
        pspecs = jshd.param_pspecs(bundle.param_shapes(), par)
        psh = jshd.to_named(mesh, pspecs)
        osh = jshd.to_named(mesh, {"step": P(), "m": pspecs, "v": pspecs})
        params = jax.device_put(params, psh)
        opt = jax.device_put(adamw_init(params, tcfg.adamw), osh)
        step = jax.jit(make_train_step(bundle, tcfg), out_shardings=(psh, osh, None))
    else:
        opt = adamw_init(params, tcfg.adamw)
        opt["ef_error"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.bfloat16), params)
        step = jax.jit(make_manual_dp_train_step(bundle, tcfg))
    metrics = []
    for toks in tokens[:cfg.steps]:
        params, opt, m = step(params, opt, {"tokens": jnp.asarray(toks)})
        metrics.append({k: float(v) for k, v in m.items()})
    n = jcfg.num_periods
    return {"metrics": metrics, "params": _flat(jax.tree.map(np.asarray, params), n),
            "m": _flat(jax.tree.map(np.asarray, opt["m"]), n)}


def reference_psum() -> dict:
    """The reference's ``compressed_psum_int8`` and exact mean at (4,) on its
    own draw (``tests/multidevice/run_train_checks.py``'s, at 4 devices)."""
    import jax
    import jax.numpy as jnp

    from repro.optim.compress import compressed_psum_int8
    from repro.utils.compat import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = _jax_mesh((4,), ("d",))
    x = np.random.default_rng(0).standard_normal((4, 1000)).astype(np.float32)

    def body(xl):
        flat = xl.reshape(-1)
        return compressed_psum_int8(flat, ("d",)), jax.lax.pmean(flat, ("d",))

    comp, exact = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("d"),), out_specs=(P(), P()),
                                    check_vma=False))(jnp.asarray(x))
    return {"x": x, "comp": np.asarray(comp), "exact": np.asarray(exact)}


@pytest.fixture(scope="module")
def inputs():
    return {"weights": {arch: reference_weights(arch) for arch in ARCHS},
            "tokens": _tokens(max(STEPS_GSPMD, STEPS_DP)), "psum": reference_psum()}


@pytest.fixture(scope="module")
def refs(inputs):
    """Each run's reference, computed on a thread while the ranks run."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {name: pool.submit(reference_run, _cfg(kw), inputs["weights"][_cfg(kw).arch],
                                 inputs["tokens"])
               for name, kw in WORLD4 + WORLD2 if name not in REFERENCE_OF}
    yield futures
    pool.shutdown(wait=True)


def _spawn(job, cases, world, inputs, tmp_path_factory, *extra):
    cfgs = [_cfg(kw) for _, kw in cases]
    t0 = time.perf_counter()
    ranks = lmesh.spawn(job, world, "gloo", "cpu",
                        args=(inputs["weights"], inputs["tokens"], cfgs, *extra),
                        timeout_s=TIMEOUT_S, store_dir=str(tmp_path_factory.mktemp(f"tr{world}")))
    return {"ranks": ranks, "cfgs": cfgs, "names": [n for n, _ in cases],
            "seconds": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def world4(refs, inputs, tmp_path_factory):
    return _spawn(world4_job, WORLD4, 4, inputs, tmp_path_factory, inputs["psum"]["x"])


@pytest.fixture(scope="module")
def world2(refs, inputs, tmp_path_factory):
    return _spawn(world2_job, WORLD2, 2, inputs, tmp_path_factory)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------
def _run(world, name):
    i = world["names"].index(name)
    return world["cfgs"][i], [r["runs"][i] for r in world["ranks"]]


def _check_gspmd(world, refs, name):
    cfg, ranks = _run(world, name)
    ref = refs[REFERENCE_OF.get(name, name)].result()
    for res in ranks:
        for got, want in zip(res["steps"], ref["metrics"]):
            m = got["metrics"]
            assert m["loss"] == pytest.approx(want["loss"], rel=1e-4)
            assert m["ce"] == pytest.approx(want["ce"], rel=1e-4)
            assert m["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-2)
            assert m["lr"] == pytest.approx(want["lr"], rel=1e-6)
        lr_sum = sum(w["lr"] for w in ref["metrics"])
        for leaf, block in res["blocks"].items():
            at = res["block_slices"][leaf]
            sl = tuple(slice(a, a + n) for a, n in zip(at, block.shape))
            want_m = ref["m"][leaf][sl]
            scale = float(np.abs(ref["m"][leaf]).max()) or 1.0
            assert np.abs(res["m"][leaf] - want_m).max() <= BF16_CEILING * scale, leaf
            assert np.abs(block - ref["params"][leaf][sl]).max() <= 2 * lr_sum, leaf


def _check_same_blocks(world, name):
    cfg, ranks = _run(world, name)
    for st in range(cfg.steps):
        seen = {}
        for res in ranks:
            for leaf, dig in res["steps"][st]["digests"].items():
                where = (leaf, tuple(res["block_slices"].get(leaf, ())))
                assert seen.setdefault(where, dig) == dig, (res["rank"], where)
        metrics = [res["steps"][st]["metrics"] for res in ranks]
        assert all(m == metrics[0] for m in metrics)


def _check_design(world, name):
    cfg, ranks = _run(world, name)
    mcfg = train_run.model_config(cfg)
    want = train_run.design_collectives(mcfg, cfg.mesh, cfg.kind, cfg.seq, cfg.batch,
                                        cfg.microbatches, grad_compression=cfg.grad_compression,
                                        seq_parallel=cfg.seq_parallel)
    for res in ranks:
        assert res["param_bytes"] == res["expected_param_bytes"]
        assert res["state_bytes"] == res["expected_state_bytes"]
        for st in res["steps"]:
            assert st["collectives"] == want, (res["rank"], st["step"])


W4G = [n for n, kw in WORLD4 if kw["kind"] == "gspmd"]
W4 = [n for n, _ in WORLD4]


@pytest.mark.parametrize("name", W4G)
def test_world4_gspmd_step_matches_reference(world4, refs, name):
    _check_gspmd(world4, refs, name)


def test_world2_gspmd_step_matches_reference(world2, refs):
    _check_gspmd(world2, refs, "gspmd-1x2")


@pytest.mark.parametrize("name", W4)
def test_world4_replicated_blocks_identical(world4, name):
    _check_same_blocks(world4, name)


@pytest.mark.parametrize("name", W4)
def test_world4_collectives_and_bytes_as_designed(world4, name):
    _check_design(world4, name)


def test_world2_collectives_and_bytes_as_designed(world2):
    _check_design(world2, "gspmd-1x2")
    _check_same_blocks(world2, "gspmd-1x2")


@pytest.mark.parametrize("name", ["dp-int8", "dp-f32"])
def test_manual_dp_matches_reference(world4, refs, name):
    cfg, ranks = _run(world4, name)
    ref = refs[name].result()
    lr_sum = sum(w["lr"] for w in ref["metrics"])
    for res in ranks:
        for got, want in zip(res["steps"], ref["metrics"]):
            assert got["metrics"]["loss"] == pytest.approx(want["loss"], rel=1e-4)
            assert got["metrics"]["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-3)
        close = total = 0
        for leaf, block in res["blocks"].items():
            d = np.abs(block - ref["params"][leaf])
            assert d.max() <= 2 * lr_sum, leaf
            close, total = close + int((d <= 1e-5).sum()), total + d.size
        if not cfg.grad_compression:
            assert close >= 0.99 * total, (close, total)


def test_manual_dp_int8_moves_one_byte_an_element(world4):
    cfg, ranks = _run(world4, "dp-int8")
    numels = [b.size for b in ranks[0]["blocks"].values()]
    want = train_run.int8_wire_bytes(numels, 4)
    for res in ranks:
        for st in res["steps"]:
            assert {k: st["bytes"][k] for k in want} == want


@pytest.mark.parametrize("axis", ["data", "model", "world"])
def test_collective_backwards_world4(world4, axis):
    for res in world4["ranks"]:
        for name, (fwd, bwd) in res["functions"][axis].items():
            assert fwd <= COLL_TOL and bwd <= COLL_TOL, (res["rank"], name, fwd, bwd)


def test_collective_backwards_world2(world2):
    for res in world2["ranks"]:
        for name, (fwd, bwd) in res["functions"]["world"].items():
            assert fwd <= COLL_TOL and bwd <= COLL_TOL, (res["rank"], name, fwd, bwd)


def test_compressed_psum_matches_reference(world4, inputs):
    ref = inputs["psum"]
    scale = float(np.abs(ref["exact"]).max())
    first = world4["ranks"][0]["psum"]
    for res in world4["ranks"]:
        got = res["psum"]
        assert np.array_equal(got["got"], first["got"])  # the same bits on every rank
        # one requantization step of the reduced chunk at most (a tie rounded the other way)
        assert np.abs(got["got"] - ref["comp"]).max() <= max(COLL_TOL * scale, scale / 127 + 1e-7)
        assert np.abs(got["got"] - ref["exact"]).max() / scale < 0.05
        assert got["calls"] == {"all_to_all": 1, "all_gather": 2}
        assert got["bytes"]["all_to_all"] == 1000  # one int8 byte an element
    diff = np.abs(first["got"] - ref["comp"])
    assert (diff > COLL_TOL * scale).mean() < 0.01


def test_optimizer_specs_and_clip_count_each_block_once(world4):
    for res in world4["ranks"]:
        got = res["specs"]
        assert got["shapes_ok"] and got["step_spec"] == ()
        assert got["specs"]["m"] == got["param_specs"] == got["specs"]["ef_error"]
        assert got["ef_dtype"] == "torch.bfloat16"
        # every gradient entry 1: the norm is sqrt of the whole model's size
        assert got["norm"] == pytest.approx(math.sqrt(got["whole"]), rel=1e-6)
        emb = got["param_specs"]["embed"]
        assert emb == ("model", None)  # vocab over tp, whole over dp


def test_fake_devices_cli_trains_over_four_ranks():
    from repro_torch.launch import train as train_cli

    out = train_cli.main(["--smoke", "--fake-devices", "4", "--steps", "3", "--batch", "4",
                          "--seq", "16", "--microbatches", "2", "--device", "cpu"])
    assert out["mesh"] == {"data": 2, "model": 2}  # make_smoke_mesh over 4 ranks
    assert out["final_step"] == 3 and len(out["history"]) == 3
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in out["history"])
