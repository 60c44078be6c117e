"""Expert-parallel training through the exchange's backward, over gloo ranks.

* ``launch.train_run.run_train`` of mixtral smoke (E = 4 experts, top-2,
  f32) through the exchange (the train run's ``moe_impl="ep"``) on
  ``(data, model) = (4, 1)`` (one expert a
  rank, the smoke capacity factor 2.0) and ``(2, 1)`` (two a rank, capacity
  factor 1.0, so the slots drop rows), 2 steps on the reference's f32
  masters, one row a rank:
  - against the port's stacked EP step (``make_ep_stacked_train_step``,
    autograd through ``StackedGroup``): after step 1 each rank's first
    moments of its owned experts (``(1 - b1) · g``: the clip does not bind,
    ``clip_norm`` 1e9, so they are the gradients' bits) equal the stacked
    step's bit for bit, and every reduced leaf's are within 1e-6 of the
    leaf's largest entry (f32 gradients summed over the ranks in another
    order); every step's loss, ce and aux within 1e-6 relative;
  - against the reference's EP train step on an Auto-axis mesh of the same
    shape (``repro.train.step.make_train_step``, its ``moe_ep`` under
    ``shard_map``): every step's metrics within 2e-4 relative and the first
    moments after step 1 within 2e-4 of each leaf's largest entry; each
    leaf's moments sum to the reference's within 1e-3 relative (the ratio
    the reference's ``check_vma=False`` transpose would move by a whole
    factor: it is 1 for every leaf here);
  - each step's collectives equal ``train_run.design_collectives`` and its
    exchange rounds ``train_run.design_rounds`` (forward, backward and
    remat's recomputation: six a MoE layer);
  - parameter and state bytes ``shard_bytes_per_device`` of their specs.
* At capacity factor 4.0 over 4 ranks nothing drops, and EP is the dense
  MoE: step 1's ce within 1e-5 relative of the one-card dense step's (the
  aux differs by definition, EP's the mean of the ranks' own and the dense
  step's the whole batch's, as in the reference, so its gradient moves
  step 2's weights apart), and every rank's blocks after 2 steps within
  2 lr of its blocks (AdamW's early steps move a weight by about lr
  whatever its gradient's size).
* Where the dp ranks outnumber the experts, each expert's gradient is
  summed over the ranks that hold it (``train.step.reduce_whole_over_dp``)
  and counted once in the clip (``sharding.counts_block``).
* The exchange's ``torch.autograd.Function`` (``exchange.exchange_many``):
  ``moe.moe_ep`` of one layer over the ranks, its gradients w.r.t. the
  input rows, the router and the rank's experts against autograd through
  ``StackedGroup`` (1e-6: the same f32 arithmetic), plain and under
  ``torch.utils.checkpoint`` (the recomputation issues the rounds again:
  four in the forward and the recomputation, two in the backward).

One spawn a world size (``file://`` stores under ``tmp_path``); the
references run on a thread meanwhile.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch import train_run  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

TIMEOUT_S = 120.0
ARCH = "mixtral_8x22b"
SEQ, STEPS, LR = 32, 2, 1e-3
STACKED_TOL = 1e-6
REF_TOL = 2e-4
DENSE_TOL = 1e-5
FN_TOL = 1e-6
BASE = dict(arch=ARCH, smoke=True, dtype="float32", kind="gspmd", seq=SEQ, lr=LR,
            warmup_steps=1, total_steps=10, steps=STEPS, clip_norm=1e9)
RUNS = {  # name -> (world, capacity factor)
    "ep4": (4, None),
    "ep2": (2, 1.0),
    "ep4-nodrop": (4, 4.0),
}


def _cfg(name: str) -> train_run.TrainRunConfig:
    world, cf = RUNS[name]
    return train_run.TrainRunConfig(mesh=(world, 1), batch=world, capacity_factor=cf, **BASE)


def _tokens() -> list:
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, (4, SEQ + 1), dtype=np.int32) for _ in range(STEPS)]


def _moments_after_step1(i, params, opt, bundle):
    """``on_step``: the first moments after step 1 (by the whole model's names)."""
    if i != 0:
        return None
    return {n: opt["m"][n].detach().cpu().numpy().copy() for n, _ in params.named_parameters()}


def _run(name: str, weights, tokens, **kw) -> dict:
    cfg = _cfg(name)
    return train_run.run_train(cfg, device="cpu", weights=weights, batches=tokens[:STEPS],
                               keep_blocks=True, on_step=_moments_after_step1,
                               timeout_s=TIMEOUT_S, **kw)


# ---------------------------------------------------------------------------
# the rank jobs
# ---------------------------------------------------------------------------
def _exchange_grads(group, checkpointed: bool) -> dict:
    """One MoE layer through ``moe_ep`` over the ranks and over
    ``StackedGroup``: the output and the gradients of (output · upstream)
    w.r.t. the input rows, the router and the experts, and the rounds."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch import counting
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import exchange
    from repro_torch.models import moe, transformer

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    model = transformer.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    m = model.layers[0].b0.mlp.moe
    d, r = group.size, group.rank
    g = torch.Generator().manual_seed(9)
    x = torch.randn((d, 6, cfg.d_model), generator=g)
    up = torch.randn((d, 6, cfg.d_model), generator=g)

    def grads(xs, upstream, grp):
        xs = xs.clone().requires_grad_(True)
        leaves = [m.router, m.w_gate, m.w_up, m.w_down]
        for p in leaves:
            p.requires_grad_(True)
        fn = lambda t: moe.moe_ep(m, t, cfg, grp)[0]  # noqa: E731
        out = checkpoint(fn, xs, use_reentrant=False) if checkpointed else fn(xs)
        got = torch.autograd.grad((out * upstream).sum(), [xs] + leaves)
        for p in leaves:
            p.requires_grad_(False)
        return [out.detach().numpy()] + [t.numpy() for t in got]

    with counting.scoped() as scope:
        mine = grads(x[r:r + 1], up[r:r + 1], group)
    stacked = grads(x, up, exchange.StackedGroup(d))
    return {"mine": mine, "stacked": stacked, "rounds": dict(scope.rounds),
            "owned": moe.owned_experts(r, d, cfg.num_experts)}


def _repeated_expert_grads(group) -> dict:
    """``reduce_whole_over_dp`` over the 4 ranks with 2 experts dealt by
    owner (rank r holds expert r % 2: each expert twice) beside a leaf whole
    over dp: rank r's gradients are r + 1 and r."""
    from types import SimpleNamespace

    from repro_torch.distributed import collectives, sharding
    from repro_torch.train.step import reduce_whole_over_dp

    lay = SimpleNamespace(dp=collectives.world(), parallel=SimpleNamespace(dp_axes=("data",)),
                          specs={"expert": (sharding.Owners(("data",), 2), None),
                                 "whole": (None, None)})
    r = group.rank
    got = reduce_whole_over_dp(lay, {"expert": torch.full((1, 3), float(r + 1)),
                                     "whole": torch.full((2, 3), float(r))})
    return {n: t.numpy() for n, t in got.items()}


def world4_job(group, weights, tokens) -> dict:
    return {"rank": group.rank,
            "fn": {c: _exchange_grads(group, c) for c in (False, True)},
            "repeated": _repeated_expert_grads(group),
            "ep4": _run("ep4", weights, tokens),
            "ep4-nodrop": _run("ep4-nodrop", weights, tokens)}


def world2_job(group, weights, tokens) -> dict:
    return {"rank": group.rank, "ep2": _run("ep2", weights, tokens)}


# ---------------------------------------------------------------------------
# the references (the port's stacked and one-card steps; JAX on Auto-axis meshes)
# ---------------------------------------------------------------------------
def _jax_cfg(cf=None):
    from repro.configs.base import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    return cfg if cf is None else dataclasses.replace(cfg, moe_capacity_factor=cf)


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


def reference_weights() -> dict:
    import jax

    from repro.distributed.parallel import single_device_parallel
    from repro.models.api import build_model

    params = build_model(_jax_cfg(), single_device_parallel()).init(jax.random.key(3))
    return jax.tree.map(np.asarray, params)


def reference_run(name: str, weights: dict, tokens: list) -> dict:
    """The reference's EP steps of run ``name`` on an Auto-axis mesh: metrics
    per step, the first moments after step 1 (by the port's names)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.distributed import sharding as jshd
    from repro.distributed.parallel import ParallelConfig
    from repro.models.api import build_model
    from repro.optim import adamw_init
    from repro.train import TrainStepConfig
    from repro.train.step import make_train_step

    cfg = _cfg(name)
    world = cfg.mesh[0]
    mesh = jax.make_mesh(cfg.mesh, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:world])
    par = ParallelConfig(mesh=mesh, dp_axes=("data",), tp_axis="model", microbatches=1,
                         moe_impl="ep")
    jcfg = _jax_cfg(cfg.capacity_factor)
    bundle = build_model(jcfg, par)
    tcfg = TrainStepConfig(peak_lr=LR, warmup_steps=1, total_steps=10, clip_norm=cfg.clip_norm)
    pspecs = jshd.param_pspecs(bundle.param_shapes(), par)
    psh = jshd.to_named(mesh, pspecs)
    osh = jshd.to_named(mesh, {"step": P(), "m": pspecs, "v": pspecs})
    params = jax.device_put(jax.tree.map(jnp.asarray, weights), psh)
    opt = jax.device_put(adamw_init(params, tcfg.adamw), osh)
    step = jax.jit(make_train_step(bundle, tcfg), out_shardings=(psh, osh, None))
    metrics, m1 = [], None
    for toks in tokens[:STEPS]:
        params, opt, m = step(params, opt, {"tokens": jnp.asarray(toks)})
        metrics.append({k: float(v) for k, v in m.items()})
        if m1 is None:
            m1 = _flat(jax.tree.map(np.asarray, opt["m"]), jcfg.num_periods)
    return {"metrics": metrics, "m1": m1}


@pytest.fixture(scope="module")
def weights():
    return reference_weights()


@pytest.fixture(scope="module")
def tokens():
    return _tokens()


@pytest.fixture(scope="module")
def refs(weights, tokens):
    """The port's stacked and one-card steps and the reference's, computed
    on a thread while the ranks run."""
    import concurrent.futures

    def port(name, **kw):
        cfg = _cfg(name)
        return train_run.run_train(cfg, sharded=False, device="cpu", weights=weights,
                                   batches=tokens[:STEPS], keep_blocks=True,
                                   on_step=_moments_after_step1, **kw)

    def every():
        out = {"stacked": {n: port(n, stacked=RUNS[n][0]) for n in ("ep4", "ep2")},
               "dense": port("ep4-nodrop")}
        out["reference"] = {n: reference_run(n, weights, tokens) for n in ("ep4", "ep2")}
        return out

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(every)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def world4(refs, weights, tokens, tmp_path_factory):
    return lmesh.spawn(world4_job, 4, "gloo", "cpu", args=(weights, tokens), timeout_s=TIMEOUT_S,
                       store_dir=str(tmp_path_factory.mktemp("moetrain4")))


@pytest.fixture(scope="module")
def world2(refs, weights, tokens, tmp_path_factory):
    return lmesh.spawn(world2_job, 2, "gloo", "cpu", args=(weights, tokens), timeout_s=TIMEOUT_S,
                       store_dir=str(tmp_path_factory.mktemp("moetrain2")))


def _ranks(name, world4, world2) -> list:
    return [r[name] for r in (world2 if RUNS[name][0] == 2 else world4)]


def _rank_block(rank_run: dict, name: str, whole: np.ndarray) -> np.ndarray:
    """The rank's block of a whole leaf (its expert stacks: the experts it
    owns, ``r, r + D, ...``)."""
    starts = rank_run["block_slices"][name]
    shape = rank_run["blocks"][name].shape
    if ".moe.w_" in name:
        d = rank_run["mesh"][0]
        return whole[rank_run["rank"] % whole.shape[0]::d][:shape[0]]
    return whole[tuple(slice(a, a + n) for a, n in zip(starts, shape))]


def _step1_moments(run: dict) -> dict:
    return run["steps"][0]["check"]


# -- against the stacked EP step -------------------------------------------------------------


@pytest.mark.parametrize("name", ["ep4", "ep2"])
def test_owned_experts_bit_for_bit_and_reduced_leaves_the_stacked_steps(name, world4, world2,
                                                                        refs):
    want = _step1_moments(refs.result()["stacked"][name])
    for run in _ranks(name, world4, world2):
        got = _step1_moments(run)
        for leaf, m in got.items():
            w = _rank_block(run, leaf, want[leaf])
            if ".moe.w_" in leaf:
                np.testing.assert_array_equal(m, w, err_msg=f"rank {run['rank']} {leaf}")
            else:
                scale = max(float(np.abs(want[leaf]).max()), 1e-30)
                assert float(np.abs(m - w).max()) <= STACKED_TOL * scale, (run["rank"], leaf)


@pytest.mark.parametrize("name", ["ep4", "ep2"])
def test_ep_step_metrics_the_stacked_steps(name, world4, world2, refs):
    stacked = refs.result()["stacked"][name]
    for run in _ranks(name, world4, world2):
        for got, want in zip(run["steps"], stacked["steps"]):
            for k in ("loss", "ce", "moe_aux"):
                np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=STACKED_TOL)


# -- against the reference's EP step --------------------------------------------------------


@pytest.mark.parametrize("name", ["ep4", "ep2"])
def test_ep_step_matches_the_reference_and_no_leaf_is_scaled(name, world4, world2, refs):
    ref = refs.result()["reference"][name]
    stacked = _step1_moments(refs.result()["stacked"][name])
    for run in _ranks(name, world4, world2):
        for got, want in zip(run["steps"], ref["metrics"]):
            for k in ("loss", "ce", "moe_aux", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][k], want[k], rtol=REF_TOL, err_msg=k)
        for leaf, m in _step1_moments(run).items():
            w = _rank_block(run, leaf, ref["m1"][leaf])
            scale = max(float(np.abs(ref["m1"][leaf]).max()), 1e-30)
            assert float(np.abs(m - w).max()) <= REF_TOL * scale, (run["rank"], leaf)
    for leaf, want in ref["m1"].items():  # the whole leaves: no whole-factor scaling
        ratio = float(np.abs(stacked[leaf]).sum() / max(np.abs(want).sum(), 1e-30))
        assert abs(ratio - 1.0) < 1e-3, (leaf, ratio)


# -- the design ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_ep_step_collectives_rounds_and_bytes_as_designed(name, world4, world2):
    cfg = _cfg(name)
    mcfg = train_run.model_config(cfg)
    want = train_run.design_collectives(mcfg, cfg.mesh, "gspmd", SEQ, cfg.batch, 1)
    rounds = train_run.design_rounds(mcfg, cfg.mesh, 1)
    assert rounds == {"moe": 6 * mcfg.num_layers}
    for run in _ranks(name, world4, world2):
        assert run["param_bytes"] == run["expected_param_bytes"]
        assert run["state_bytes"] == run["expected_state_bytes"]
        for step in run["steps"]:
            assert step["collectives"] == want, (run["rank"], step["collectives"])
            assert step["rounds"] == rounds, (run["rank"], step["rounds"])


# -- EP is the dense MoE where nothing drops --------------------------------------------------


def test_ep_equals_the_dense_one_card_step_where_nothing_drops(world4, refs):
    dense = refs.result()["dense"]
    for run in _ranks("ep4-nodrop", world4, None):
        np.testing.assert_allclose(run["steps"][0]["metrics"]["ce"],
                                   dense["steps"][0]["metrics"]["ce"], rtol=DENSE_TOL)
        for leaf, block in run["blocks"].items():
            w = _rank_block(run, leaf, dense["blocks"][leaf])
            assert float(np.abs(block - w).max()) <= 2 * LR * STEPS, (run["rank"], leaf)


# -- the exchange's autograd Function ---------------------------------------------------------


@pytest.mark.parametrize("checkpointed", [False, True], ids=["plain", "checkpoint"])
def test_exchange_backward_matches_autograd_through_the_stacked_group(checkpointed, world4):
    for rank in world4:
        got = rank["fn"][checkpointed]
        r = rank["rank"]
        out, dx, drouter, dg, du, dd = got["mine"]
        s_out, s_dx, s_router, s_g, s_u, s_d = got["stacked"]
        np.testing.assert_allclose(out[0], s_out[r], rtol=FN_TOL, atol=FN_TOL)
        np.testing.assert_allclose(dx[0], s_dx[r], rtol=FN_TOL, atol=FN_TOL)
        for e in got["owned"]:  # the rank's experts: every row they ran came to it
            for mine, want in ((dg, s_g), (du, s_u), (dd, s_d)):
                np.testing.assert_allclose(mine[e], want[e], rtol=FN_TOL, atol=FN_TOL)
        assert np.isfinite(drouter).all()
        assert got["rounds"] == {"moe": 6 if checkpointed else 4}
    total = sum(rank["fn"][checkpointed]["mine"][2] for rank in world4)
    np.testing.assert_allclose(total, world4[0]["fn"][checkpointed]["stacked"][2],
                               rtol=FN_TOL, atol=FN_TOL)  # the router's parts sum to its whole


def test_ep_training_runs_without_the_removed_guard():
    """``moe_ep`` under autograd over the stacked group: the gradient reaches
    every input (the guard that raised here is gone)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import exchange
    from repro_torch.models import moe, transformer

    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    m = transformer.init_params(cfg, torch.Generator().manual_seed(2),
                                device="cpu").layers[0].b0.mlp.moe
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    out, aux, _ = moe.moe_ep(m, x, cfg, exchange.StackedGroup(2))
    (g,) = torch.autograd.grad(out.sum() + aux.sum(), [x])
    assert g.shape == x.shape and bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    assert math.isfinite(float(aux.detach().sum()))


def test_repeated_experts_sum_their_gradients_and_count_once(world4):
    """Where the dp ranks outnumber the experts (4 ranks, 2 experts: rank r
    holds expert r % 2), each expert's gradient is summed over the ranks that
    hold it, and the clip counts it on its first E ranks only."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.parallel import AbstractMesh

    for rank in world4:
        r = rank["rank"]
        np.testing.assert_array_equal(rank["repeated"]["expert"],
                                      np.full((1, 3), float((r % 2 + 1) + (r % 2 + 3))))
        np.testing.assert_array_equal(rank["repeated"]["whole"], np.full((2, 3), 6.0))
    mesh = AbstractMesh((4, 1), ("data", "model"))
    spec = (sharding.Owners(("data",), 2), None)
    assert [sharding.counts_block(spec, mesh, {"data": r, "model": 0}) for r in range(4)] == \
        [True, True, False, False]
