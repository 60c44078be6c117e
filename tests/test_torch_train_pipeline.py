"""The GPipe pipeline, elastic checkpoints and the trainer over a mesh of
gloo ranks, held against the JAX package on the CPU.

* The pipeline (``train.pipeline``) at 2 and 4 stages on the smoke qwen3-4b
  in f32 (4 layers, batch 8 of 17 tokens, 4 microbatches; the reference's
  own check, ``tests/multidevice/run_train_checks.py``), on the
  reference's numpy masters: the loss against the reference's pipeline on
  an Auto-axis mesh and against its single-device loss within 1e-5
  relative; every gradient against the single-device gradient within 1e-5
  of its leaf's largest entry (f32, summed in another order), and the
  grad norm against the single-device norm within 1e-5 relative.  The
  reference's pipeline returns that norm times about the stage count (its
  ``psum`` of the loss transposes into a second sum over stages, and its
  norm is each stage's local one): the port deliberately does not, and
  the test records the reference's ratio.  Every stage ends with the same
  metrics, and a step's collectives are ``design_collectives``.
* Elastic restore (the reference's ``elastic_restore_across_meshes``, at
  4 ranks): the parameters saved over a (4,) mesh of ``data`` (FSDP blocks)
  restore onto a (2, 2) mesh of ``(data, model)``, every rank exactly its
  block of the (2, 2) layout, bit for bit.
* The trainer over (2, 2): a straight run of 6 steps, and a run with a
  checkpoint every 3 steps that crashes before step 4 and resumes in a new
  trainer from step 3: the same losses and parameter blocks bit for bit on
  every rank; every rank counts the same stragglers (the slowest rank's
  wall).

One spawn a world size (4 and 2); the references run on a thread meanwhile.
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
SEQ, BATCH, MICRO = 16, 8, 4
PP_TOL = 1e-5
RESUME = {"steps": 6, "every": 3, "crash": 4}


def _pp_cfg(stages: int) -> train_run.TrainRunConfig:
    return train_run.TrainRunConfig(arch="qwen3_4b", smoke=True, dtype="float32",
                                    kind="pipeline", mesh=(stages,), seq=SEQ, batch=BATCH,
                                    microbatches=MICRO, steps=1, lr=1e-3, warmup_steps=1,
                                    total_steps=10)


def _tokens() -> np.ndarray:
    return np.random.default_rng(2).integers(0, 512, (BATCH, SEQ + 1), dtype=np.int32)


# ---------------------------------------------------------------------------
# the rank jobs
# ---------------------------------------------------------------------------
def _pipeline(weights, tokens, stages: int) -> dict:
    """The pipelined loss and gradients (by the whole model's names) and one
    step's metrics and collectives."""
    from repro_torch.models.api import build_model
    from repro_torch.train import pipeline

    cfg = _pp_cfg(stages)
    bundle = build_model(train_run.model_config(cfg), train_run.parallel_of(cfg), device="cpu")
    vg = pipeline.make_pp_value_and_grad(bundle, num_microbatches=MICRO)
    stage = vg.axis.index
    rename = {}
    for n in pipeline.stage_periods(bundle.cfg, stages, stage):
        rename[f"layers.{n - stage * (bundle.cfg.num_periods // stages)}."] = f"layers.{n}."

    def whole_name(n):
        for local, glob in rename.items():
            if n.startswith(local):
                return glob + n[len(local):]
        return n

    from repro_torch.models import convert, transformer

    whole = transformer.trainable_params(convert.params_from_numpy(
        weights, bundle.cfg, device="cpu", dtype=torch.float32))
    params = pipeline.stage_params(whole, stages, stage)
    loss, grads = vg(params, torch.from_numpy(tokens))
    run = train_run.run_train(cfg, device="cpu", weights=weights, batches=[tokens],
                              timeout_s=TIMEOUT_S)
    return {"stage": stage, "loss": float(loss),
            "grads": {whole_name(n): g.numpy() for n, g in grads.items()},
            "run": run}


def _elastic(group, directory: str) -> dict:
    """Save the (4,) layout's blocks, restore them onto (2, 2)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import collectives, sharding
    from repro_torch.distributed.parallel import ParallelConfig
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(train_run.model_config(_pp_cfg(4)), num_layers=2)
    par_a = ParallelConfig(mesh=lmesh.device_mesh((4,), ("data",)), dp_axes=("data",),
                           tp_axis=None)
    bundle_a = build_model(cfg, par_a, device="cpu")
    params_a = bundle_a.init_train(7)
    m = CheckpointManager(directory, async_write=False)
    spec_a = sharding.TreeSharding(sharding.flat_pspecs({"params": bundle_a.layout.specs}),
                                   bundle_a.layout)
    m.save(1, {"params": params_a}, sharding=spec_a)
    m.wait()
    par_b = ParallelConfig(mesh=lmesh.device_mesh((2, 2), ("data", "model")))
    bundle_b = build_model(cfg, par_b, device="cpu")
    want = dict(bundle_b.init_train(7).named_parameters())
    like = bundle_b.init_train(0)
    spec_b = sharding.TreeSharding(sharding.flat_pspecs({"params": bundle_b.layout.specs}),
                                   bundle_b.layout)
    step, tree, _ = m.restore({"params": like}, sharding=spec_b)
    got = dict(tree["params"].named_parameters())
    return {"step": step, "equal": {n: bool(torch.equal(got[n], want[n])) for n in want},
            "shapes": {n: tuple(got[n].shape) for n in got},
            "spec_embed": bundle_b.layout.specs["embed"],
            "spec_a_embed": bundle_a.layout.specs["embed"],
            "writer": spec_a.writer}


def _resume(group, directory: str) -> dict:
    """The trainer over (2, 2): straight, then crashed at step 4 and resumed."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import ShardedLoader, SyntheticCorpus
    from repro_torch.distributed.parallel import ParallelConfig
    from repro_torch.models.api import build_model
    from repro_torch.train import SimulatedFailure, Trainer, TrainerConfig, TrainStepConfig

    cfg = dataclasses.replace(get_smoke_config("qwen3_4b"), num_layers=2)
    par = ParallelConfig(mesh=lmesh.device_mesh((2, 2), ("data", "model")), microbatches=2)
    tcfg = TrainStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=RESUME["steps"])

    def trainer(directory=None, crash=None):
        corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=16, seed=4, device="cpu")
        return Trainer(build_model(cfg, par, device="cpu"), ShardedLoader(corpus, 4), tcfg,
                       TrainerConfig(total_steps=RESUME["steps"], log_every=1, seed=4,
                                     checkpoint_every=RESUME["every"] if directory else 0,
                                     checkpoint_dir=directory, crash_at_step=crash),
                       log_fn=lambda m: None)

    a = trainer()
    hist_a = a.run()["history"]
    try:
        trainer(directory, crash=RESUME["crash"]).run()
        crashed = False
    except SimulatedFailure:
        crashed = True
    b = trainer(directory)
    resumed_at = b.step
    out_b = b.run()
    same = all(torch.equal(x, y) for x, y in zip(a.params.parameters(), b.params.parameters()))
    return {"crashed": crashed, "resumed_at": resumed_at, "loss_a": hist_a[-1]["loss"],
            "loss_b": out_b["history"][-1]["loss"], "weights_equal": same,
            "stragglers": (a.straggler_steps, b.straggler_steps),
            "steps_b": [h["step"] for h in out_b["history"]]}


def world4_job(group, weights, tokens, dirs) -> dict:
    return {"rank": group.rank, "pipeline": _pipeline(weights, tokens, 4),
            "elastic": _elastic(group, dirs["elastic"]), "resume": _resume(group, dirs["resume"])}


def world2_job(group, weights, tokens, dirs) -> dict:
    return {"rank": group.rank, "pipeline": _pipeline(weights, tokens, 2)}


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------
def _flat(tree: dict, num_periods: int) -> dict:
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


def _jax_cfg():
    from repro.configs.base import get_smoke_config

    return dataclasses.replace(get_smoke_config("qwen3_4b"), num_layers=4, dtype="float32")


def reference_inputs() -> dict:
    """The reference's masters (its init), the batch, its single-device loss
    and gradients."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.parallel import single_device_parallel
    from repro.models.api import build_model

    bundle = build_model(_jax_cfg(), single_device_parallel())
    params = bundle.init(jax.random.key(9))
    tokens = _tokens()
    (loss, _), grads = jax.jit(jax.value_and_grad(bundle.loss, has_aux=True))(
        params, {"tokens": jnp.asarray(tokens)})
    flat = _flat(jax.tree.map(np.asarray, grads), _jax_cfg().num_periods)
    norm = math.sqrt(sum(float(np.square(g.astype(np.float64)).sum()) for g in flat.values()))
    return {"weights": jax.tree.map(np.asarray, params), "tokens": tokens, "loss": float(loss),
            "grads": flat, "norm": norm}


def reference_pipeline(weights, tokens, stages: int) -> dict:
    """The reference's pipeline step on an Auto-axis (stages,) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.distributed.parallel import ParallelConfig
    from repro.models.api import build_model
    from repro.optim import adamw_init
    from repro.train import TrainStepConfig
    from repro.train.pipeline import make_pp_train_step

    mesh = jax.make_mesh((stages,), ("stage",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:stages])
    bundle = build_model(_jax_cfg(), ParallelConfig(mesh=mesh, dp_axes=(), tp_axis=None))
    tcfg = TrainStepConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    params = jax.tree.map(jnp.asarray, weights)
    step = jax.jit(make_pp_train_step(bundle, tcfg, num_microbatches=MICRO))
    _, _, m = step(params, adamw_init(params, tcfg.adamw), {"tokens": jnp.asarray(tokens)})
    return {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def inputs():
    return reference_inputs()


@pytest.fixture(scope="module")
def refs(inputs):
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {s: pool.submit(reference_pipeline, inputs["weights"], inputs["tokens"], s)
               for s in (2, 4)}
    yield futures
    pool.shutdown(wait=True)


def _spawn(job, world, inputs, tmp_path_factory):
    dirs = {k: str(tmp_path_factory.mktemp(f"{k}{world}")) for k in ("elastic", "resume")}
    t0 = time.perf_counter()
    ranks = lmesh.spawn(job, world, "gloo", "cpu",
                        args=(inputs["weights"], inputs["tokens"], dirs), timeout_s=TIMEOUT_S,
                        store_dir=str(tmp_path_factory.mktemp(f"pp{world}")))
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def world4(refs, inputs, tmp_path_factory):
    return _spawn(world4_job, 4, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def world2(refs, inputs, tmp_path_factory):
    return _spawn(world2_job, 2, inputs, tmp_path_factory)


def _check_pipeline(world, inputs, refs, stages):
    ref_pp = refs[stages].result()
    seen = {}
    for res in world["ranks"]:
        pp = res["pipeline"]
        assert pp["loss"] == pytest.approx(inputs["loss"], rel=PP_TOL)
        assert pp["loss"] == pytest.approx(ref_pp["loss"], rel=PP_TOL)
        for name, g in pp["grads"].items():
            want = inputs["grads"][name]
            scale = float(np.abs(want).max()) or 1.0
            assert np.abs(g - want).max() <= PP_TOL * scale, (stages, name)
            seen[name] = True
        m = pp["run"]["steps"][0]["metrics"]
        assert m["loss"] == pytest.approx(inputs["loss"], rel=PP_TOL)
        assert m["grad_norm"] == pytest.approx(inputs["norm"], rel=PP_TOL)
        assert m == world["ranks"][0]["pipeline"]["run"]["steps"][0]["metrics"]
    assert set(seen) == set(inputs["grads"])  # every leaf on some stage
    # the reference's norm: about the stage count times the single-device one
    ratio = ref_pp["grad_norm"] / inputs["norm"]
    assert 1.5 < ratio <= stages + 0.5, ratio


def test_pipeline_four_stages_matches_single_device(world4, inputs, refs):
    _check_pipeline(world4, inputs, refs, 4)


def test_pipeline_two_stages_matches_single_device(world2, inputs, refs):
    _check_pipeline(world2, inputs, refs, 2)


@pytest.mark.parametrize("world_name", ["world2", "world4"])
def test_pipeline_collectives_and_bytes_as_designed(world_name, request):
    world = request.getfixturevalue(world_name)
    stages = len(world["ranks"])
    cfg = _pp_cfg(stages)
    want = train_run.design_collectives(train_run.model_config(cfg), cfg.mesh, "pipeline",
                                        SEQ, BATCH, MICRO)
    assert want == {"ppermute": 2 * (MICRO + stages - 2), "all_reduce": 3}
    for res in world["ranks"]:
        run = res["pipeline"]["run"]
        assert run["steps"][0]["collectives"] == want
        assert run["param_bytes"] == run["expected_param_bytes"]
        assert run["state_bytes"] == run["expected_state_bytes"]
        # one f32 activation of a microbatch each hop, forward and backward
        assert run["steps"][0]["bytes"]["ppermute"] == want["ppermute"] * (BATCH // MICRO) * \
            SEQ * train_run.model_config(cfg).d_model * 4


def test_elastic_restore_across_meshes(world4):
    for res in world4["ranks"]:
        got = res["elastic"]
        assert got["step"] == 1
        assert all(got["equal"].values()), [n for n, ok in got["equal"].items() if not ok]
        assert got["spec_embed"] == ("model", None)  # vocab over tp on (2, 2)
        assert got["spec_a_embed"] == (None, None)  # whole on (4,) (the embedding's rule)
        assert got["writer"] == (res["rank"] == 0)
    shapes = [r["elastic"]["shapes"] for r in world4["ranks"]]
    assert shapes[0]["embed"] == (256, 128)  # half the vocab a rank


def test_trainer_over_ranks_resumes_bit_for_bit(world4):
    for res in world4["ranks"]:
        got = res["resume"]
        assert got["crashed"] and got["resumed_at"] == RESUME["every"]
        assert got["steps_b"] == list(range(RESUME["every"] + 1, RESUME["steps"] + 1))
        assert got["loss_b"] == got["loss_a"] and got["weights_equal"]
    stragglers = {tuple(r["resume"]["stragglers"]) for r in world4["ranks"]}
    assert len(stragglers) == 1  # agreed over the group
