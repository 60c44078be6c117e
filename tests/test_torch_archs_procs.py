"""Griffin and the encoder-decoder over a mesh of gloo ranks, held against
the JAX package's sharded runs and the port's unsharded run.

* ``launch.lm_run.run_lm`` of recurrentgemma-9b smoke (3 layers: rglru,
  rglru, local; 4 q / 1 kv heads; ``rnn_width`` 128; window 32) through
  the batcher (3 requests of 36 and 40 tokens, so the local ring wraps in
  prefill, through 2 slots of 48), and of whisper-base smoke (2 + 2
  layers, 4 heads, 64 stub frames; 2 clips with 12-token prompts in one
  batched prefill, then 3 decode steps), over a world of 4 on
  ``(data, model) = (1, 4)`` and ``(2, 2)`` and over a world of 2 on
  ``(1, 2)``; and of whisper-base smoke with one kv head on ``(1, 4)`` and
  ``(1, 2)``, whose kv heads do not divide over tp while its 64 frames do:
  its cross caches split by frames (each rank attends over its block and
  the partial softmaxes combine by log-sum-exp over tp), its self caches by
  positions:
  - every rank's logits at every generated position within rtol/atol 1e-4
    of the reference's sharded run on an Auto-axis mesh of the same shape
    (the same weights carried over as numpy, the unsharded run's tokens
    fed back), and within 2e-5 of the port's unsharded run (the same f32
    arithmetic summed in another order across ranks; Griffin's recurrence
    carries the rounding of its gathered ``uf``);
  - every rank's tokens and logits the same bits, the tokens the unsharded
    run's wherever its top-1 beats its top-2 by more than twice 2e-5;
  - every call's collectives ``lm_run.design_collectives``, every rank's
    parameter bytes ``shard_bytes_per_device``.
* ``lm_run.run_loss`` of each on (2, 2) (whisper with its stub frames):
  every rank's loss within 1e-5 of the unsharded run's, collectives
  ``design_loss_collectives``.
* One GSPMD train step of each (``launch.train_run``: ZeRO-3 over ``data``,
  tensor parallelism over ``model``, the bf16 compute copy) on (2, 2) from
  the reference's f32 masters, against the reference's
  ``make_train_step`` on the same mesh: loss and ce within 1e-4 relative
  (the same bf16 weights, summed in another order), each rank's first
  moments within ``BF16_CEILING`` of each leaf's largest reference entry
  and its parameters within 2 lr (AdamW's first step moves a weight by
  about lr whatever its gradient's size), the reference's decay of its
  stacked layer vectors undone (``ROADMAP.md``, reference-side caveats:
  Griffin's ``lambda``, about -5, would move 5e-4 more); whisper's step
  takes the run's stub frames (``train_run.draw_frames``).

One spawn a world size (``file://`` stores under ``tmp_path``); the rank
jobs import no JAX, and the references run on a thread meanwhile.
Everything in f32 at smoke size.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

from repro_torch.launch import lm_run  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch import train_run  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

TIMEOUT_S = 120.0
REF_TOL = dict(rtol=1e-4, atol=1e-4)
PORT_TOL = 2e-5
BF16_CEILING = 5e-2
LR = 1e-3
GRIFFIN, WHISPER = "recurrentgemma_9b", "whisper_base"
SERVE = {
    GRIFFIN: dict(requests=3, slots=2, cache_len=48, prompt_lens=(36, 40), max_new=(3, 5)),
    WHISPER: dict(requests=2, slots=2, cache_len=24, prompt_lens=(12, 12), max_new=(4,)),
}
KV1 = {"num_kv_heads": 1}  # whisper smoke with one kv head: its cross caches split by frames
WORLD4 = ((GRIFFIN, (1, 4), {}), (WHISPER, (1, 4), {}), (GRIFFIN, (2, 2), {}),
          (WHISPER, (2, 2), {}), (WHISPER, (1, 4), KV1))
WORLD2 = ((GRIFFIN, (1, 2), {}), (WHISPER, (1, 2), {}), (WHISPER, (1, 2), KV1))
TRAIN_ARCHS = (GRIFFIN, WHISPER)
TRAIN = dict(smoke=True, dtype="float32", kind="gspmd", mesh=(2, 2), seq=16, batch=4, lr=LR,
             warmup_steps=1, total_steps=10, steps=1)
LOSS = (4, 16)  # the forward loss's global batch and sequence


def _cfg(arch, mesh, extra=None) -> lm_run.LMRunConfig:
    return lm_run.LMRunConfig(arch=arch, mesh=mesh, smoke=True, dtype="float32", **SERVE[arch],
                              **(extra or {}))


def _train_cfg(arch) -> train_run.TrainRunConfig:
    return train_run.TrainRunConfig(arch=arch, **TRAIN)


def _train_tokens() -> list:
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, (TRAIN["batch"], TRAIN["seq"] + 1), dtype=np.int32)]


# ---------------------------------------------------------------------------
# the rank jobs
# ---------------------------------------------------------------------------
def _loss_cfg(arch) -> lm_run.LMRunConfig:
    return lm_run.LMRunConfig(arch=arch, smoke=True, dtype="float32", mesh=(2, 2))


def world4_job(group, cfgs, weights, tokens) -> dict:
    out = {"rank": group.rank, "runs": lm_run.rank_job(group, cfgs, "cpu", TIMEOUT_S)}
    out["loss"] = {arch: lm_run.run_loss(_loss_cfg(arch), *LOSS, device="cpu",
                                         timeout_s=TIMEOUT_S) for arch in TRAIN_ARCHS}
    out["train"] = {arch: train_run.run_train(_train_cfg(arch), device="cpu",
                                              weights=weights[arch], batches=tokens,
                                              keep_blocks=True, timeout_s=TIMEOUT_S)
                    for arch in TRAIN_ARCHS}
    return out


def world2_job(group, cfgs) -> dict:
    return {"rank": group.rank, "runs": lm_run.rank_job(group, cfgs, "cpu", TIMEOUT_S)}


# ---------------------------------------------------------------------------
# the references (JAX on Auto-axis meshes of the first fake devices)
# ---------------------------------------------------------------------------
def _jax_mesh(shape, names):
    import jax
    from jax.sharding import AxisType

    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])


def _jax_cfg(arch, kv_heads=None):
    from repro.configs.base import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attention_impl="xla")
    return cfg if kv_heads is None else dataclasses.replace(cfg, num_kv_heads=kv_heads)


def _whole_tree(cfg) -> dict:
    """The run's weights (the seeded draw every rank makes whole) in the
    reference's layout, as numpy."""
    from repro_torch.models import convert, encdec, transformer

    mcfg = lm_run.model_config(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    init = encdec.init_params if mcfg.is_encoder_decoder else transformer.init_params
    return convert.params_to_numpy(init(mcfg, gen, device="cpu"))


def _serving_copy(params):
    """The reference's ``serving_compute_copy`` by its stated rule, matrices
    only: its code casts every f32 leaf of two or more dims, and a stacked
    layer vector (``layers``' leading period axis) has two, so it would
    round Griffin's ``lambda`` to bf16; the port keeps vectors f32."""
    import jax
    import jax.numpy as jnp

    def cast(path, p):
        stacked = any(getattr(k, "key", None) == "layers" for k in path)
        if p.dtype == jnp.float32 and p.ndim - int(stacked) >= 2:
            return p.astype(jnp.bfloat16)
        return p

    return jax.tree_util.tree_map_with_path(cast, params)


def _reference_sharded(cfg, tokens) -> dict:
    """The reference's logits at each generated position of each request on
    an Auto-axis mesh of ``cfg.mesh``, fed ``tokens``: Griffin through its
    prefill (on the bf16 serving copy, as ``make_prefill_step``:
    ``_serving_copy``) and decode
    steps a request at a time; whisper's clips in one batched prefill with
    their frames (``lm_run.draw_frames``), then decode steps."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import sharding as jshd
    from repro.launch.mesh import production_parallel
    from repro.models.api import build_model

    mesh = _jax_mesh(cfg.mesh, lm_run.AXES)
    par = production_parallel(mesh, moe_impl="dense")
    jcfg = _jax_cfg(cfg.arch, cfg.num_kv_heads)
    bundle = build_model(jcfg, par)
    params = jax.device_put(_whole_tree(cfg), jshd.to_named(
        mesh, jshd.param_pspecs(bundle.param_shapes(), par)))
    prompts = lm_run.draw_prompts(cfg, jcfg.vocab_size)
    step = jax.jit(bundle.decode_step)
    out = {}
    if jcfg.is_encoder_decoder:
        frames = jnp.asarray(lm_run.draw_frames(cfg, jcfg.frontend_len, jcfg.d_model))
        n = len(prompts[0])
        logits, caches = jax.jit(lambda p, t, f: bundle.prefill(
            p, {"tokens": t, "frames": f}, cache_len=cfg.cache_len))(
            params, jnp.asarray(np.stack(prompts)), frames)
        rows = [np.asarray(logits)]
        for j in range(cfg.max_new[0] - 1):
            tok = np.array([[tokens[i][j]] for i in range(cfg.requests)], np.int32)
            logits, caches = step(params, caches, jnp.asarray(tok),
                                  jnp.full((cfg.requests,), n + j, jnp.int32))
            rows.append(np.asarray(logits))
        every = np.stack(rows, 1)
        return {i: every[i] for i in range(cfg.requests)}
    prefill = jax.jit(lambda p, t: bundle.prefill(_serving_copy(p), {"tokens": t},
                                                  cache_len=cfg.cache_len))
    for uid, prompt in enumerate(prompts):
        toks = tokens[uid]
        logits, caches = prefill(params, jnp.asarray(prompt[None]))
        rows = [np.asarray(logits[0])]
        for j in range(len(toks) - 1):
            logits, caches = step(params, caches, jnp.asarray([[toks[j]]], jnp.int32),
                                  jnp.asarray([len(prompt) + j], jnp.int32))
            rows.append(np.asarray(logits[0]))
        out[uid] = np.stack(rows)
    return out


def reference_weights(arch: str) -> dict:
    """The reference's f32 masters of a smoke config (its init), numpy."""
    import jax

    from repro.distributed.parallel import single_device_parallel
    from repro.models.api import build_model

    cfg = dataclasses.replace(_jax_cfg(arch), attention_impl="xla")
    params = build_model(cfg, single_device_parallel()).init(jax.random.key(3))
    return jax.tree.map(np.asarray, params)


def _flat(tree: dict, groups: dict) -> dict:
    """A reference pytree by the port's parameter names (stacked groups
    unstacked: ``layers``, ``enc_layers``, ``dec_layers``)."""
    out = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{name}.{k}" if name else k)
            return
        arr = np.asarray(node, np.float32)
        group, _, rest = name.partition(".")
        if group in groups and rest:
            for i in range(groups[group]):
                out[f"{group}.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr

    walk(tree, "")
    return out


def reference_train(arch: str, weights: dict, tokens: list) -> dict:
    """The reference's GSPMD step on a (2, 2) Auto-axis mesh: its metrics,
    parameters and first moments after it (by the port's names)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed import sharding as jshd
    from repro.distributed.parallel import ParallelConfig
    from repro.models.api import build_model
    from repro.optim import adamw_init
    from repro.train import TrainStepConfig
    from repro.train.step import make_train_step
    from repro_torch.models import convert

    cfg = _train_cfg(arch)
    mesh = _jax_mesh(cfg.mesh, ("data", "model"))
    par = ParallelConfig(mesh=mesh, dp_axes=("data",), tp_axis="model", microbatches=1)
    jcfg = _jax_cfg(arch)
    bundle = build_model(jcfg, par)
    tcfg = TrainStepConfig(peak_lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                           total_steps=cfg.total_steps)
    pspecs = jshd.param_pspecs(bundle.param_shapes(), par)
    psh = jshd.to_named(mesh, pspecs)
    osh = jshd.to_named(mesh, {"step": P(), "m": pspecs, "v": pspecs})
    params = jax.device_put(jax.tree.map(jnp.asarray, weights), psh)
    opt = jax.device_put(adamw_init(params, tcfg.adamw), osh)
    step = jax.jit(make_train_step(bundle, tcfg), out_shardings=(psh, osh, None))
    batch = {"tokens": jnp.asarray(tokens[0])}
    frames = train_run.draw_frames(cfg, "cpu")[0]
    if frames is not None:
        batch["frames"] = jnp.asarray(frames.numpy())
    params, opt, m = step(params, opt, batch)
    groups = convert.stacked_groups(train_run.model_config(cfg))
    after = _flat(jax.tree.map(np.asarray, params), groups)
    before = _flat(weights, groups)
    for name, p in after.items():  # undo the decay its stacked layer vectors take
        if name.split(".")[0] in groups and p.ndim == 1:
            after[name] = p + float(m["lr"]) * tcfg.adamw.weight_decay * before[name]
    return {"metrics": {k: float(v) for k, v in m.items()}, "params": after,
            "m": _flat(jax.tree.map(np.asarray, opt["m"]), groups)}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    return {arch: reference_weights(arch) for arch in TRAIN_ARCHS}


@pytest.fixture(scope="module")
def refs(weights):
    """Each run's references, computed on a thread while the ranks run:
    ``{cfg: future of (the reference's sharded logits, the port's unsharded
    run)}`` and the reference's train steps."""
    import concurrent.futures

    def both(cfg):
        whole = lm_run.run_lm(cfg, sharded=False, device="cpu")
        return _reference_sharded(cfg, whole["tokens"]), whole

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {_cfg(*w): pool.submit(both, _cfg(*w)) for w in WORLD4 + WORLD2}
    futures["train"] = pool.submit(lambda: {a: reference_train(a, weights[a], _train_tokens())
                                            for a in TRAIN_ARCHS})
    futures["loss"] = pool.submit(lambda: {
        a: lm_run.run_loss(_loss_cfg(a), *LOSS, sharded=False, device="cpu") for a in TRAIN_ARCHS})
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def world4(refs, weights, tmp_path_factory):
    cfgs = [_cfg(*w) for w in WORLD4]
    ranks = lmesh.spawn(world4_job, 4, "gloo", "cpu",
                        args=(cfgs, weights, _train_tokens()), timeout_s=TIMEOUT_S,
                        store_dir=str(tmp_path_factory.mktemp("archs4")))
    return {"ranks": ranks, "cfgs": cfgs}


@pytest.fixture(scope="module")
def world2(refs, tmp_path_factory):
    cfgs = [_cfg(*w) for w in WORLD2]
    ranks = lmesh.spawn(world2_job, 2, "gloo", "cpu", args=(cfgs,), timeout_s=TIMEOUT_S,
                        store_dir=str(tmp_path_factory.mktemp("archs2")))
    return {"ranks": ranks, "cfgs": cfgs}


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
def _check_logits(world, refs, i):
    ref, whole = refs[world["cfgs"][i]].result()
    for rank in world["ranks"]:
        got = rank["runs"][i]
        for uid, want in ref.items():
            np.testing.assert_allclose(got["logits"][uid], want, err_msg=f"rank {rank['rank']}",
                                       **REF_TOL)
            np.testing.assert_allclose(got["logits"][uid], whole["logits"][uid], rtol=PORT_TOL,
                                       atol=PORT_TOL, err_msg=f"rank {rank['rank']} {uid}")


def _check_tokens(world, refs, i):
    _, whole = refs[world["cfgs"][i]].result()
    first = world["ranks"][0]["runs"][i]
    for rank in world["ranks"]:
        got = rank["runs"][i]
        assert got["tokens"] == first["tokens"]
        assert got["logit_digests"] == first["logit_digests"]
    for uid, toks in first["tokens"].items():
        top2 = np.sort(whole["logits"][uid], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * PORT_TOL
        assert np.array_equal(np.asarray(toks)[clear], np.asarray(whole["tokens"][uid])[clear])


def _check_design(world, i):
    cfg = world["cfgs"][i]
    mcfg = lm_run.model_config(cfg)
    rows = cfg.requests if mcfg.is_encoder_decoder else 1
    slots = cfg.requests if mcfg.is_encoder_decoder else cfg.slots
    for rank in world["ranks"]:
        got = rank["runs"][i]
        assert got["param_bytes"] == got["shard_bytes"]
        for call in got["prefill"]:
            want = lm_run.design_collectives(mcfg, cfg.mesh, "prefill", call["len"], rows,
                                             cfg.cache_len)
            assert call["collectives"] == want, (rank["rank"], call)
        for call in got["decode"]:
            want = lm_run.design_collectives(mcfg, cfg.mesh, "decode", 1, slots, cfg.cache_len)
            assert call["collectives"] == want, (rank["rank"], call)


def _ids(world) -> list:
    return [f"{a}-{m[0]}x{m[1]}" + ("-kv1" if x else "") for a, m, x in world]


W4, W2 = _ids(WORLD4), _ids(WORLD2)


@pytest.mark.parametrize("i", range(len(WORLD4)), ids=W4)
def test_world4_logits_equal_reference_and_unsharded(world4, refs, i):
    _check_logits(world4, refs, i)


@pytest.mark.parametrize("i", range(len(WORLD4)), ids=W4)
def test_world4_tokens_identical_on_every_rank(world4, refs, i):
    _check_tokens(world4, refs, i)


@pytest.mark.parametrize("i", range(len(WORLD4)), ids=W4)
def test_world4_collectives_and_bytes_as_designed(world4, i):
    _check_design(world4, i)


@pytest.mark.parametrize("i", range(len(WORLD2)), ids=W2)
def test_world2_logits_equal_reference_and_unsharded(world2, refs, i):
    _check_logits(world2, refs, i)


@pytest.mark.parametrize("i", range(len(WORLD2)), ids=W2)
def test_world2_tokens_identical_on_every_rank(world2, refs, i):
    _check_tokens(world2, refs, i)


@pytest.mark.parametrize("i", range(len(WORLD2)), ids=W2)
def test_world2_collectives_and_bytes_as_designed(world2, i):
    _check_design(world2, i)


def test_griffin_state_and_ring_blocks_over_tp():
    """On (1, 4) a rank's RG-LRU state is its width block and its local
    ring its span of slots (one kv head: split by sequence, ``kpos`` with
    its ``k``), as ``cache_pspecs`` says; whisper's caches split by heads."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.parallel import AbstractMesh
    from repro_torch.launch.mesh import production_parallel
    from repro_torch.models import encdec, transformer

    par = production_parallel(AbstractMesh((1, 4), lm_run.AXES))
    cfg = _cfg(GRIFFIN, (1, 4))
    mcfg = lm_run.model_config(cfg)
    shapes = {f"b{j}": transformer.block_cache_shapes(mcfg, bt, cfg.slots, cfg.cache_len)
              for j, bt in enumerate(mcfg.block_pattern)}
    specs = shd.cache_pspecs(shapes, par)
    assert specs["b0"] == specs["b1"] == ((None, None, "model"), (None, None, None, "model"))
    k, v, kpos = specs["b2"]
    assert k == v and k[2] is None and k[3] == "model" and kpos == (None, None, "model")
    whisper = lm_run.model_config(_cfg(WHISPER, (1, 4)))
    shapes = encdec.cache_shapes(whisper, 2, 24)
    for shape in (shapes["self"].k, shapes["cross_k"]):
        assert shd.cache_leaf_spec(shape, par)[2] == "model"
    # one kv head: the self cache splits by positions, the cross caches by frames
    shapes = encdec.cache_shapes(lm_run.model_config(_cfg(WHISPER, (1, 4), KV1)), 2, 24)
    for shape in (shapes["self"].k, shapes["cross_k"]):
        spec = shd.cache_leaf_spec(shape, par)
        assert spec[2] is None and spec[3] == "model"


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_gspmd_train_step_matches_the_reference(arch, world4, refs):
    ref = refs["train"].result()[arch]
    for rank in world4["ranks"]:
        got = rank["train"][arch]
        step = got["steps"][0]["metrics"]
        for k in ("loss", "ce"):
            np.testing.assert_allclose(step[k], ref["metrics"][k], rtol=1e-4, err_msg=k)
        assert got["param_bytes"] == got["expected_param_bytes"]
        assert got["state_bytes"] == got["expected_state_bytes"]
        for name, block in got["blocks"].items():
            starts = got["block_slices"][name]
            cut = tuple(slice(a, a + n) for a, n in zip(starts, block.shape))
            w = ref["params"][name][cut]
            assert float(np.abs(block - w).max()) <= 2 * LR, (rank["rank"], name)
            m = got["m"][name]
            scale = max(float(np.abs(ref["m"][name]).max()), 1e-30)
            assert float(np.abs(m - ref["m"][name][cut]).max()) <= BF16_CEILING * scale, name


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_loss_over_a_mesh_equals_the_unsharded_loss(arch, world4, refs):
    """``lm_run.run_loss`` on (2, 2) (whisper with its stub frames,
    ``draw_frames``): every rank's loss within 1e-5 of the unsharded run's,
    its collectives ``design_loss_collectives``, its bytes its specs'."""
    whole = refs["loss"].result()[arch]
    cfg = _loss_cfg(arch)
    want = lm_run.design_loss_collectives(lm_run.model_config(cfg), cfg.mesh, *LOSS)
    for rank in world4["ranks"]:
        got = rank["loss"][arch]
        np.testing.assert_allclose(got["metrics"]["loss"], whole["metrics"]["loss"], rtol=1e-5)
        assert got["collectives"] == want, (rank["rank"], got["collectives"])
        assert got["param_bytes"] == got["shard_bytes"]
