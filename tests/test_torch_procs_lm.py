"""Language-model serving over a mesh of gloo ranks, held against the JAX
package's sharded runs and the port's unsharded run.

* ``launch.lm_run.run_lm`` on every rank of a world of 4 — granite-20b
  smoke on (1, 4) (one kv head: a sequence-sharded cache), qwen3-4b smoke on
  (1, 4) (two kv heads: sequence-sharded) and (2, 2) (head-sharded, FSDP
  over ``data``), xlstm-1.3b smoke on (1, 4) and (2, 2) — and of a world of
  2 — qwen3-4b on (1, 2), granite-20b on (2, 1).  Each run serves 3
  requests through 2 slots (3 and 5 new tokens alternately, so the third
  request is admitted while the other slot decodes); the first prompt is 4
  (or 6) tokens long, divisible by tp, the others 7, so both the
  sequence-parallel and the all-reduce prefill run.
* Every rank's logits at every generated position equal the reference's
  sharded run on a mesh of the same shape (an Auto-axis mesh over the
  first fake devices; the same weights — the seeded draw each rank makes
  whole — carried across; the unsharded run's tokens fed back) within
  rtol/atol 1e-4 (the reference's own bound for its sequence-sharded
  decode), and the port's unsharded run within 2e-5 (measured ≤ 4e-6: the
  same f32 arithmetic summed in another order across ranks).  Every rank's
  tokens and logits are the same bits, and the tokens are the unsharded
  run's wherever its top-1 beats its top-2 by more than twice 2e-5.
* Every call's collectives equal ``lm_run.design_collectives``; every
  rank's parameter bytes equal ``shard_bytes_per_device``.
* The reference's numpy weights carried to a rank's blocks
  (``params_from_numpy(parallel=)``) equal the blocks its seeded draw keeps.
* ``ServeMesh`` (the rank's blocks of the whole weights, ``gather`` back to
  them, its slots) and ``shard_act``.
* ``make_smoke_mesh`` in the ranks, a mesh that does not fit the group,
  ``ShardedLoader(mesh=)`` (each rank's rows of the global batch; the
  distributed dedup over the group's table equal to the local mask) and a
  rank that leaves (its peer's next collective fails within the group's
  timeout).

One spawn a world size (``file://`` stores under ``tmp_path``); the rank
jobs import no JAX, and the references run on a thread meanwhile.  Everything in f32 at smoke size.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

from repro_torch.launch import lm_run  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

TIMEOUT_S = 60.0
DEAD_TIMEOUT_S = 5.0
REF_TOL = dict(rtol=1e-4, atol=1e-4)
PORT_TOL = 2e-5
BASE = dict(smoke=True, dtype="float32", requests=3, slots=2, cache_len=32, prompt_lens=(7, 7),
            max_new=(3, 5))
WORLD4 = (("granite_20b", (1, 4)), ("qwen3_4b", (1, 4)), ("qwen3_4b", (2, 2)),
          ("xlstm_1_3b", (1, 4)), ("xlstm_1_3b", (2, 2)))
WORLD2 = (("qwen3_4b", (1, 2)), ("granite_20b", (2, 1)))


def _cfg(arch, mesh) -> lm_run.LMRunConfig:
    return lm_run.LMRunConfig(arch=arch, mesh=mesh, first_multiple=mesh[1] if mesh[1] > 1 else 1,
                              **BASE)


def _loader(group) -> dict:
    """Two steps of the loader: whole, over the (2, 2) mesh, and with the
    distributed dedup over the group's table."""
    from repro_torch import DistributedHashTable
    from repro_torch.data import ShardedLoader, SyntheticCorpus

    corpus = SyntheticCorpus(vocab_size=64, seq_len=8, seed=3, dup_rate=0.3, device="cpu")
    mesh = lmesh.device_mesh((2, 2), lm_run.AXES)
    table = DistributedHashTable(group=group, hash_range=256, device="cpu")
    loaders = {
        "whole": ShardedLoader(corpus, 16),
        "mesh": ShardedLoader(corpus, 16, mesh=mesh),
        "local": ShardedLoader(corpus, 16, dedup="local"),
        "distributed": ShardedLoader(corpus, 16, mesh=mesh, dedup="distributed",
                                     dedup_table=table),
    }
    return {name: [ld.next_batch()["tokens"].numpy() for _ in range(2)]
            for name, ld in loaders.items()}


def _serve_mesh(group) -> dict:
    """``ServeMesh`` over (2, 2): its blocks of the whole draw are the
    rank's parameters, ``sharding.gather`` gives the whole tensors back,
    the step refuses another rank's caches; ``shard_act``'s block."""
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.serve import make_sharded_serve_step

    cfg = _cfg("qwen3_4b", (2, 2))
    mcfg, par = lm_run.model_config(cfg), lm_run.parallel_of(cfg)
    bundle = build_model(mcfg, par, device="cpu")
    params = dict(bundle.init(cfg.seed).named_parameters())
    whole = dict(transformer.init_params(mcfg, torch.Generator().manual_seed(cfg.seed),
                                         device="cpu").named_parameters())
    step, sm = make_sharded_serve_step(bundle, 2, 32)
    axes = (bundle.layout.dp, bundle.layout.tp)
    out = {
        "blocks": all(torch.equal(sm.block(w, sm.params[n]), params[n]) for n, w in whole.items()),
        "gathered": all(torch.equal(sharding.gather(params[n], sm.params[n], par, axes), whole[n])
                        for n in ("embed", "layers.0.b0.attn.wq", "layers.1.b0.mlp.w_down")),
        "slots": (bundle.init_cache(2, 32).slots, sm.slots),
        "act": tuple(par.shard_act(torch.zeros(2, 8, 3)).shape),
    }
    try:
        step(params, bundle.init_cache(4, 32), np.zeros((2, 1), np.int32), np.zeros(2, np.int32))
    except ValueError as e:
        out["refused"] = str(e)
    return out


def world4_job(group, cfgs) -> dict:
    from repro_torch.distributed.parallel import mesh_shape

    out = {"rank": group.rank, "runs": lm_run.rank_job(group, cfgs, "cpu", TIMEOUT_S)}
    out["serve_mesh"] = _serve_mesh(group)
    out["smoke_mesh"] = mesh_shape(lmesh.make_smoke_mesh())
    try:
        lmesh.device_mesh((2, 4), lm_run.AXES)
    except ValueError as e:
        out["misfit"] = str(e)
    out["loader"] = _loader(group)
    return out


def world2_job(group, cfgs) -> dict:
    from repro_torch.distributed import collectives
    from repro_torch.models import convert
    from repro_torch.models.api import build_model

    out = {"rank": group.rank, "runs": lm_run.rank_job(group, cfgs, "cpu", TIMEOUT_S)}
    cfg = cfgs[0]
    mcfg = lm_run.model_config(cfg)
    par = lm_run.parallel_of(cfg)
    blocks = convert.params_from_numpy(_whole_tree(cfg), mcfg, device="cpu", parallel=par)
    drawn = build_model(mcfg, par, device="cpu").init(cfg.seed)
    out["convert"] = [(name, tuple(a.shape), bool(torch.equal(a, b))) for (name, a), b
                      in zip(blocks.named_parameters(), drawn.parameters())]
    _, tp = collectives.bind(par, timeout_s=DEAD_TIMEOUT_S)
    if group.rank == 1:
        return out  # leaves the group: its process ends
    t0 = time.perf_counter()
    try:
        time.sleep(0.5)
        for _ in range(20):
            tp.all_reduce(torch.ones(4))
            time.sleep(0.1)
        out["dead"] = (None, time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001 - the outcome under test
        out["dead"] = (type(e).__name__, time.perf_counter() - t0 - 0.5)
    return out


def _whole_tree(cfg) -> dict:
    """The run's weights (the seeded draw every rank makes whole before it
    keeps its block) in the reference's layout, as numpy."""
    from repro_torch.models import convert, transformer

    model = transformer.init_params(lm_run.model_config(cfg),
                                    torch.Generator().manual_seed(cfg.seed), device="cpu")
    return convert.params_to_numpy(model)


def _spawn(job, cases, world, tmp_path_factory):
    cfgs = [_cfg(arch, mesh) for arch, mesh in cases]
    t0 = time.perf_counter()
    ranks = lmesh.spawn(job, world, "gloo", "cpu", args=(cfgs,), timeout_s=TIMEOUT_S,
                        store_dir=str(tmp_path_factory.mktemp(f"lm{world}")))
    return {"ranks": ranks, "cfgs": cfgs, "seconds": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def refs():
    """Each run's references, computed on a thread while the ranks run:
    ``{cfg: future of (the reference's sharded logits, the port's unsharded
    run)}``; the reference is fed the unsharded run's tokens."""
    import concurrent.futures

    def both(cfg):
        whole = lm_run.run_lm(cfg, sharded=False, device="cpu")
        return _reference_sharded(cfg, whole["tokens"]), whole

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    futures = {_cfg(a, m): pool.submit(both, _cfg(a, m)) for a, m in WORLD4 + WORLD2}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def world4(refs, tmp_path_factory):
    return _spawn(world4_job, WORLD4, 4, tmp_path_factory)


@pytest.fixture(scope="module")
def world2(refs, tmp_path_factory):
    return _spawn(world2_job, WORLD2, 2, tmp_path_factory)


def _reference_sharded(cfg, tokens) -> dict:
    """The reference's logits at each generated position of each request, on
    an Auto-axis mesh of ``cfg.mesh``: its sharded prefill (on its bf16
    serving copy, as ``make_prefill_step``) and decode steps fed ``tokens``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.base import get_smoke_config
    from repro.distributed import sharding as jshd
    from repro.launch.mesh import production_parallel
    from repro.models.api import build_model
    from repro.serve.engine import serving_compute_copy

    n = cfg.mesh[0] * cfg.mesh[1]
    mesh = jax.make_mesh(cfg.mesh, lm_run.AXES, axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
    par = production_parallel(mesh, moe_impl="dense")
    jcfg = dataclasses.replace(get_smoke_config(cfg.arch), dtype="float32", attention_impl="xla")
    bundle = build_model(jcfg, par)
    params = jax.device_put(_whole_tree(cfg), jshd.to_named(mesh, jshd.param_pspecs(bundle.param_shapes(),
                                                                         par)))
    cache_sh = jshd.to_named(mesh, jshd.cache_pspecs(
        jax.eval_shape(lambda: bundle.init_cache(1, cfg.cache_len)), par))
    prefill = jax.jit(lambda p, t: bundle.prefill(serving_compute_copy(p), {"tokens": t},
                                                  cache_len=cfg.cache_len))
    step = jax.jit(bundle.decode_step)
    out = {}
    for uid, prompt in enumerate(lm_run.draw_prompts(cfg, jcfg.vocab_size)):
        toks = tokens[uid]
        logits, caches = prefill(params, jnp.asarray(prompt[None]))
        caches = jax.device_put(caches, cache_sh)
        rows = [np.asarray(logits[0])]
        for j in range(len(toks) - 1):
            logits, caches = step(params, caches, jnp.asarray([[toks[j]]], jnp.int32),
                                  jnp.asarray([len(prompt) + j], jnp.int32))
            rows.append(np.asarray(logits[0]))
        out[uid] = np.stack(rows)
    return out


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
        assert len(toks) == world["cfgs"][i].max_new[uid % 2]


def _check_design(world, i):
    cfg = world["cfgs"][i]
    mcfg = lm_run.model_config(cfg)
    for rank in world["ranks"]:
        got = rank["runs"][i]
        assert got["param_bytes"] == got["shard_bytes"]
        for call in got["prefill"]:
            want = lm_run.design_collectives(mcfg, cfg.mesh, "prefill", call["len"], 1,
                                             cfg.cache_len)
            assert call["collectives"] == want, (rank["rank"], call)
        for call in got["decode"]:
            want = lm_run.design_collectives(mcfg, cfg.mesh, "decode", 1, cfg.slots,
                                             cfg.cache_len)
            assert call["collectives"] == want, (rank["rank"], call)
        paths = [c["path"] for c in got["prefill"]]
        if cfg.mesh[1] == 1:
            assert set(paths) == {"whole"}
        elif cfg.arch == "xlstm_1_3b":
            assert set(paths) == {"all-reduce"}  # recurrent stacks: no sequence parallelism
        else:
            assert paths == ["seq-parallel", "all-reduce", "all-reduce"]


W4 = [f"{a}-{m[0]}x{m[1]}" for a, m in WORLD4]
W2 = [f"{a}-{m[0]}x{m[1]}" for a, m in WORLD2]


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


def test_world4_kernel_launches_and_cache_layouts(world4):
    for rank in world4["ranks"]:
        for cfg, got in zip(world4["cfgs"], rank["runs"]):
            assert got["launches"] == {}  # the CPU runs every kernel's twin
            assert got["device"] == "cpu" and got["mesh"] == cfg.mesh


def test_serve_mesh_blocks_gather_and_slots(world4):
    for rank in world4["ranks"]:
        got, d = rank["serve_mesh"], rank["rank"] // 2
        assert got["blocks"] and got["gathered"]
        assert got["slots"] == ((d, d + 1), (d, d + 1))
        assert got["act"] == (1, 4, 3)  # batch over data, sequence over model
        assert "serves 2 slots" in got["refused"]


def test_smoke_mesh_and_misfit_in_the_ranks(world4):
    for rank in world4["ranks"]:
        assert rank["smoke_mesh"] == {"data": 2, "model": 2}
        assert "needs a group of 8 ranks" in rank["misfit"]


def test_loader_gives_each_rank_its_rows(world4):
    for rank in world4["ranks"]:
        got, r = rank["loader"], rank["rank"]
        d = r // 2  # (data, model) = (2, 2), row-major
        for step in range(2):
            whole = got["whole"][step]
            assert whole.shape == (16, 9)
            np.testing.assert_array_equal(got["mesh"][step], whole[8 * d:8 * d + 8])


def test_loader_distributed_dedup_equals_local(world4):
    for rank in world4["ranks"]:
        got, d = rank["loader"], rank["rank"] // 2
        for step in range(2):
            assert not np.array_equal(got["local"][step], got["whole"][step])  # rows re-drawn
            np.testing.assert_array_equal(got["distributed"][step],
                                          got["local"][step][8 * d:8 * d + 8])


def test_reference_weights_carried_to_each_ranks_blocks(world2):
    for rank in world2["ranks"]:
        conv = rank["convert"]
        assert conv and all(equal for _, _, equal in conv)
        assert dict((n, s) for n, s, _ in conv)["embed"] == (256, 128)  # vocab over tp 2


def test_rank_that_leaves_fails_its_peer_within_the_timeout(world2):
    err, secs = world2["ranks"][0]["dead"]
    assert err is not None and secs < DEAD_TIMEOUT_S + 5, (err, secs)
