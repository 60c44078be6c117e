"""The MoE across gloo ranks: expert parallelism through the exchange over a
``torch.distributed`` group, held against the JAX package's ``moe_ep`` on
Auto-axis meshes of the same size and against the port's stacked run; and
mixtral's loss and serving over (data, model) meshes.

* ``moe.moe_ep`` of one MoE layer (mixtral smoke, 4 experts, f32) over a
  world of 4 (one expert a rank) and of 2 (two a rank; capacity factor 1.0,
  so the slots drop rows): each rank's output rows equal its row of the
  ``StackedGroup`` run bit for bit, its aux that shard's, the drops equal;
  against the reference's ``moe_ep`` (drops from its ``_ep_body`` under this
  test's ``shard_map``) within rtol/atol 2e-4 (f32 summed in another order)
  and its ``pmean`` aux within 1e-6.  Two exchange rounds, under the MoE's
  label.
* ``lm_run.run_loss``: mixtral smoke's forward loss with ``moe_impl="ep"``
  on (4, 1) (one row a rank): every rank's row CE, its loss, the aux and
  the drops bit for bit the stacked twin's (``transformer.loss_ep_stacked``);
  with dense MoE over tp on (2, 2): the loss within 1e-5 of the reference's
  on a (2, 2) Auto-axis mesh and of the port's unsharded loss; each rank
  holds the experts it owns (EP) or its tp block of every expert (dense),
  its parameter bytes ``shard_bytes_per_device``, the collectives
  ``design_loss_collectives``.
* ``lm_run.run_lm``: mixtral smoke served on (1, 4) (2 kv heads over 4:
  a sequence-split ring, ``kpos`` split along its slots with ``k``) and on
  (2, 2) (head-split rings, ``kpos`` whole over tp; EP in decode, the
  owners' sum over dp in the one-row prefill): logits within 2e-5 of the
  unsharded run, collectives as ``design_collectives``.

One spawn of four ranks (``file://`` stores under ``tmp_path``); the world
of 2 is a group over its first two ranks.  The weights are the port's
seeded draw, carried to the reference as numpy; the references run on a
thread meanwhile.  Everything in f32 at smoke size.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

from repro_torch.launch import lm_run  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

TIMEOUT_S = 60.0
REF_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PORT_TOL = 2e-5
ARCH = "mixtral_8x22b"
LAYER = 2
ROWS, SEQ = 8, 12  # the EP layer's global input (B, S, d)
LOSS = (4, 32)  # the loss runs' global batch and sequence
SERVE = dict(smoke=True, dtype="float32", requests=3, slots=2, cache_len=48,
             prompt_lens=(36, 36), max_new=(3, 5))
SERVE_MESHES = ((1, 4), (2, 2))


def _cfg(world: int, reference: bool = False):
    """mixtral smoke in f32 (the reference's config with ``reference``); a
    capacity factor of 1.0 at world 2."""
    if reference:
        from repro.configs.base import get_smoke_config
    else:
        from repro_torch.configs.base import get_smoke_config
    changes = {"moe_capacity_factor": 1.0} if world == 2 else {}
    if reference:
        changes["attention_impl"] = "xla"
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **changes)


def _smoke_model():
    return lm_run.model_config(lm_run.LMRunConfig(arch=ARCH, smoke=True))


def _tree() -> dict:
    """f32 weights of mixtral smoke in the reference's layout (numpy)."""
    from repro_torch.models import convert, transformer

    model = transformer.init_params(_cfg(4), torch.Generator().manual_seed(11), device="cpu")
    return convert.params_to_numpy(model)


def _layer_input(world: int) -> np.ndarray:
    return np.random.default_rng(world).standard_normal(
        (ROWS, SEQ, _cfg(world).d_model)).astype(np.float32)


def _port_layer(tree: dict, cfg):
    from repro_torch.models import convert

    return convert.params_from_numpy(tree, cfg, device="cpu").layers[LAYER].b0.mlp.moe


def _ep_layer(group, tree: dict, world: int) -> dict:
    """This rank's rows of the EP layer over ``group`` (an
    ``exchange.ProcessGroup`` of ``world`` ranks), and the stacked run."""
    from repro_torch import counting
    from repro_torch.models import moe

    cfg = _cfg(world)
    m = _port_layer(tree, cfg)
    x = torch.from_numpy(_layer_input(world)).reshape(world, -1, cfg.d_model)
    with counting.scoped() as scope:
        out, aux, dropped = moe.moe_ep(m, x[group.rank:group.rank + 1], cfg, group)
    stacked = moe.moe_ep(m, x, cfg)
    return {"out": out.numpy(), "aux": aux.numpy(), "dropped": dropped.numpy(),
            "rounds": dict(scope.rounds), "stacked": [t.numpy() for t in stacked]}


def world4_job(group, tree) -> dict:
    import torch.distributed as dist

    from repro_torch.core import exchange

    ep = lm_run.LMRunConfig(arch=ARCH, smoke=True, dtype="float32", mesh=(4, 1), moe_impl="ep")
    dense = dataclasses.replace(ep, mesh=(2, 2), moe_impl="dense")
    pair = dist.new_group([0, 1])  # every rank creates it; the first two use it
    out = {"rank": group.rank, "layer": {4: _ep_layer(group, tree, 4)},
           "loss_ep": lm_run.run_loss(ep, *LOSS, device="cpu", timeout_s=TIMEOUT_S),
           "loss_dense": lm_run.run_loss(dense, *LOSS, device="cpu", timeout_s=TIMEOUT_S)}
    if group.rank < 2:
        out["layer"][2] = _ep_layer(exchange.ProcessGroup(pair), tree, 2)
    out["serve"] = lm_run.rank_job(group, [_serve_cfg(m) for m in SERVE_MESHES], "cpu", TIMEOUT_S)
    return out


def _serve_cfg(mesh) -> lm_run.LMRunConfig:
    return lm_run.LMRunConfig(arch=ARCH, mesh=mesh, first_multiple=mesh[1], **SERVE)


def _reference_layer(tree: dict, world: int) -> tuple:
    """The reference's ``moe_ep`` of the layer on an Auto-axis mesh of
    ``world`` fake devices: (out, pmean aux, drops)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as P

    from repro.distributed.parallel import ParallelConfig
    from repro.models import moe as jmoe
    from repro.utils.compat import shard_map
    from repro_torch.models import moe

    cfg, jcfg = _cfg(world), _cfg(world, reference=True)
    jm = jax.tree.map(lambda a: jnp.asarray(a[LAYER]), tree["layers"]["b0"]["mlp"]["moe"])
    mesh = jax.make_mesh((world,), ("data",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:world])
    par = ParallelConfig(mesh=mesh, dp_axes=("data",), tp_axis=None, moe_impl="ep")
    x = jnp.asarray(_layer_input(world))
    out, aux = jax.jit(lambda p, xx: jmoe.moe_ep(p, xx, jcfg, par))(jm, x)
    cap = moe.ep_capacity(ROWS * SEQ // world, cfg)

    def body(p, xl):
        return jmoe._ep_body(p, xl.reshape(-1, cfg.d_model), jcfg, ("data",), cap)[2]

    dropped = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("data")), out_specs=P(),
                                axis_names={"data"}, check_vma=False))(jm, x)
    return np.asarray(out), float(aux), int(dropped)


def _reference_loss() -> float:
    """The reference's loss of the loss runs' batch with dense MoE on a
    (2, 2) Auto-axis mesh, on the port's seeded weights."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.base import get_smoke_config
    from repro.distributed import sharding as jshd
    from repro.launch.mesh import production_parallel
    from repro.models.api import build_model
    from repro_torch.models import convert, transformer

    cfg = lm_run.LMRunConfig(arch=ARCH, smoke=True, dtype="float32", mesh=(2, 2))
    mcfg = lm_run.model_config(cfg)
    mesh = jax.make_mesh((2, 2), lm_run.AXES, axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    par = production_parallel(mesh, moe_impl="dense")
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", attention_impl="xla")
    bundle = build_model(jcfg, par)
    whole = convert.params_to_numpy(transformer.init_params(
        mcfg, torch.Generator().manual_seed(cfg.seed), device="cpu"))
    params = jax.device_put(whole, jshd.to_named(mesh, jshd.param_pspecs(bundle.param_shapes(),
                                                                         par)))
    tokens = lm_run.draw_loss_tokens(cfg, mcfg.vocab_size, *LOSS)
    loss, _ = jax.jit(bundle.loss)(params, {"tokens": jnp.asarray(tokens)})
    return float(loss)


@pytest.fixture(scope="module")
def refs(tree):
    """The references, computed on a thread while the ranks run."""
    import concurrent.futures

    def both():
        ep = lm_run.LMRunConfig(arch=ARCH, smoke=True, dtype="float32", mesh=(4, 1),
                                moe_impl="ep")
        return {
            "layer": {w: _reference_layer(tree, w) for w in (4, 2)},
            "loss": _reference_loss(),
            "stacked": lm_run.run_loss(ep, *LOSS, sharded=False, stacked=4, device="cpu"),
            "whole": lm_run.run_loss(ep, *LOSS, sharded=False, device="cpu"),
            "serve": lm_run.run_lm(_serve_cfg((1, 1)), sharded=False, device="cpu"),
        }

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(both)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def tree():
    return _tree()


@pytest.fixture(scope="module")
def world4(refs, tree, tmp_path_factory):
    return lmesh.spawn(world4_job, 4, "gloo", "cpu", args=(tree,), timeout_s=TIMEOUT_S,
                       store_dir=str(tmp_path_factory.mktemp("moe4")))


# -- one EP layer over the group ------------------------------------------------------


@pytest.mark.parametrize("world", [4, 2])
def test_moe_ep_over_ranks_matches_stacked_and_reference(world, world4, refs):
    want, want_aux, want_dropped = refs.result()["layer"][world]
    rows = ROWS // world
    for rank in world4[:world]:
        r, got = rank["rank"], rank["layer"][world]
        s_out, s_aux, s_dropped = got["stacked"]
        np.testing.assert_array_equal(got["out"][0], s_out[r])  # bit for bit its stacked row
        np.testing.assert_array_equal(got["aux"][0], s_aux[r])
        np.testing.assert_array_equal(got["dropped"][0], s_dropped[r])
        np.testing.assert_allclose(got["out"][0].reshape(rows, SEQ, -1),
                                   want[r * rows:(r + 1) * rows], **REF_TOL)
        assert int(s_dropped.sum()) == want_dropped
        np.testing.assert_allclose(s_aux.mean(), want_aux, rtol=1e-6, atol=1e-6)
        assert got["rounds"] == {"moe": 2}
    assert (want_dropped > 0) == (world == 2)


# -- the loss over a mesh ------------------------------------------------------------


def test_ep_loss_every_rank_bit_for_bit_its_stacked_row(world4, refs):
    from repro_torch.models import moe

    stacked = refs.result()["stacked"]["metrics"]
    cfg = _cfg(4)
    for rank in world4:
        got, r = rank["loss_ep"], rank["rank"]
        m = got["metrics"]
        for key in ("ce_rows", "loss_rows"):
            np.testing.assert_array_equal(m[key], stacked[key][r])
        np.testing.assert_array_equal(m["moe_aux"], stacked["moe_aux"])
        np.testing.assert_array_equal(m["moe_dropped"], stacked["moe_dropped"])
        assert got["rounds"] == {moe.LABEL: 2 * cfg.num_layers}
        cap = moe.ep_capacity(LOSS[1], cfg)
        row = cfg.d_model * 4
        assert got["round_bytes"] == {moe.LABEL: cfg.num_layers * (4 * cap * (2 * row + 8))}
        assert got["expert_shapes"] == [(1, cfg.d_model, cfg.d_ff)]  # its one expert
        assert got["param_bytes"] == got["shard_bytes"]
        assert got["collectives"] == lm_run.design_loss_collectives(_smoke_model(), (4, 1),
                                                                    *LOSS, "ep")
    assert len({float(r["loss_ep"]["metrics"]["loss"]) for r in world4}) == 1


def test_dense_loss_over_tp_matches_reference_and_unsharded(world4, refs):
    ref = refs.result()
    cfg = _cfg(4)
    for rank in world4:
        got = rank["loss_dense"]
        np.testing.assert_allclose(got["metrics"]["loss"], ref["loss"], **LOSS_TOL)
        np.testing.assert_allclose(got["metrics"]["loss"], ref["whole"]["metrics"]["loss"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(got["metrics"]["moe_aux"], ref["whole"]["metrics"]["moe_aux"],
                                   rtol=1e-6, atol=1e-6)
        assert got["rounds"] == {}  # dense: no exchange
        e, _, f = got["expert_shapes"][0]
        assert e == cfg.num_experts and f == cfg.d_ff // 2  # every expert, its tp block of f
        assert got["param_bytes"] == got["shard_bytes"]
        assert got["collectives"] == lm_run.design_loss_collectives(_smoke_model(), (2, 2),
                                                                    *LOSS, "dense")


# -- serving over a mesh: ring layouts, EP in decode -------------------------------------


@pytest.mark.parametrize("i", range(len(SERVE_MESHES)), ids=[f"{d}x{t}" for d, t in SERVE_MESHES])
def test_mixtral_served_over_a_mesh_matches_unsharded(world4, refs, i):
    whole = refs.result()["serve"]
    cfg = _serve_cfg(SERVE_MESHES[i])
    mcfg = lm_run.model_config(cfg)
    first = world4[0]["serve"][i]
    for rank in world4:
        got = rank["serve"][i]
        assert got["tokens"] == first["tokens"] and got["logit_digests"] == first["logit_digests"]
        for uid, want in whole["logits"].items():
            np.testing.assert_allclose(got["logits"][uid], want, rtol=PORT_TOL, atol=PORT_TOL)
        assert got["param_bytes"] == got["shard_bytes"]
        for call in got["prefill"]:
            assert call["collectives"] == lm_run.design_collectives(
                mcfg, cfg.mesh, "prefill", call["len"], 1, cfg.cache_len), call
        for call in got["decode"]:
            assert call["collectives"] == lm_run.design_collectives(
                mcfg, cfg.mesh, "decode", 1, cfg.slots, cfg.cache_len), call


def test_ring_kpos_follows_its_k():
    """A ring's ``kpos`` (P, B, W) takes its ``k``'s batch and slot entries:
    whole over tp where ``k`` is split by heads, split along W where ``k``
    is split along its slots (the one-leaf rule would split W in both)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.parallel import AbstractMesh
    from repro_torch.models import transformer

    cfg = _cfg(4)  # 2 kv heads
    shapes = {"b0": transformer.block_cache_shapes(cfg, "swa", 4, 64)}
    for (d, t), kv_dim in (((2, 2), 2), ((1, 4), 3)):
        par = lmesh.production_parallel(AbstractMesh((d, t), lm_run.AXES))
        k, v, kpos = shd.cache_pspecs(shapes, par)["b0"]
        assert k == v and k[kv_dim] == "model"
        assert kpos == (None, k[1], k[3])
        assert shd.cache_leaf_spec(shapes["b0"].kpos, par)[2] == "model"
