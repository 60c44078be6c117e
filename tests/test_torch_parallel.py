"""The port's parallel config, sharding rules and meshes against the JAX
package's, in one process, and granite-20b's smoke model unsharded.

* Specs: for every leaf of all ten reference archs (``param_shapes()``, an
  ``eval_shape``) the port's ``param_spec`` and ``shard_bytes_per_device``
  equal the reference's on the abstract meshes (16, 16), (2, 16, 16),
  (2, 4), (2, 2) and (1, 4), and its cache rule on every leaf of their
  decode caches; the port's own qwen3-4b, xlstm-1.3b and granite-20b
  modules (meta device, full and smoke) get the reference's specs with the
  scan dim dropped;
  ``cache_pspecs`` and ``shard_bytes_per_device`` agree; every case of
  ``tests/test_sharding_rules.py`` holds for the port's functions.
* Configs: ``production_parallel``, the smoke mesh shapes and
  ``single_device_parallel`` equal the reference's; the production mesh
  needs a world of 256 (512) ranks.
* granite-20b smoke, unsharded and in f32, equals the reference (prefill and
  decode logits, rtol/atol 2e-4 and 3e-4 as ``test_torch_lm.py`` holds
  qwen3: the same f32 arithmetic summed in another order).
* Guards: a mesh that does not fit the group, ``moe_impl="ep"`` on a MoE
  config, entry points without a card.

Tolerances: none for the rules (equal specs and byte counts).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.distributed.parallel import ParallelConfig as JParallel  # noqa: E402
from repro.distributed.parallel import single_device_parallel as j_single  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.utils.compat import abstract_mesh as JAbstractMesh  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.parallel import (  # noqa: E402
    AbstractMesh, ParallelConfig, single_device_parallel)
from repro_torch.launch import lm_run  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.models import convert, transformer  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

MESHES = {
    "16x16": ((16, 16), ("data", "model"), ("data",)),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model"), ("pod", "data")),
    "2x4": ((2, 4), ("data", "model"), ("data",)),
    "2x2": ((2, 2), ("data", "model"), ("data",)),
    "1x4": ((1, 4), ("data", "model"), ("data",)),
}
PORT_ARCHS = ("qwen3_4b", "xlstm_1_3b", "granite_20b")


def _norm(spec) -> tuple:
    """Spec entries with one-axis tuples as the axis (PartitionSpec's form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _parallels(key):
    shape, names, dp = MESHES[key]
    jp = JParallel(mesh=JAbstractMesh(shape, names), dp_axes=dp, tp_axis="model")
    tp = ParallelConfig(mesh=AbstractMesh(shape, names), dp_axes=dp, tp_axis="model")
    return jp, tp


_SHAPES = {}


def _ref_shapes(arch, smoke=False):
    """The reference's parameter shapes (cached: eval_shape of its init)."""
    key = (arch, smoke)
    if key not in _SHAPES:
        cfg = (jax_smoke_config if smoke else jax_config)(arch)
        _SHAPES[key] = jax_build_model(cfg, j_single()).param_shapes()
    return _SHAPES[key]


def _ref_leaves(shapes):
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in flat:
        names = tuple(str(getattr(e, "key", getattr(e, "name", e))) for e in path)
        out.append((path, names, leaf))
    return out


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_equals_reference_on_every_leaf(arch, mesh_key):
    jp, tp = _parallels(mesh_key)
    shape = dict(zip(MESHES[mesh_key][1], MESHES[mesh_key][0]))
    jspecs = jshd.param_pspecs(_ref_shapes(arch), jp)
    flat_specs = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
    leaves = _ref_leaves(_ref_shapes(arch))
    assert len(flat_specs) == len(leaves)
    specs = {}
    for (path, names, leaf), jspec in zip(leaves, flat_specs):
        got = shd.param_spec(names, tuple(leaf.shape), dp_axes=tp.dp_axes, tp_axis=tp.tp_axis,
                             mesh_shape=shape, scanned=shd.is_scanned_layer(names))
        assert _norm(got) == tuple(jspec), (arch, mesh_key, names)
        specs[".".join(names)] = got
    named = {".".join(names): leaf for _, names, leaf in leaves}
    assert shd.shard_bytes_per_device(named, specs, shape) == \
        jshd.shard_bytes_per_device(_ref_shapes(arch), jspecs, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_leaf_spec_equals_reference_on_every_leaf(arch):
    """The port's cache rule on each leaf of the reference's decode caches
    (KV, ring, recurrent and encoder-decoder states) on the five meshes."""
    jb = jax_build_model(jax_config(arch), j_single())
    cshapes = jax.eval_shape(lambda: jb.init_cache(256, 1024))
    leaves = jax.tree_util.tree_leaves(cshapes)
    for mesh_key in MESHES:
        jp, tp = _parallels(mesh_key)
        jspecs = jax.tree_util.tree_leaves(jshd.cache_pspecs(cshapes, jp),
                                           is_leaf=lambda x: isinstance(x, P))
        assert len(jspecs) == len(leaves)
        for leaf, jspec in zip(leaves, jspecs):
            got = shd.cache_leaf_spec(tuple(leaf.shape), tp)
            assert _norm(got) == tuple(jspec), (arch, mesh_key, leaf.shape)


def _port_model(arch, smoke):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    return transformer.Transformer(cfg, dtype=transformer.compute_dtype(cfg), device="meta")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_port_module_specs_are_the_reference_without_the_scan_dim(arch, smoke):
    model = _port_model(arch, smoke)
    for mesh_key in MESHES:
        jp, tp = _parallels(mesh_key)
        ref = {}
        jspecs = jshd.param_pspecs(_ref_shapes(arch, smoke), jp)
        flat_specs = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
        for (path, names, leaf), spec in zip(_ref_leaves(_ref_shapes(arch, smoke)), flat_specs):
            ref[".".join(names)] = (tuple(leaf.shape), tuple(spec))
        got = shd.param_pspecs(model, tp)
        assert len(got) == sum(model.cfg.num_periods if k.startswith("layers.") else 1
                               for k in ref)
        for name, t in model.named_parameters():
            if name.startswith("layers."):
                _, _, rest = name.split(".", 2)
                shape, spec = ref["layers." + rest]
                assert spec[0] is None
                shape, spec = shape[1:], spec[1:]
            else:
                shape, spec = ref[name]
            assert tuple(t.shape) == shape, name
            assert _norm(got[name]) == spec, (mesh_key, name)


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_cache_specs_and_shard_bytes_equal_reference(arch):
    for smoke in (False, True):
        jcfg = (jax_smoke_config if smoke else jax_config)(arch)
        cfg = (get_smoke_config if smoke else get_config)(arch)
        for mesh_key in ("16x16", "2x4", "2x2", "1x4"):
            jp, tp = _parallels(mesh_key)
            jb = jax_build_model(jcfg, jp)
            jshapes = jax.eval_shape(lambda: jb.init_cache(256, 1024))
            jspecs = jshd.cache_pspecs(jshapes, jp)
            shapes = {f"b{j}": transformer.block_cache_shapes(cfg, bt, 256, 1024)
                      for j, bt in enumerate(cfg.block_pattern)}
            got = shd.cache_pspecs(shapes, tp)
            for name, c in jshapes.items():
                for field in c._fields:
                    assert tuple(getattr(c, field).shape) == getattr(shapes[name], field)
                    assert _norm(getattr(got[name], field)) == \
                        tuple(getattr(jspecs[name], field)), (arch, mesh_key, name, field)
        shape = dict(zip(MESHES["16x16"][1], MESHES["16x16"][0]))
        jp, tp = _parallels("16x16")
        pshapes = _ref_shapes(arch, smoke)
        jspecs = jshd.param_pspecs(pshapes, jp)
        flat_specs = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
        leaves = {".".join(n): leaf for _, n, leaf in _ref_leaves(pshapes)}
        specs = {k: tuple(s) for k, s in zip(leaves, flat_specs)}
        assert shd.shard_bytes_per_device(leaves, specs, shape) == \
            jshd.shard_bytes_per_device(pshapes, jspecs, shape)


# -- the cases of tests/test_sharding_rules.py, on the port's functions ---------


def _port_specs(arch, multi_pod=False):
    _, tp = _parallels("2x16x16" if multi_pod else "16x16")
    model = _port_model(arch, smoke=False)
    return model, shd.param_pspecs(model, tp), tp


def _ref_leaf_specs(arch, multi_pod=False, scanned_dims=True):
    """The port's param_spec on the reference's (scanned) leaves."""
    _, tp = _parallels("2x16x16" if multi_pod else "16x16")
    shape = dict(zip(*reversed(MESHES["2x16x16" if multi_pod else "16x16"][:2])))
    out = {}
    for _, names, leaf in _ref_leaves(_ref_shapes(arch)):
        out[".".join(names)] = (tuple(leaf.shape), shd.param_spec(
            names, tuple(leaf.shape), dp_axes=tp.dp_axes, tp_axis=tp.tp_axis,
            mesh_shape=shape, scanned=shd.is_scanned_layer(names)))
    return out


def test_qwen3_megatron_roles():
    model, specs, _ = _port_specs("qwen3_4b")
    assert specs["embed"][0] == "model" and specs["embed"][1] is None
    for name, spec in specs.items():
        if name.endswith(".wq"):
            assert spec[-1] == "model", name  # column-parallel heads
        if name.endswith(".wo") or name.endswith(".w_down"):
            assert spec[-2] == "model", name  # row-parallel
        if "norm" in name:
            assert all(s is None for s in spec), name  # replicated


def test_scan_leading_dim_never_sharded():
    for name, (shape, spec) in _ref_leaf_specs("llama3_405b").items():
        if name.startswith("layers.") and len(shape) >= 2:
            assert spec[0] is None, name


def test_every_big_leaf_is_fsdp_sharded_multipod():
    for name, (shape, spec) in _ref_leaf_specs("llama3_405b", multi_pod=True).items():
        if int(np.prod(shape)) * 4 > 32 * 2**20:
            assert any(s is not None for s in spec), name


def test_moe_expert_weights():
    found = 0
    for name, (shape, spec) in _ref_leaf_specs("grok_1_314b").items():
        if "moe" in name and name.endswith(".w_gate"):
            found += 1
            assert spec[-1] == "model" and spec[0] is None
    assert found


def test_whisper_odd_vocab_falls_back_to_replicated():
    shape, spec = _ref_leaf_specs("whisper_base")["embed"]
    assert shape[0] == 51865 and spec[0] is None


@pytest.mark.parametrize("arch,tp,expect_dim",
                         [("granite_20b", 16, 3), ("qwen3_4b", 16, 3), ("qwen3_4b", 4, 2)])
def test_cache_specs_head_vs_sequence_sharding(arch, tp, expect_dim):
    cfg = get_config(arch)
    par = ParallelConfig(mesh=AbstractMesh((256 // tp, tp), ("data", "model")))
    shapes = {"b0": transformer.block_cache_shapes(cfg, "attn", 256, 1024)}
    for spec in shd.cache_pspecs(shapes, par)["b0"]:
        assert spec[1] == ("data",) and spec[expect_dim] == "model", spec


def test_batch_pspec():
    _, tp = _parallels("2x16x16")
    assert shd.batch_pspec(2, tp) == (("pod", "data"), None)
    assert shd.batch_pspec(2, single_device_parallel()) == ()


def test_shard_bytes_accounting():
    model, specs, par = _port_specs("qwen3_4b")
    shape = dict(zip(MESHES["16x16"][1], MESHES["16x16"][0]))
    total = shd.shard_bytes_per_device(model, specs, shape)
    full = sum(t.numel() * t.element_size() for t in model.parameters())
    assert total < full / 32


def test_spec_summary_and_blocks():
    model, specs, _ = _port_specs("granite_20b")
    rows = shd.spec_summary(model, specs, max_rows=3).splitlines()
    assert len(rows) == 3 and rows[0].startswith("embed") and "model" in rows[0]
    mesh = AbstractMesh((2, 4), ("data", "model"))
    full = torch.arange(8 * 12).reshape(8, 12)
    spec = (("data",), "model")
    blocks = {(d, m): shd.block(full, spec, mesh, {"data": d, "model": m})
              for d in range(2) for m in range(4)}
    assert blocks[(1, 2)].shape == (4, 3)
    assert torch.equal(blocks[(1, 2)], full[4:8, 6:9])
    assert shd.local_shape((8, 12), spec, mesh.shape) == (4, 3)


# -- configs and meshes -----------------------------------------------------------


def _fields(par):
    return {f.name: getattr(par, f.name) for f in dataclasses.fields(par) if f.name != "mesh"}


@pytest.mark.parametrize("mesh_key", ["16x16", "2x16x16", "2x2"])
def test_production_parallel_equals_reference(mesh_key):
    shape, names, _ = MESHES[mesh_key]
    got = lmesh.production_parallel(AbstractMesh(shape, names))
    want = jmesh.production_parallel(JAbstractMesh(shape, names))
    assert _fields(got) == _fields(want)
    assert (got.dp_size, got.tp_size) == (want.dp_size, want.tp_size)
    assert got.batch_spec(2) == (want.dp_axes, None, None)
    assert _fields(single_device_parallel()) == _fields(j_single())


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_smoke_mesh_shapes_equal_reference(n):
    want = jmesh.make_smoke_mesh(n)
    shape, names = lmesh.smoke_mesh_shape(n)
    assert dict(zip(names, shape)) == dict(want.shape)


def test_production_mesh_needs_its_world():
    assert lmesh.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert lmesh.production_mesh_shape(True) == ((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="256"):
        lmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        lmesh.make_production_mesh(multi_pod=True)


def test_act_spec_is_the_reference_constraint():
    par = ParallelConfig(mesh=AbstractMesh((2, 4), ("data", "model")), seq_parallel=True)
    assert par.act_spec((4, 8, 16)) == (("data",), "model", None)
    assert par.act_spec((3, 6, 16)) == (None, None, None)  # neither divides: a no-op
    assert par.act_spec((4, 8, 16), seq_dim=None) == (("data",), None, None)
    assert ParallelConfig(mesh=None).act_spec((4, 8)) == (None, None)
    x = torch.arange(4 * 8).reshape(4, 8, 1)
    assert ParallelConfig(mesh=None).shard_act(x) is x


# -- granite-20b unsharded ----------------------------------------------------------


def test_granite_smoke_unsharded_equals_reference():
    jcfg = dataclasses.replace(jax_smoke_config("granite_20b"), dtype="float32",
                               attention_impl="xla")
    cfg = dataclasses.replace(get_smoke_config("granite_20b"), dtype="float32")
    jb = jax_build_model(jcfg, j_single())
    jparams = jb.init(jax.random.key(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    bundle = build_model(cfg, single_device_parallel(), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 11), dtype=np.int32)
    jl, jc = jax.jit(lambda p, t: jb.prefill(p, {"tokens": t}, cache_len=16))(
        jparams, jnp.asarray(toks))
    logits, caches = bundle.prefill(params, {"tokens": toks}, cache_len=16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    step = jax.jit(jb.decode_step)
    for j in range(3):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        pos = np.full((2,), 11 + j, np.int32)
        jl, jc = step(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        logits, caches = bundle.decode_step(params, caches, tok, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=3e-4, atol=3e-4)


def test_granite_config_equals_reference():
    for getter, jgetter in ((get_config, jax_config), (get_smoke_config, jax_smoke_config)):
        got, want = getter("granite_20b"), jgetter("granite_20b")
        fields = {f.name for f in dataclasses.fields(want)} - {"attention_impl"}
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


# -- guards -------------------------------------------------------------------------


def test_mesh_that_does_not_fit_the_group_raises():
    cfg = get_smoke_config("qwen3_4b")
    par = ParallelConfig(mesh=AbstractMesh((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="group of 1"):
        build_model(cfg, par, device="cpu")
    one = ParallelConfig(mesh=AbstractMesh((1, 1), ("data", "model")))
    assert not build_model(cfg, one, device="cpu").layout.sharded


def test_moe_ep_raises_naming_the_moe_slice():
    base = get_smoke_config("qwen3_4b")
    moe = dataclasses.replace(base, num_experts=4, experts_per_token=2)
    with pytest.raises(NotImplementedError, match="MoE slice"):
        build_model(moe, lmesh.production_parallel(AbstractMesh((1, 1), ("data", "model"))),
                    device="cpu")


def test_entry_points_take_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("granite_20b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, single_device_parallel())
    run = lm_run.LMRunConfig(arch="granite_20b", smoke=True, requests=1, prompt_lens=(4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_run.run_lm(run, sharded=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lmesh.spawn(lm_run.rank_job, 2, args=([run],))
