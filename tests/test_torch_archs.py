"""The last archs of the registry against the JAX package: pixtral-12b's
patch prefix (the stub frontend's embeddings before the tokens), the dense
qwen3-14b and llama3-405b, ``all_configs``, every new arch's full-width
parameter count and the bundle's input specs; and Griffin's and whisper's
specs over a mesh against the reference's.

Weights are drawn once by the JAX package at each smoke config and carried
across with ``repro_torch.models.convert``; patch embeddings and token ids
come from numpy with a seed.  On the CPU the port's attention runs kernel
6's plain twin; the JAX side runs its einsum.  Everything in f32.

Tolerances: logits 2e-4 and decode logits 3e-4 (the bounds
``tests/test_torch_lm.py`` states: the same f32 arithmetic summed in
another order); configs, parameter counts and specs exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.distributed.parallel import single_device_parallel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed.parallel import AbstractMesh, ParallelConfig  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.utils import tree_param_count  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: E402,F401  (an autouse fixture)

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)
NEW_ARCHS = ("recurrentgemma_9b", "whisper_base", "pixtral_12b", "qwen3_14b", "llama3_405b")


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32", attention_impl="xla")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return jcfg, cfg


def _both_params(arch):
    jcfg, cfg = _cfgs(arch)
    jp = jax_build_model(jcfg, single_device_parallel()).init(jax.random.key(0))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out.pop("attention_impl")  # "flash" / "plain" stand for "flash_pallas" / "xla"
    return out


def test_all_configs_equal_the_reference():
    got, want = configs.all_configs(), jbase.all_configs()
    assert list(got) == list(want) == list(ARCH_IDS)
    for arch in ARCH_IDS:
        assert _fields(got[arch]) == _fields(want[arch]), arch
        assert got[arch].attention_impl == "flash"
        assert _fields(get_smoke_config(arch)) == _fields(jax_smoke_config(arch)), arch


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_parameter_count_equals_the_reference(arch):
    """The port's module on the meta device against the reference's
    ``jax.eval_shape`` of its init: the same count and the same shapes
    (the reference's stacked leaves unstacked)."""
    want = jax_build_model(jbase.get_config(arch), single_device_parallel()).param_shapes()
    bundle = build_model(get_config(arch), device="cpu")
    meta = bundle.param_shapes()
    assert tree_param_count(meta) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(want))
    assert all(t.device.type == "meta" for t in meta.parameters())
    groups = convert.stacked_groups(meta.cfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    shapes = {name: tuple(t.shape) for name, t in meta.named_parameters()}
    for path, leaf in flat:
        name = ".".join(str(getattr(e, "key", e)) for e in path)
        group = name.partition(".")[0]
        if group in groups:
            rest = name.partition(".")[2]
            for i in range(groups[group]):
                assert shapes.pop(f"{group}.{i}.{rest}") == tuple(leaf.shape[1:]), name
        else:
            assert shapes.pop(name) == tuple(leaf.shape), name
    assert not shapes


def test_input_specs_equal_the_reference():
    cell = jbase.shape_cell("decode_32k")
    for arch in NEW_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch))
        jb = jax_build_model(jax_smoke_config(arch), single_device_parallel())
        tb = build_model(cfg, device="cpu")
        for jfn, tfn in ((jb.train_input_specs, tb.train_input_specs),
                         (jb.prefill_input_specs, tb.prefill_input_specs),
                         (jb.decode_input_specs, tb.decode_input_specs)):
            want, got = jfn(cell), tfn(cell)
            wl = jax.tree.leaves(want)
            gl = jax.tree.leaves(got, is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "dtype"))
            assert [tuple(a.shape) for a in wl] == [tuple(b.shape) for b in gl], arch
            assert [str(a.dtype) for a in wl] == [str(b.dtype).replace("torch.", "") for b in gl]


def test_pixtral_prefix_prefill_decode_and_forward_match_reference():
    """16 patch embeddings + 9 prompt tokens into a 32-slot cache, then 6
    decode steps at positions 25..30; the teacher-forced pass with the same
    prefix; the loss with ``patch_emb``."""
    arch = "pixtral_12b"
    jcfg, cfg = _cfgs(arch)
    jp, params = _both_params(arch)
    rng = np.random.default_rng(0)
    patch = rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, (2, 16), np.int32)
    p_len, plen = cfg.frontend_len, 9
    jb = jax_build_model(jcfg, single_device_parallel())
    tb = build_model(cfg, device="cpu")
    jfull, _ = jtfm.forward_train(jp, jnp.asarray(toks), jcfg, None, prefix_emb=jnp.asarray(patch))
    full, aux = tb.forward_train(params, toks, patch_emb=patch)
    assert full.shape == (2, 15, cfg.vocab_size) and float(aux) == 0.0
    _close(full, jfull, TOL, "forward_train with the prefix")
    batch = {"tokens": toks, "patch_emb": patch}
    jloss, _ = jtfm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, None)
    loss, _ = tb.loss(params, batch)
    _close(loss, jloss, dict(rtol=1e-5, atol=1e-5), "loss")
    jlog, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks[:, :plen]),
                               "patch_emb": jnp.asarray(patch)}, cache_len=32)
    tlog, tc = tb.prefill(params, {"tokens": toks[:, :plen], "patch_emb": patch}, cache_len=32)
    assert tc["b0"].k.shape[3] == 32
    _close(tlog, jlog, TOL, "prefill")
    _close(tlog, full[:, plen - 1], TOL, "prefill against forward")
    for t in range(plen, toks.shape[1] - 1):
        tok, pos = toks[:, t:t + 1], np.full((2,), p_len + t, np.int32)
        jlog, jc = jb.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tc = tb.decode_step(params, tc, tok, pos)
        _close(tlog, jlog, DECODE_TOL, f"decode {t}")
        _close(tlog, full[:, t], DECODE_TOL, f"decode {t} against forward")
    # a cache shorter than prefix + prompt is grown to cover both, as the reference's
    _, short = tb.prefill(params, {"tokens": toks[:, :plen], "patch_emb": patch}, cache_len=4)
    assert short["b0"].k.shape[3] == p_len + plen


@pytest.mark.parametrize("arch", ["qwen3_14b", "llama3_405b"])
def test_dense_smoke_forward_and_serving_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, params = _both_params(arch)
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 21), np.int32)
    jl, _ = jtfm.forward_train(jp, jnp.asarray(toks), jcfg, None)
    tl, _ = tfm.forward_train(params, torch.from_numpy(toks), cfg)
    _close(tl, jl, TOL, "forward_train")
    jb = jax_build_model(jcfg, single_device_parallel())
    tb = build_model(cfg, device="cpu")
    jlog, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])}, cache_len=24)
    tlog, tc = tb.prefill(params, {"tokens": toks[:, :12]}, cache_len=24)
    _close(tlog, jlog, TOL, "prefill")
    for t in range(12, 16):
        tok, pos = toks[:, t:t + 1], np.full((2,), t, np.int32)
        jlog, jc = jb.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tc = tb.decode_step(params, tc, tok, pos)
        _close(tlog, jlog, DECODE_TOL, f"decode {t}")
        _close(tlog, tl[:, t], DECODE_TOL, f"decode {t} against forward")


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "whisper_base"])
def test_griffin_and_encdec_over_a_mesh_raise_naming_their_slice(arch):
    """Griffin and the encoder-decoder now run over a mesh (the guard that
    raised here, naming a later slice, is gone; the ranks' runs are
    ``tests/test_torch_archs_procs.py``'s): on each mesh every leaf of the
    port's module takes the reference's spec without its stacked layer
    dim, and building over a mesh the process group does not span is
    refused for the group's size alone."""
    from jax.sharding import AbstractMesh as JAbstractMesh
    from jax.sharding import PartitionSpec as P

    from repro.distributed import sharding as jshd
    from repro.distributed.parallel import ParallelConfig as JParallel
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.api import model_class

    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    model = model_class(cfg)(cfg, dtype=torch.float32, device="meta")
    shapes = jax_build_model(jcfg, single_device_parallel()).param_shapes()
    groups = convert.stacked_groups(cfg)
    for shape in ((2, 2), (1, 4), (2, 1)):
        names = ("data", "model")
        par = ParallelConfig(mesh=AbstractMesh(shape, names))
        jspecs = jshd.param_pspecs(shapes, JParallel(mesh=JAbstractMesh(shape, names)))
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, P))
        ref = {".".join(str(e.key) for e in path): tuple(spec) for path, spec in flat}
        got = shd.param_pspecs(model, par)
        for name in got:
            group, _, rest = name.partition(".")
            if group in groups:
                want = ref[f"{group}.{rest.partition('.')[2]}"]
                assert want[0] is None
                want = want[1:]
            else:
                want = ref[name]
            norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                         for e in got[name])
            assert norm == want, (shape, name)
        with pytest.raises(ValueError, match="over a group of 1 rank"):
            build_model(cfg, par, device="cpu")
    one = ParallelConfig(mesh=AbstractMesh((1, 1), ("data", "model")))
    build_model(cfg, one, device="cpu")  # one rank: the unsharded model


def _prefix_logits(run, sharded: bool = True) -> np.ndarray:
    """pixtral's prefill and decode over ``run.requests`` rows at once, on
    this rank (``sharded``: over the live group's mesh): ``frontend_len``
    normal patch embeddings and ``prompt_lens[0]`` tokens a row, drawn from
    ``run.seed``, then ``max_new[0]`` decode steps fed tokens drawn from the
    seed (two runs whose logits differ by rounding feed the same ids).  The
    logits of every step ``(1 + steps, B, V)``, whole on every rank."""
    from repro_torch.distributed.parallel import single_device_parallel
    from repro_torch.launch import lm_run

    mcfg = lm_run.model_config(run)
    parallel = lm_run.parallel_of(run) if sharded else single_device_parallel()
    bundle = build_model(mcfg, parallel, device="cpu", timeout_s=60.0)
    params = bundle.init(run.seed)
    rng = np.random.default_rng(run.seed + 3)
    b, n, steps = run.requests, run.prompt_lens[0], run.max_new[0]
    patch = rng.standard_normal((b, mcfg.frontend_len, mcfg.d_model)).astype(np.float32)
    tokens = rng.integers(1, mcfg.vocab_size, (b, n + steps), np.int32)
    logits, caches = bundle.prefill(params, {"tokens": tokens[:, :n], "patch_emb": patch},
                                    cache_len=run.cache_len)
    out = [logits.float().numpy()]
    for t in range(steps):
        pos = np.full((b,), mcfg.frontend_len + n + t, np.int32)
        logits, caches = bundle.decode_step(params, caches, tokens[:, n + t:n + t + 1], pos)
        out.append(logits.float().numpy())
    return np.stack(out)


def prefix_job(group, runs) -> list:
    """A rank's ``_prefix_logits`` of each of ``runs`` (a ``spawn`` target)."""
    return [_prefix_logits(run) for run in runs]


def test_pixtral_prefix_over_a_mesh_matches_the_unsharded_run(tmp_path):
    """pixtral-12b smoke over two gloo ranks, on (data, model) = (1, 2)
    (tensor parallel; 16 patches + 8 tokens divide over tp, so the prefill
    is sequence-parallel with the prefix split with the tokens) and (2, 1)
    (each rank its row of the patches and tokens): the prefill and 3 decode
    steps' logits of every rank the same bits and within 2e-5 of the
    unsharded run (the same f32 arithmetic summed in another order across
    ranks, ``tests/test_torch_procs_lm.py``'s bound)."""
    from repro_torch.launch import lm_run
    from repro_torch.launch import mesh as lmesh

    runs = [lm_run.LMRunConfig(arch="pixtral_12b", smoke=True, dtype="float32", mesh=mesh,
                               requests=2, cache_len=32, prompt_lens=(8, 8), max_new=(3,))
            for mesh in ((1, 2), (2, 1))]
    want = _prefix_logits(runs[0], sharded=False)
    ranks = lmesh.spawn(prefix_job, 2, "gloo", "cpu", args=(runs,), timeout_s=120.0,
                        store_dir=str(tmp_path))
    assert len(ranks) == 2
    for res in ranks:
        for got in res:
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for a, b in zip(ranks[0], ranks[1]):
        assert np.array_equal(a, b)
