"""Parity of the port's LM serving path with the JAX package, on the smoke
qwen3-4b config (4 layers, d_model 128, 8 query heads over 2 kv heads).

Weights are drawn once by the JAX package and carried across with
``repro_torch.models.convert``; token ids and activations come from numpy
with a seed.  On the CPU the port's attention runs kernel 6's plain twin;
the JAX side runs the Pallas flash kernel in interpret mode
(``attention_impl="flash_pallas"``) or its einsum (``"xla"``).

Tolerances:
* f32: rtol/atol 2e-4 for prefill and forward logits and 3e-4 for decode
  logits, as the JAX package's own serving tests use (the same f32
  arithmetic, summed in another order).
* bf16: atol 6e-2 and rtol 2e-2 on logits of magnitude <= ~2.2, and one
  bf16 step (2^-7 relative) on the single layers: matrix products are
  rounded to bf16 after partial sums taken in another order by XLA's and
  PyTorch's CPU kernels (one output step apart, e.g. 1e-3 in ``x @ wv``),
  and XLA keeps excess precision inside fused elementwise chains; over 4
  layers the logits drift by up to ~2.4e-2 (measured at this size).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.distributed.parallel import single_device_parallel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.api import build_model as jax_build_model
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro.serve import make_prefill_step as jax_prefill_step
from repro.serve import make_serve_step as jax_serve_step
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed.parallel import ParallelConfig
from repro_torch.kernels import build
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as attn
from repro_torch.models import convert, layers
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.serve import ContinuousBatcher, Request, make_prefill_step, make_serve_step

TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=6e-2)}
DECODE_TOL = {"float32": dict(rtol=3e-4, atol=3e-4), "bfloat16": TOL["bfloat16"]}
JAX_IMPL = {"flash": "flash_pallas", "plain": "xla"}
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype: str, impl: str = "flash"):
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_4b"), dtype=dtype,
                               attention_impl=JAX_IMPL[impl])
    cfg = dataclasses.replace(get_smoke_config("qwen3_4b"), dtype=dtype, attention_impl=impl)
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_params():
    """f32 master weights of the reference, drawn once."""
    jcfg, _ = _cfgs("float32")
    return jax_build_model(jcfg, single_device_parallel()).init(jax.random.key(0))


def _port_params(jax_params, cfg):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_params), cfg, device="cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype`` (rounded once, by JAX)."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_rope_swiglu_match_reference(dtype):
    rng = np.random.default_rng(0)
    step = dict(rtol=2**-7, atol=2**-7) if dtype == "bfloat16" else dict(rtol=1e-6, atol=1e-6)
    x_j, x_t = _both(rng.standard_normal((2, 9, 3, 32)) * 3, dtype)
    w = rng.standard_normal(32).astype(np.float32)
    _close(layers.rmsnorm(x_t, torch.from_numpy(w)), jlayers.rmsnorm(x_j, jnp.asarray(w)), step)
    pos = rng.integers(0, 5000, size=(2, 9)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(layers.apply_rope(x_t, torch.from_numpy(pos)[:, :, None], theta),
               jlayers.apply_rope(x_j, jnp.asarray(pos)[:, :, None], theta), step)
    _close(layers.rope_frequencies(32, 1e6), jlayers.rope_frequencies(32, 1e6),
           dict(rtol=1e-6, atol=0))
    h_j, h_t = _both(rng.standard_normal((2, 9, 64)), dtype)
    mats = [_both(rng.standard_normal(s) / np.sqrt(s[0]), dtype) for s in ((64, 96), (64, 96), (96, 64))]
    tol = TOL[dtype] if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)
    _close(layers.swiglu(h_t, *(m[1] for m in mats)), jlayers.swiglu(h_j, *(m[0] for m in mats)), tol)


def test_truncated_normal_rule():
    gen = torch.Generator().manual_seed(0)
    t = layers.truncated_normal_(torch.empty(4096, 256), 1.0, gen)
    z = t.numpy() * np.sqrt(4096)  # unit-scale draws
    assert np.abs(z).max() <= 2.0
    # std of a standard normal truncated to [-2, 2]: 0.8796
    assert abs(z.std() - 0.8796) < 0.01 and abs(z.mean()) < 0.01
    vec = layers.truncated_normal_(torch.empty(5000, dtype=torch.bfloat16), 0.5, gen)
    assert vec.dtype == torch.bfloat16 and float(vec.float().abs().max()) <= 1.0


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["flash", "plain"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_prefill_and_decode_match_reference(jax_params, impl, dtype):
    jcfg, cfg = _cfgs(dtype, impl)
    params = _port_params(jax_params, cfg)
    jp = jax.tree.map(lambda a: a[1], jax_params["layers"]["b0"]["attn"])  # layer 1
    p = params.layers[1].b0.attn
    rng = np.random.default_rng(1)
    x_j, x_t = _both(rng.standard_normal((2, 19, cfg.d_model)), dtype)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19))
    jout, jcache = jattn.attention(jp, x_j, jcfg, jnp.asarray(pos), return_cache=True,
                                   cache_len=24)
    out, cache = attn.attention(p, x_t, cfg, torch.from_numpy(pos.copy()),
                                return_cache=True, cache_len=24)
    tol = TOL[dtype]
    _close(out, jout, tol, "prefill output")
    _close(cache.k, jcache.k, tol, "prefill k cache")
    _close(cache.v, jcache.v, tol, "prefill v cache")
    # decode two rows at different positions against the cache, in place
    y_j, y_t = _both(rng.standard_normal((2, 1, cfg.d_model)), dtype)
    at = np.array([19, 21], np.int32)
    jout, jcache = jattn.attention(jp, y_j, jcfg, jnp.asarray(at)[:, None], cache=jcache,
                                   cache_pos=jnp.asarray(at))
    k_before = cache.k
    out, cache = attn.attention(p, y_t, cfg, torch.from_numpy(at)[:, None], cache=cache,
                                cache_pos=torch.from_numpy(at))
    assert cache.k is k_before  # written in place
    _close(out, jout, DECODE_TOL[dtype], "decode output")
    _close(cache.k, jcache.k, tol, "decode k cache")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_caches_and_decode_steps_match_reference(jax_params, dtype):
    jcfg, cfg = _cfgs(dtype)
    params = _port_params(jax_params, cfg)
    jp = jax_params if dtype == "float32" else jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a, jax_params)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, (2, 19), np.int32)
    plen, cache_len = 11, 24
    jprefill = jax.jit(jtfm.prefill, static_argnums=(2, 3, 4))
    jdecode = jax.jit(jtfm.decode_step, static_argnums=(4, 5))
    jl, jc = jprefill(jp, jnp.asarray(toks[:, :plen]), jcfg, None, cache_len)
    before = dict(build.LAUNCHES)
    tl, tc = tfm.prefill(params, torch.from_numpy(toks[:, :plen]), cfg, cache_len=cache_len)
    assert dict(build.LAUNCHES) == before
    assert tuple(tc["b0"].k.shape) == (cfg.num_periods, 2, cfg.num_kv_heads, cache_len,
                                      cfg.head_dim_)
    _close(tl, jl, TOL[dtype], "prefill logits")
    for name in ("k", "v"):
        _close(getattr(tc["b0"], name), getattr(jc["b0"], name), TOL[dtype], f"{name} caches")
    for t in range(plen, plen + 8):
        tok, pos = toks[:, t:t + 1], np.full((2,), t, np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.asarray(pos), jcfg, None)
        tl, tc = tfm.decode_step(params, tc, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        _close(tl, jl, DECODE_TOL[dtype], f"decode logits at {t}")


@pytest.mark.parametrize("impl", ["flash", "plain"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_train_logits_match_reference(jax_params, impl, dtype):
    jcfg, cfg = _cfgs(dtype, impl)
    params = _port_params(jax_params, cfg)
    jp = jax_params if dtype == "float32" else jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a, jax_params)
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 22), np.int32)
    jl, _ = jtfm.forward_train(jp, jnp.asarray(toks), jcfg, None)
    tl, aux = tfm.forward_train(params, torch.from_numpy(toks), cfg)
    assert tl.shape == (2, 21, cfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl, TOL[dtype], f"forward logits ({impl})")


def test_prefill_then_decode_matches_forward_train(jax_params):
    """The port's own consistency check, as the reference's serving test:
    prefill + step-by-step decode == the teacher-forced pass (f32)."""
    _, cfg = _cfgs("float32")
    params = _port_params(jax_params, cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, cfg.vocab_size, (1, 13), np.int32))
    full, _ = tfm.forward_train(params, toks, dataclasses.replace(cfg, attention_impl="plain"))
    logits, caches = tfm.prefill(params, toks[:, :4], cfg, cache_len=12)
    _close(logits, full[:, 3], TOL["float32"])
    for t in range(4, 12):
        logits, caches = tfm.decode_step(params, caches, toks[:, t:t + 1],
                                         torch.tensor([t], dtype=torch.int32), cfg)
        _close(logits, full[:, t], DECODE_TOL["float32"], f"position {t}")


def test_batcher_token_streams_match_reference(jax_params):
    """7 requests through 3 slots, cache 64, f32, as the reference's batcher
    test: the port's batcher emits the reference batcher's tokens, request
    by request (greedy argmax; ties take the first index on both sides).
    Prompts share one length so the reference compiles one prefill; the
    request lengths differ, so slots are refilled at different steps."""
    jcfg, cfg = _cfgs("float32")
    params = _port_params(jax_params, cfg)
    slots, cache_len = 3, 64
    jb = jax_build_model(jcfg, single_device_parallel())
    bundle = build_model(cfg, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=8, dtype=np.int32) for _ in range(7)]
    jbatcher = JaxBatcher(jax_params, jb.init_cache(slots, cache_len),
                          jax_prefill_step(jb, cache_len=cache_len),
                          jax_serve_step(jb, donate=False), num_slots=slots)
    batcher = ContinuousBatcher(params, bundle.init_cache(slots, cache_len),
                                make_prefill_step(bundle, cache_len=cache_len),
                                make_serve_step(bundle), num_slots=slots)
    for uid, prompt in enumerate(prompts):
        jbatcher.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=5 + uid % 3))
        batcher.submit(Request(uid=uid, prompt=prompt, max_new_tokens=5 + uid % 3))
    want = {r.uid: r.out_tokens for r in jbatcher.run_until_drained(max_steps=200)}
    got = {r.uid: r.out_tokens for r in batcher.run_until_drained(max_steps=200)}
    assert len(got) == 7 and all(len(got[u]) == 5 + u % 3 for u in got)
    assert got == want


# ---------------------------------------------------------------------------
# convert, config registry, device choice
# ---------------------------------------------------------------------------
def test_convert_round_trip(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    _, cfg = _cfgs("float32")
    back = convert.params_to_numpy(convert.params_from_numpy(tree, cfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # bf16: matrices round to nearest even exactly as .astype(bfloat16); norms stay f32
    _, cfg16 = _cfgs("bfloat16")
    model16 = convert.params_from_numpy(tree, cfg16, device="cpu")
    assert model16.layers[0].b0.attn.wq.dtype == torch.bfloat16
    assert model16.layers[0].b0.norm1.dtype == torch.float32
    want16 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16), np.float32)
                          if a.ndim >= 2 else np.asarray(a), jax_params)
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(model16)), jax.tree.leaves(want16)):
        np.testing.assert_array_equal(a, b)
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_numpy(bad, cfg, device="cpu")


def test_other_archs_and_block_types_raise_not_implemented():
    ported = {"qwen3_4b": 36, "xlstm_1_3b": 48, "granite_20b": 52}
    for arch in ARCH_IDS:
        if arch in ported:
            assert get_config(arch).num_layers == ported[arch]
            assert get_smoke_config(arch).num_layers == 4
            continue
        with pytest.raises(NotImplementedError, match="slice"):
            get_config(arch)
        with pytest.raises(NotImplementedError, match="slice"):
            get_smoke_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt5")
    base = get_smoke_config("qwen3_4b")
    for change in (dict(block_pattern=("swa",), sliding_window=8),
                   dict(block_pattern=("local",), local_window=8),
                   dict(block_pattern=("rglru",), rnn_width=64),
                   dict(num_experts=4, experts_per_token=2)):
        with pytest.raises(NotImplementedError, match="slice"):
            build_model(dataclasses.replace(base, **change), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE slice"):
        build_model(dataclasses.replace(base, num_experts=4, experts_per_token=2),
                    parallel=ParallelConfig(mesh=None, moe_impl="ep"), device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        build_model(dataclasses.replace(base, attention_impl="xla"), device="cpu")


def test_full_width_config_and_default_attention():
    cfg = get_config("qwen3_4b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
            cfg.d_ff, cfg.vocab_size) == (36, 2560, 32, 8, 128, 9728, 151936)
    assert cfg.attention_impl == "flash" and cfg.tie_embeddings and cfg.rope_theta == 1e6
    # 4.02e9 parameters, counted on the meta device (nothing allocated)
    model = tfm.Transformer(cfg, dtype=torch.bfloat16, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 4_022_468_096


def test_build_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke_config("qwen3_4b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--requests", "1"])
    assert build_model(get_smoke_config("qwen3_4b"), device="cpu").device.type == "cpu"


def test_serve_cli_runs_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--requests", "5", "--slots", "2", "--prompt-len", "6",
                    "--max-new", "3", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert "requests=5 tokens=15" in out and "device=cpu" in out
