"""Parity of the port's xLSTM serving path with the JAX package, on the
smoke xlstm-1.3b config (4 layers alternating mLSTM and sLSTM, d_model 128,
4 heads, vocab 512).

Weights are drawn once by the JAX package and carried across with
``repro_torch.models.convert``; token ids and activations come from numpy
with a seed.  On the CPU the port's sLSTM runs kernel 7's plain twin; the
reference's sLSTM block runs its ``lax.scan``.

Tolerances:
* mLSTM block and decode step, f32: 3e-5 relative and absolute (the same
  f32 arithmetic, its products summed in another order).
* the model in f32: 2e-4 for prefill and forward logits and 3e-4 for decode
  logits, as the JAX package's own serving tests use.
* the model in bf16: atol 6e-2 and rtol 2e-2, the bound of
  ``tests/test_torch_lm.py`` for the same reason: bf16 products are rounded
  after partial sums taken in another order by XLA's and PyTorch's CPU
  kernels, and XLA keeps excess precision inside fused elementwise chains.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax
import jax.numpy as jnp

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.distributed.parallel import single_device_parallel
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.models.api import build_model as jax_build_model
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro.serve import make_prefill_step as jax_prefill_step
from repro.serve import make_serve_step as jax_serve_step
from repro.serve.engine import serving_compute_copy as jax_serving_copy
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.kernels import build
from repro_torch.launch import serve as serve_cli
from repro_torch.models import convert, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.serve import (ContinuousBatcher, Request, make_prefill_step, make_serve_step,
                               serving_compute_copy)
from repro_torch.serve.batcher import _write_slot
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

ARCH = "xlstm_1_3b"
MLSTM_TOL = dict(rtol=3e-5, atol=3e-5)
TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=6e-2)}
DECODE_TOL = {"float32": dict(rtol=3e-4, atol=3e-4), "bfloat16": TOL["bfloat16"]}
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype: str):
    return (dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


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


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


# ---------------------------------------------------------------------------
# the mLSTM block
# ---------------------------------------------------------------------------
def test_mlstm_block_and_decode_match_reference():
    """S = 21 over chunks of 8 (two full chunks and a zero-padded one),
    then 3 decode steps (chunk 1) from the returned state."""
    jcfg, cfg = _cfgs("float32")
    jp = jssm.init_mlstm(jax.random.key(1), jcfg)
    p = ssm.MLSTM(cfg, dtype=torch.float32, device="meta")
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()}, assign=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    want, jst = jssm.mlstm_block(jp, jnp.asarray(x), jcfg, chunk=8, return_state=True)
    got, tst = ssm.mlstm_block(p, torch.from_numpy(x), cfg, chunk=8, return_state=True)
    _close(got, want, MLSTM_TOL, "block output")
    _close(tst.c, jst.c, MLSTM_TOL, "state c")
    _close(tst.n, jst.n, MLSTM_TOL, "state n")
    # one chunk over all 21 tokens gives the same output and state
    whole, wst = ssm.mlstm_block(p, torch.from_numpy(x), cfg, return_state=True)
    _close(whole, want, MLSTM_TOL, "one chunk")
    _close(wst.c, jst.c, MLSTM_TOL, "one chunk's state")
    for t in range(3):
        y = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, jst = jssm.mlstm_decode_step(jp, jnp.asarray(y), jcfg, jst)
        to, tst = ssm.mlstm_decode_step(p, torch.from_numpy(y), cfg, tst)
        _close(to, jo, MLSTM_TOL, f"decode output {t}")
        _close(tst.c, jst.c, MLSTM_TOL, f"decode state c {t}")
        _close(tst.n, jst.n, MLSTM_TOL, f"decode state n {t}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _jax_view(jax_params, dtype):
    """The reference's weights as the port holds them: in bf16 every matrix
    (r included) rounded once, as ``serving_compute_copy`` does."""
    return jax_params if dtype == "float32" else jax_serving_copy(jax_params)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_train_logits_match_reference(jax_params, dtype):
    jcfg, cfg = _cfgs(dtype)
    params = _port_params(jax_params, cfg)
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 22), np.int32)
    jl, _ = jtfm.forward_train(_jax_view(jax_params, dtype), jnp.asarray(toks), jcfg, None)
    tl, aux = tfm.forward_train(params, torch.from_numpy(toks), cfg)
    assert tl.shape == (2, 21, cfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl, TOL[dtype], "forward logits")


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_states_and_decode_steps_match_reference(jax_params, dtype):
    jcfg, cfg = _cfgs(dtype)
    params = _port_params(jax_params, cfg)
    jp = _jax_view(jax_params, dtype)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, (2, 19), np.int32)
    plen = 11
    jprefill = jax.jit(jtfm.prefill, static_argnums=(2, 3, 4))
    jdecode = jax.jit(jtfm.decode_step, static_argnums=(4, 5))
    jl, jc = jprefill(jp, jnp.asarray(toks[:, :plen]), jcfg, None, None)
    before = dict(build.LAUNCHES)
    tl, tc = tfm.prefill(params, torch.from_numpy(toks[:, :plen]), cfg)
    assert dict(build.LAUNCHES) == before  # CPU tensors: the twins, no launch
    assert isinstance(tc["b0"], ssm.MLSTMState) and isinstance(tc["b1"], ssm.SLSTMState)
    assert tuple(tc["b1"].m.shape) == (cfg.num_periods, 2, cfg.d_model)
    _close(tl, jl, TOL[dtype], "prefill logits")
    if dtype == "float32":
        # In bf16 the states carry the exponential gates' sensitivity to a
        # one-step difference in a bf16 pre-activation (up to ~8 % in c at
        # this size), so bf16 is held on its logits only.
        for name in ("b0", "b1"):
            for got, want in zip(tc[name], jc[name]):
                _close(got, want, TOL[dtype], f"{name} prefill state")
    for t in range(plen, plen + 8):
        tok, pos = toks[:, t:t + 1], np.full((2,), t, np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.asarray(pos), jcfg, None)
        tl, tc = tfm.decode_step(params, tc, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        _close(tl, jl, DECODE_TOL[dtype], f"decode logits at {t}")


def test_prefill_then_decode_matches_forward_train(jax_params):
    """The port's own consistency check, as the reference's serving test:
    prefill + step-by-step decode == the teacher-forced pass (f32)."""
    _, cfg = _cfgs("float32")
    params = _port_params(jax_params, cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, cfg.vocab_size, (1, 13), np.int32))
    full, _ = tfm.forward_train(params, toks, cfg)
    logits, caches = tfm.prefill(params, toks[:, :4], cfg, cache_len=12)
    _close(logits, full[:, 3], TOL["float32"])
    for t in range(4, 12):
        logits, caches = tfm.decode_step(params, caches, toks[:, t:t + 1],
                                         torch.tensor([t], dtype=torch.int32), cfg)
        _close(logits, full[:, t], DECODE_TOL["float32"], f"position {t}")


def test_batcher_token_streams_match_reference(jax_params):
    """7 requests through 3 slots, f32: the port's batcher emits the
    reference batcher's tokens, request by request.  Prompts share one
    length so the reference compiles one prefill; the request lengths
    differ, so slots are refilled at different steps."""
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


def test_write_slot_copies_recurrent_states():
    """``_write_slot`` over MLSTMState/SLSTMState: the slot takes the
    prefill's state, the other slots keep theirs (m = -1e30 included)."""
    _, cfg = _cfgs("float32")
    batched = tfm.init_cache(cfg, 3, 16, device="cpu")
    one = {name: type(c)(*(torch.full_like(t[:, :1], 7.0) for t in c))
           for name, c in batched.items()}
    _write_slot(batched, one, 1)
    for name, c in batched.items():
        for t in c:
            assert bool((t[:, 1] == 7.0).all())
    assert bool((batched["b1"].m[:, [0, 2]] == -1e30).all())
    assert bool((batched["b0"].c[:, [0, 2]] == 0).all())


# ---------------------------------------------------------------------------
# convert, init, config, serving copy, CLI
# ---------------------------------------------------------------------------
def test_convert_round_trip(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    _, cfg = _cfgs("float32")
    model = convert.params_from_numpy(tree, cfg, device="cpu")
    assert tuple(model.layers[1].b1.mixer.r.shape) == (4, 4, 32, 32)
    back = convert.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert back["layers"]["b1"]["mixer"]["r"].shape == (2, 4, 4, 32, 32)
    # bf16: matrices (r included) round as .astype(bfloat16); b and the norms stay f32
    _, cfg16 = _cfgs("bfloat16")
    model16 = convert.params_from_numpy(tree, cfg16, device="cpu")
    mixer = model16.layers[0].b1.mixer
    assert mixer.r.dtype == torch.bfloat16 and mixer.b.dtype == torch.float32
    want16 = jax.tree.map(np.asarray, jax_serving_copy(jax_params))
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(model16)), jax.tree.leaves(want16)):
        np.testing.assert_array_equal(a, b.astype(np.float32))


def test_serving_copy_rounds_r_like_the_reference(jax_params):
    """f32-stored weights served with a bf16 config: the serving copy
    rounds every matrix, the 4-D r included, and keeps b and norms f32."""
    _, cfg16 = _cfgs("bfloat16")
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jax_params), cfg16, device="cpu",
                                      dtype=torch.float32)
    copy = serving_compute_copy(model)
    mixer = copy.layers[1].b1.mixer
    assert mixer.r.dtype == torch.bfloat16 and mixer.b.dtype == torch.float32
    assert copy.layers[1].b0.mixer.norm.dtype == torch.float32
    want = np.asarray(jax_serving_copy(jax_params)["layers"]["b1"]["mixer"]["r"][1], np.float32)
    np.testing.assert_array_equal(mixer.r.float().numpy(), want)


def test_init_rule():
    """r is a plain normal over sqrt(hd) (not the matrices' 1/sqrt(fan_in)
    truncated normal), b zeros, the other matrices the truncated rule."""
    _, cfg = _cfgs("float32")
    model = build_model(cfg, device="cpu").init(0)
    hd = cfg.d_model // cfg.num_heads
    r = torch.cat([p.b1.mixer.r.reshape(-1) for p in model.layers]) * hd ** 0.5
    # 32,768 unit-scale draws: the sample std is within 3 % of 1 (20 sigma)
    assert abs(float(r.std()) - 1.0) < 0.03 and float(r.abs().max()) > 3.0
    assert all(bool((p.b1.mixer.b == 0).all()) for p in model.layers)
    w = model.layers[0].b0.mixer.w_up * cfg.d_model ** 0.5
    assert float(w.abs().max()) <= 2.0  # truncated at 2 std
    assert bool((model.layers[0].b0.mixer.norm == 1).all())


def test_full_width_config_counts_the_reference_parameters():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff, cfg.vocab_size,
            cfg.block_pattern) == (48, 2048, 4, 0, 50304, ("mlstm", "slstm"))
    model = tfm.Transformer(cfg, dtype=torch.bfloat16, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 2_220_541_952
    h, dk, dv = ssm.mlstm_dims(cfg)
    assert (h, dk, dv) == (4, 512, 1024)


def test_serve_cli_runs_xlstm_on_the_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "5", "--slots", "2",
                    "--prompt-len", "6", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "arch=xlstm-1.3b-smoke" in out and "requests=5 tokens=15" in out
