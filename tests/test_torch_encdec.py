"""Parity of the port's encoder-decoder (``models/encdec.py``: whisper-base's
backbone, the stub frontend's frames, cross-attention, sinusoidal
positions, the tanh-GELU MLP) with the JAX package at whisper-base's smoke
config (2 + 2 layers, d_model 64, 4 heads, 64 frames), in f32.

Weights are drawn once by the JAX package and carried across with
``repro_torch.models.convert``; frames and token ids come from numpy with a
seed.  On the CPU the port's self-attention runs kernel 6's plain twin (the
encoder's non-causal, the decoder's causal); the JAX side runs its einsum.

Tolerances: the sinusoidal tables 1e-5 absolute (their f32 timescales are
powers computed by two libraries; sin and cos of the same angles), the
tanh GELU 1e-6 and the MLP over it 1e-5 (its products summed in another
order, outputs up to ~30); the encoder's output and every logit 2e-4, decode logits
3e-4 (the bounds ``tests/test_torch_lm.py`` states for another summation
order in f32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.distributed.parallel import single_device_parallel  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import convert, encdec, layers  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: E402,F401  (an autouse fixture)

ARCH = "whisper_base"
TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)


def _cfgs():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32", attention_impl="xla")
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    return jcfg, cfg


_PARAMS = {}


def _both_params():
    if "jp" not in _PARAMS:
        jcfg, cfg = _cfgs()
        jp = jax_build_model(jcfg, single_device_parallel()).init(jax.random.key(0))
        _PARAMS["jp"] = jp
        _PARAMS["pt"] = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                                  device="cpu")
    return _PARAMS["jp"], _PARAMS["pt"]


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _inputs(cfg, batch: int, seq: int, seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, (batch, seq), np.int32)
    return frames, toks


@pytest.mark.parametrize("length,d", [(64, 64), (1500, 512)])
def test_sinusoidal_tables_match_reference(length, d):
    _close(layers.sinusoidal_positions(length, d), jlayers.sinusoidal_positions(length, d),
           dict(rtol=0, atol=1e-5), "table")
    pos = np.array([0, 7, 63, length - 1], np.int32)
    _close(layers.sinusoidal_at(torch.from_numpy(pos), d),
           jlayers.sinusoidal_at(jnp.asarray(pos), d), dict(rtol=0, atol=1e-5), "at")
    _close(layers.sinusoidal_at(torch.from_numpy(pos), d),
           layers.sinusoidal_positions(length, d)[pos], dict(rtol=0, atol=1e-5), "rows")


def test_gelu_mlp_is_the_tanh_gelu_of_the_reference():
    rng = np.random.default_rng(0)
    x, w_in, b_in, w_out, b_out = (rng.standard_normal(s).astype(np.float32) for s in
                                   ((3, 5, 16), (16, 32), (32,), (32, 16), (16,)))
    want = jlayers.gelu_mlp(*(jnp.asarray(a) for a in (x, w_in, b_in, w_out, b_out)))
    got = layers.gelu_mlp(*(torch.from_numpy(a) for a in (x, w_in, b_in, w_out, b_out)))
    _close(got, want, dict(rtol=1e-5, atol=1e-5))
    # the activation alone: jax.nn.gelu's default is the tanh form, not erf's
    z = np.linspace(-6, 6, 1001, dtype=np.float32)
    tanh = torch.nn.functional.gelu(torch.from_numpy(z), approximate="tanh")
    _close(tanh, jax.nn.gelu(jnp.asarray(z)), dict(rtol=1e-6, atol=1e-6), "tanh GELU")
    erf = torch.nn.functional.gelu(torch.from_numpy(z))
    assert float((erf - tanh).abs().max()) > 1e-4


def test_encode_forward_and_loss_match_reference():
    jcfg, cfg = _cfgs()
    jp, params = _both_params()
    frames, toks = _inputs(cfg, 2, 21, 1)
    _close(encdec.encode(params, torch.from_numpy(frames), cfg),
           jencdec.encode(jp, jnp.asarray(frames), jcfg), TOL, "encode")
    jl = jencdec.forward_train(jp, jnp.asarray(toks), jnp.asarray(frames), jcfg)
    bundle = build_model(cfg, device="cpu")
    tl, aux = bundle.forward_train(params, toks, frames)
    assert tl.shape == (2, 20, cfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl, TOL, "forward_train")
    batch = {"tokens": toks, "frames": frames}
    jloss, jm = jencdec.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, m = bundle.loss(params, batch)
    _close(loss, jloss, dict(rtol=1e-5, atol=1e-5), "loss")
    _close(m["ce"], jm["ce"], dict(rtol=1e-5, atol=1e-5), "ce")


def test_prefill_and_decode_match_reference_and_forward():
    """A batch of 2: prefill of 6 tokens into 16-slot caches, then 8 decode
    steps, each logit against the reference's and the port's teacher-forced
    pass; the caches' cross k/v and self k/v against the reference's."""
    jcfg, cfg = _cfgs()
    jp, params = _both_params()
    frames, toks = _inputs(cfg, 2, 15, 2)
    plen, cache_len = 6, 16
    jb = jax_build_model(jcfg, single_device_parallel())
    tb = build_model(cfg, device="cpu")
    full, _ = tb.forward_train(params, toks, frames)
    jlog, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks[:, :plen]),
                               "frames": jnp.asarray(frames)}, cache_len=cache_len)
    tlog, tc = tb.prefill(params, {"tokens": toks[:, :plen], "frames": frames},
                          cache_len=cache_len)
    _close(tlog, jlog, TOL, "prefill")
    _close(tlog, full[:, plen - 1], TOL, "prefill against forward")
    for name in ("cross_k", "cross_v"):
        assert tc[name].shape == (cfg.num_layers, 2, cfg.num_kv_heads, cfg.frontend_len,
                                  cfg.head_dim_)
        _close(tc[name], jc[name], TOL, name)
    for t in range(plen, toks.shape[1] - 1):
        tok, pos = toks[:, t:t + 1], np.full((2,), t, np.int32)
        jlog, jc = jb.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tc = tb.decode_step(params, tc, tok, pos)
        _close(tlog, jlog, DECODE_TOL, f"decode {t}")
        _close(tlog, full[:, t], DECODE_TOL, f"decode {t} against forward")
    _close(tc["self"].k, jc["self"].k, TOL, "self k")
    _close(tc["self"].v, jc["self"].v, TOL, "self v")


def test_init_cache_and_params_are_the_reference_layout():
    jcfg, cfg = _cfgs()
    jp, params = _both_params()
    jc = jencdec.init_cache(jcfg, 3, 24)
    tc = encdec.init_cache(cfg, 3, 24, device="cpu")
    assert set(tc) == set(jc)
    for a, b in zip(jax.tree.leaves(jc), [tc["cross_k"], tc["cross_v"], *tc["self"]]):
        assert tuple(a.shape) == tuple(b.shape) and not b.any()
    tree = jax.tree.map(np.asarray, jp)
    back = convert.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    m16 = convert.params_from_numpy(tree, cfg16, device="cpu")
    assert m16.dec_layers[1].cross_attn.wq.dtype == torch.bfloat16
    assert m16.enc_layers[0].mlp.b_in.dtype == torch.float32
    with pytest.raises(ValueError, match="enc_layers"):
        bad = dict(tree, enc_layers=jax.tree.map(lambda a: a[:1], tree["enc_layers"]))
        convert.params_from_numpy(bad, cfg, device="cpu")


def test_bf16_serving_copy_runs_and_stays_close():
    """The bf16 serving copy of the same weights (matrices rounded as the
    reference's ``serving_compute_copy``): prefill logits within the bf16
    bounds of ``tests/test_torch_lm.py`` (atol 6e-2, rtol 2e-2) of the
    reference's bf16 prefill."""
    jcfg, cfg = _cfgs()
    jp, _ = _both_params()
    jcfg16, cfg16 = (dataclasses.replace(c, dtype="bfloat16") for c in (jcfg, cfg))
    params16 = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg16, device="cpu")
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a, jp)
    frames, toks = _inputs(cfg, 1, 9, 3)
    jlog, _ = jencdec.prefill(jp16, jnp.asarray(toks), jnp.asarray(frames), jcfg16)
    tlog, _ = build_model(cfg16, device="cpu").prefill(params16, {"tokens": toks,
                                                                  "frames": frames})
    assert tlog.dtype == torch.bfloat16
    _close(tlog, jlog, dict(rtol=2e-2, atol=6e-2), "bf16 prefill")
