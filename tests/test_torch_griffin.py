"""Parity of the port's Griffin stack (``models/rglru.py``, ``local`` ring
caches) with the JAX package at recurrentgemma-9b's smoke config (3 layers,
one period of (rglru, rglru, local), d_model = rnn_width = 128, window 32),
in f32.

Weights are drawn once by the JAX package and carried across with
``repro_torch.models.convert``; activations, states and token ids come from
numpy with a seed.  On the CPU the port's attention runs kernel 6's plain
twin; the JAX side runs its einsum (``attention_impl="xla"``).

Tolerances: the RG-LRU block and its state 1e-5 (the same f32 arithmetic;
the port's log-depth scan adds in another tree than
``jax.lax.associative_scan``); logits 2e-4 and decode logits 3e-4 (the
reference's own ``test_serve`` bounds); ring positions (``kpos``) and the
batcher's token streams exactly; the scan against a step-by-step loop 1e-5
over 300 steps.
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
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.serve import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.serve import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import convert, rglru  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serve import ContinuousBatcher, Request, make_prefill_step, make_serve_step  # noqa: E402
from jax_reference import cheap_reference_compiles  # noqa: E402,F401  (an autouse fixture)

ARCH = "recurrentgemma_9b"
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=3e-4, atol=3e-4)


def _cfgs(**changes):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32", attention_impl="xla",
                               **changes)
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **changes)
    return jcfg, cfg


_PARAMS = {}


def _both_params():
    """The reference's f32 weights (drawn once) and the port's copy."""
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


def test_config_is_the_reference():
    from repro.configs.base import get_config as jax_config
    from repro_torch.configs.base import get_config

    for got, want in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert dataclasses.asdict(got) == dict(dataclasses.asdict(want), attention_impl="flash")
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.pattern_period, cfg.block_pattern.count("rglru"),
            cfg.block_pattern.count("local"), cfg.head_dim_, cfg.local_window) == (
        38, 19, 13, 6, 256, 2048)
    assert not cfg.tie_embeddings


def test_linear_scan_equals_a_step_loop():
    rng = np.random.default_rng(0)
    for s in (1, 2, 3, 64, 300):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 16)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((2, s, 16)).astype(np.float32))
        h0 = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
        want, h = [], h0
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _close(rglru.linear_scan(a, b, h0), torch.stack(want, 1), BLOCK_TOL, f"S={s}")


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_and_decode_step_match_reference(with_state):
    """A block over 37 tokens (from zeros or a given state: h and the conv
    tail), its returned state, then two decode steps from that state."""
    jcfg, cfg = _cfgs()
    jp, params = _both_params()
    jm = jax.tree.map(lambda a: a[0], jp["layers"]["b1"]["mixer"])
    m = params.layers[0].b1.mixer
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    jstate = state = None
    if with_state:
        h = rng.standard_normal((2, cfg.rnn_width)).astype(np.float32)
        conv = rng.standard_normal((2, cfg.conv_width - 1, cfg.rnn_width)).astype(np.float32)
        jstate = jrglru.RGLRUState(jnp.asarray(h), jnp.asarray(conv))
        state = rglru.RGLRUState(torch.from_numpy(h), torch.from_numpy(conv))
    jout, jnew = jrglru.rglru_block(jm, jnp.asarray(x), jcfg, jstate, return_state=True)
    out, new = rglru.rglru_block(m, torch.from_numpy(x), cfg, state, return_state=True)
    _close(out, jout, BLOCK_TOL, "block output")
    _close(new.h, jnew.h, BLOCK_TOL, "h")
    _close(new.conv, jnew.conv, BLOCK_TOL, "conv tail")
    assert new.h.dtype == torch.float32 and new.conv.shape == (2, 3, cfg.rnn_width)
    for t in range(2):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jnew = jrglru.rglru_decode_step(jm, jnp.asarray(xt), jcfg, jnew)
        out, new = rglru.rglru_decode_step(m, torch.from_numpy(xt), cfg, new)
        _close(out, jout, BLOCK_TOL, f"decode {t}")
        _close(new.h, jnew.h, BLOCK_TOL, f"decode h {t}")
        _close(new.conv, jnew.conv, BLOCK_TOL, f"decode conv {t}")


def test_init_state_and_caches_are_the_reference():
    jcfg, cfg = _cfgs()
    jc = jtfm.init_cache(jcfg, 3, 40)
    tc = tfm.init_cache(cfg, 3, 40, device="cpu")
    assert set(jc) == set(tc)
    for name in jc:
        assert type(tc[name]).__name__ == type(jc[name]).__name__
        for a, b in zip(jc[name], tc[name]):
            assert tuple(a.shape) == tuple(b.shape) and np.array_equal(np.asarray(a), _np(b))
            assert b.dtype == {"float32": torch.float32, "int32": torch.int32}[str(a.dtype)]


def test_forward_and_loss_match_reference():
    """64 tokens: every local layer crosses its 32-token window."""
    jcfg, cfg = _cfgs()
    jp, params = _both_params()
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 65), np.int32)
    jl, _ = jtfm.forward_train(jp, jnp.asarray(toks), jcfg, None)
    tl, aux = tfm.forward_train(params, torch.from_numpy(toks), cfg)
    _close(tl, jl, TOL, "forward_train logits")
    assert float(aux) == 0.0
    jloss, jm = jtfm.loss_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg, None)
    loss, m = tfm.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg)
    _close(loss, jloss, dict(rtol=1e-5, atol=1e-5), "loss")
    _close(m["ce"], jm["ce"], dict(rtol=1e-5, atol=1e-5), "ce")


@pytest.mark.parametrize("plen,total", [(4, 12), (40, 48)])
def test_prefill_plus_decode_matches_forward(plen, total):
    """The reference's ``test_serve`` form (prefill 4, decode to 12), and a
    40-token prefill that wraps the 32-slot rings, decoding on past the
    window: prefill and every decode logit against the port's teacher-forced
    pass and the reference's prefill and decode; each ring's ``kpos`` equal
    to the reference's after prefill and after the last step; each RG-LRU
    state finite and equal to the reference's."""
    jcfg, cfg = _cfgs()
    jp, params = _both_params()
    jb = jax_build_model(jcfg, single_device_parallel())
    tb = build_model(cfg, device="cpu")
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (1, total + 1), np.int32)
    full, _ = tfm.forward_train(params, torch.from_numpy(toks), cfg)
    jlog, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks[:, :plen])}, cache_len=total)
    tlog, tc = tb.prefill(params, {"tokens": toks[:, :plen]}, cache_len=total)
    _close(tlog, full[:, plen - 1], TOL, "prefill against forward")
    _close(tlog, jlog, TOL, "prefill against the reference")

    def same_caches(when):
        for name in ("b0", "b1"):
            for field in ("h", "conv"):
                got = getattr(tc[name], field)
                assert bool(torch.isfinite(got).all())
                _close(got, getattr(jc[name], field), BLOCK_TOL, f"{name}.{field} {when}")
        np.testing.assert_array_equal(tc["b2"].kpos.numpy(), np.asarray(jc["b2"].kpos),
                                      err_msg=f"kpos {when}")

    same_caches("after prefill")
    for t in range(plen, total):
        tok, pos = toks[:, t:t + 1], np.full((1,), t, np.int32)
        jlog, jc = jb.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tc = tb.decode_step(params, tc, tok, pos)
        _close(tlog, full[:, t], DECODE_TOL, f"decode {t} against forward")
        _close(tlog, jlog, DECODE_TOL, f"decode {t} against the reference")
    same_caches("after decode")
    width = min(cfg.local_window, total)
    live = tc["b2"].kpos.numpy()[0, 0]
    assert sorted(live.tolist()) == list(range(total - width, total))


def test_batcher_drains_like_the_reference():
    """Seven ragged requests (some longer than the window) through 3 slots:
    the port's and the reference's batchers give the same token streams."""
    jcfg, cfg = _cfgs()
    jp, params = _both_params()
    slots, cache_len = 3, 64
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=n, dtype=np.int32)
               for n in (5, 33, 9, 40, 12, 3, 35)]
    jb = jax_build_model(jcfg, single_device_parallel())
    jbatch = JaxBatcher(jp, jb.init_cache(slots, cache_len), jax_prefill_step(jb, cache_len),
                        jax_serve_step(jb), num_slots=slots)
    tb = build_model(cfg, device="cpu")
    tbatch = ContinuousBatcher(params, tb.init_cache(slots, cache_len),
                               make_prefill_step(tb, cache_len=cache_len), make_serve_step(tb),
                               num_slots=slots)
    for uid, p in enumerate(prompts):
        jbatch.submit(JaxRequest(uid=uid, prompt=p, max_new_tokens=6))
        tbatch.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    want = {r.uid: r.out_tokens for r in jbatch.run_until_drained(max_steps=200)}
    got = {r.uid: r.out_tokens for r in tbatch.run_until_drained(max_steps=200)}
    assert len(got) == len(prompts) and got == want


def test_params_carry_across_and_back():
    jp, params = _both_params()
    tree = jax.tree.map(np.asarray, jp)
    back = convert.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert params.layers[0].b0.mixer.w_a.dtype == torch.float32
    _, cfg16 = _cfgs()
    cfg16 = dataclasses.replace(cfg16, dtype="bfloat16")
    m16 = convert.params_from_numpy(tree, cfg16, device="cpu").layers[0].b0
    assert m16.mixer.w_a.dtype == torch.bfloat16 and m16.mixer.conv_w.dtype == torch.bfloat16
    assert getattr(m16.mixer, "lambda").dtype == torch.float32 and m16.norm2.dtype == torch.float32


def test_init_follows_the_reference_rules():
    """The port's own draw: a = exp(-c softplus(Λ)) in (0.9, 0.999) at r = 1,
    the conv a plain normal over sqrt(conv_width), the biases zeros."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", rnn_width=4096)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    m = model.layers[0].b0.mixer
    a = torch.exp(-8.0 * torch.nn.functional.softplus(getattr(m, "lambda")))
    assert float(a.min()) > 0.9 - 1e-6 and float(a.max()) < 0.999 + 1e-6
    assert abs(float(m.conv_w.std()) * 2.0 - 1.0) < 0.05
    assert not m.conv_b.any() and not m.b_a.any() and not m.b_x.any()
    assert bool((m.norm == 1).all())
