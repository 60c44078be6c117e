"""Parity of the port's MoE (``models/moe.py``) and its ``swa`` ring caches
with the JAX package, at the smoke configs of mixtral-8x22b (``swa``
blocks, window 32, 4 experts top-2) and grok-1-314b (``attn`` blocks, 4
experts top-2).

Weights are drawn once by the JAX package and carried across with
``repro_torch.models.convert``; activations and token ids come from numpy
with a seed.  On the CPU the port's attention runs kernel 6's plain twin;
the JAX side runs its einsum (``attention_impl="xla"``).

Tolerances (as ``tests/test_torch_lm.py`` states them):
* f32: rtol/atol 2e-4 on logits and layer outputs, 3e-4 on decode logits;
  routing ids and ring positions (``kpos``) exactly; the drops of an
  expert-parallel layer exactly.
* bf16: atol 6e-2, rtol 2e-2 on logits; one bf16 step (2^-7) on a single
  MoE layer's output.  In a bf16 decode a row whose logits leave the
  tolerance must have, at that step and some layer, its router's k-th and
  (k+1)-th probabilities within ``TIE`` = 1e-3 of each other (a tie:
  rounding the layer's input to bf16 in another order moves them by about
  that much, so top-k may pick either expert, and the packages pick
  differently); the row is compared no further.  Measured: a gap of 7.7e-5
  at one step of the 40 flips one row's expert and moves its logits by
  0.90.  The f32 runs compare every step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.distributed.parallel import ParallelConfig as JParallel
from repro.distributed.parallel import single_device_parallel
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.api import build_model as jax_build_model
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro.serve import make_prefill_step as jax_prefill_step
from repro.serve import make_serve_step as jax_serve_step
from repro.utils.compat import shard_map
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import exchange
from repro_torch.models import attention as attn
from repro_torch.models import convert, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.serve import ContinuousBatcher, Request, make_prefill_step, make_serve_step
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=6e-2)}
DECODE_TOL = {"float32": dict(rtol=3e-4, atol=3e-4), "bfloat16": TOL["bfloat16"]}
LAYER_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2**-7, atol=2**-7)}
TIE = 1e-3
ARCHS = ("mixtral_8x22b", "grok_1_314b")
DTYPES = ("float32", "bfloat16")


def _cfgs(arch: str, dtype: str = "float32", **changes):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype, attention_impl="xla",
                               **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **changes)
    return jcfg, cfg


_PARAMS = {}


def _jax_params(arch: str):
    """f32 master weights of the reference, drawn once an arch."""
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        _PARAMS[arch] = jax_build_model(jcfg, single_device_parallel()).init(jax.random.key(0))
    return _PARAMS[arch]


def _both_params(arch: str, dtype: str, cfg):
    jp = _jax_params(arch)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a, jp)
    return jp, params


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype`` (rounded once, by JAX)."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))


class _RouterGaps:
    """The smallest gap between the k-th and (k+1)-th router probability of
    each row over the MoE layers a pass runs."""

    def __init__(self, k: int):
        self.k, self.gap = k, None

    def __enter__(self):
        self._route = moe.route

        def route(router, x2d, cfg):
            r = self._route(router, x2d, cfg)
            top = torch.topk(r.probs, self.k + 1, dim=-1).values
            gap = top[:, self.k - 1] - top[:, self.k]
            self.gap = gap if self.gap is None else torch.minimum(self.gap, gap)
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route
        return False


def _layer(jp, params, layer: int):
    """Layer ``layer``'s MoE in both packages."""
    jm = jax.tree.map(lambda a: a[layer], jp["layers"]["b0"]["mlp"]["moe"])
    return jm, params.layers[layer].b0.mlp.moe


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_route_moe_dense_and_moe_match_reference(dtype):
    jcfg, cfg = _cfgs("mixtral_8x22b", dtype)
    jp, params = _both_params("mixtral_8x22b", dtype, cfg)
    jm, m = _layer(jp, params, 1)
    x_j, x_t = _both(np.random.default_rng(0).standard_normal((2, 13, cfg.d_model)), dtype)
    jw, jids, jaux = jmoe._route(jm, x_j.reshape(-1, cfg.d_model), jcfg)
    w, ids, aux = moe._route(m.router, x_t.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw, LAYER_TOL[dtype], "routing weights")
    _close(aux, jaux, dict(rtol=1e-6, atol=1e-6), "aux")
    jout, jaux = jmoe.moe_dense(jm, x_j, jcfg)
    out, aux = moe.moe_dense(m, x_t, cfg)
    assert out.dtype == x_t.dtype
    _close(out, jout, LAYER_TOL[dtype], "moe_dense")
    _close(aux, jaux, dict(rtol=1e-6, atol=1e-6), "moe_dense aux")
    via, _ = moe.moe(m, x_t, cfg)
    assert torch.equal(via, out)  # one device: the dense path
    every, _ = moe.moe_dense_all(m, x_t, cfg)
    _close(every, jout, LAYER_TOL[dtype], "the all-experts form")


def test_grouped_ffn_computes_only_the_experts_it_holds():
    _, cfg = _cfgs("grok_1_314b")
    _, params = _both_params("grok_1_314b", "float32", cfg)
    m = params.layers[0].b0.mlp.moe
    x = torch.randn(9, cfg.d_model, generator=torch.Generator().manual_seed(1))
    eids = torch.tensor([2, -1, 0, 3, 2, 1, -1, 0, 3])
    stacks = (m.w_gate, m.w_up, m.w_down)
    got = moe.grouped_ffn(x, eids, stacks, {0: 0, 2: 2})
    for i, e in enumerate(eids.tolist()):
        want = moe._expert_ffn(x[i:i + 1], m.w_gate[e], m.w_up[e], m.w_down[e])[0] \
            if e in (0, 2) else torch.zeros(cfg.d_model)
        torch.testing.assert_close(got[i], want, rtol=1e-6, atol=1e-6)
    # a shard's own experts by their index in its block
    block = tuple(w[[1, 3]] for w in stacks)
    torch.testing.assert_close(moe.grouped_ffn(x, eids, block, {1: 0, 3: 1}),
                               moe.grouped_ffn(x, eids, stacks, {1: 1, 3: 3}))


def _reference_ep(jcfg, jm, x: np.ndarray, world: int):
    """The reference's ``moe_ep`` on an Auto-axis mesh of ``world`` fake
    devices, and its drops from ``_ep_body`` under this test's own
    ``shard_map`` (``moe_ep`` discards them)."""
    mesh = jax.make_mesh((world,), ("data",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:world])
    par = JParallel(mesh=mesh, dp_axes=("data",), tp_axis=None, moe_impl="ep")
    xj = jnp.asarray(x)
    out, aux = jax.jit(lambda p, xx: jmoe.moe_ep(p, xx, jcfg, par))(jm, xj)
    b, s, d = x.shape
    cap = moe.ep_capacity(b * s // world, jcfg)

    def body(p, xl):
        _, _, dropped = jmoe._ep_body(p, xl.reshape(-1, d), jcfg, ("data",), cap)
        return dropped

    dropped = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("data")), out_specs=P(),
                                axis_names={"data"}, check_vma=False))(jm, xj)
    return np.asarray(out), float(aux), int(dropped)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_stacked_moe_ep_matches_reference_and_dense(world):
    """EP over ``StackedGroup(world)`` against the reference's EP on a mesh
    of ``world`` devices: 4 experts over 2 ranks (two a rank; with a
    capacity factor of 1.0 a rank's slot of ``cdiv(t·k, E) + 8`` rows holds
    about two thirds of the rows its two experts draw, so it drops), 4 (one
    a rank) and 8 (groups of 4), both at the smoke config's factor of 2.0."""
    jcfg, cfg = _cfgs("mixtral_8x22b", **({"moe_capacity_factor": 1.0} if world == 2 else {}))
    jp, params = _both_params("mixtral_8x22b", "float32", cfg)
    jm, m = _layer(jp, params, 2)
    x = np.random.default_rng(world).standard_normal((8, 12, cfg.d_model)).astype(np.float32)
    want, want_aux, want_dropped = _reference_ep(jcfg, jm, x, world)
    xs = torch.from_numpy(x).reshape(world, -1, cfg.d_model)
    before = exchange.CALLS[moe.LABEL]
    out, aux, dropped = moe.moe_ep(m, xs, cfg)
    assert exchange.CALLS[moe.LABEL] - before == 2  # dispatch and combine
    _close(out.reshape(x.shape), want, TOL["float32"], "moe_ep")
    _close(aux.mean(), want_aux, dict(rtol=1e-6, atol=1e-6), "pmean of the aux")
    assert int(dropped.sum()) == want_dropped
    if world == 2:
        assert want_dropped > 0
    else:
        assert want_dropped == 0  # nothing dropped: EP is the dense layer
        dense, _ = moe.moe_dense(m, torch.from_numpy(x), cfg)
        _close(out.reshape(x.shape), dense, dict(rtol=1e-6, atol=1e-6), "EP against dense")


def test_combine_carries_rows_with_trailing_dims():
    gen = torch.Generator().manual_seed(3)
    rows = torch.randn(3, 10, 5, generator=gen)
    dest = torch.randint(0, 3, (3, 10), generator=gen)
    (got,), route = exchange.dispatch((rows,), dest, 2, fills=(0.0,))
    back = exchange.combine(got * 2, route, fill=-1.0)
    keep = torch.zeros(3, 10, dtype=torch.bool).scatter_(1, route.perm, route.keep)
    assert back.shape == rows.shape and int((~keep).sum()) == int(route.num_dropped.sum()) > 0
    torch.testing.assert_close(back[keep], rows[keep] * 2)
    assert bool((back[~keep] == -1).all())


def test_expert_stacks_are_drawn_per_expert_with_their_fan_in():
    """Each expert's matrix draws with std 1/sqrt(its fan-in) (d for w_gate
    and w_up, d_ff for w_down), as the reference's vmapped ``dense_init``;
    the stack's leading expert axis is not a fan-in."""
    cfg = dataclasses.replace(get_smoke_config("mixtral_8x22b"), dtype="float32", d_model=256,
                              d_ff=512, num_layers=1)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    m = model.layers[0].b0.mlp.moe
    trunc_std = 0.8796  # a standard normal truncated to [-2, 2]
    for w, fan_in in ((m.w_gate, 256), (m.w_up, 256), (m.w_down, 512)):
        for e in range(cfg.num_experts):
            std = float(w[e].std()) * np.sqrt(fan_in)
            assert abs(std - trunc_std) < 0.02, (e, std)
        assert not torch.equal(w[0], w[1])
    assert abs(float(m.router.std()) * np.sqrt(256) - trunc_std) < 0.05


# ---------------------------------------------------------------------------
# the model: ring caches, prefill, decode past the window, the loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_past_the_window_match_reference(arch, dtype):
    """Prefill of 20 tokens into caches of 64, then 40 decode steps: an
    ``swa`` stack's 32-slot rings wrap during decode (positions 20-59)."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp, params = _both_params(arch, dtype, cfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, (2, 61), np.int32)
    plen, cache_len = 20, 64
    jl, jc = jax.jit(jtfm.prefill, static_argnums=(2, 3, 4))(jp, jnp.asarray(toks[:, :plen]),
                                                              jcfg, None, cache_len)
    tl, tc = tfm.prefill(params, torch.from_numpy(toks[:, :plen]), cfg, cache_len=cache_len)
    ring = arch == "mixtral_8x22b"
    assert isinstance(tc["b0"], attn.RingKVCache) == ring
    _close(tl, jl, TOL[dtype], "prefill logits")

    def caches_match(t):
        for field in jc["b0"]._fields:
            want, got = getattr(jc["b0"], field), getattr(tc["b0"], field)
            if field == "kpos":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"kpos at {t}")
            else:
                _close(got, want, TOL[dtype], f"{field} at {t}")

    caches_match(plen)
    step = jax.jit(jtfm.decode_step, static_argnums=(4, 5))
    live = np.ones(2, bool)  # rows not past a router tie (bf16)
    for t in range(plen, plen + 40):
        tok, pos = toks[:, t:t + 1], np.full((2,), t, np.int32)
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.asarray(pos), jcfg, None)
        with _RouterGaps(cfg.experts_per_token) as gaps:
            tl, tc = tfm.decode_step(params, tc, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        if dtype == "bfloat16":
            off = ~np.isclose(_np(tl), np.asarray(jl, np.float32), **DECODE_TOL[dtype]).all(-1)
            for r in np.flatnonzero(off & live):
                assert float(gaps.gap[r]) < TIE, f"row {r} at {t} differs without a router tie"
                live[r] = False
        _close(tl[live], np.asarray(jl)[live], DECODE_TOL[dtype], f"decode logits at {t}")
        if ring and t in (31, 32, 59) and live.all():
            caches_match(t)
    if ring:
        assert int(tc["b0"].kpos.max()) == plen + 39 and int(tc["b0"].kpos.min()) == plen + 8


def test_ring_prefill_longer_than_the_window_matches_reference():
    jcfg, cfg = _cfgs("mixtral_8x22b")
    jp, params = _both_params("mixtral_8x22b", "float32", cfg)
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (1, 45), np.int32)
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks), jcfg, None, 64)
    tl, tc = tfm.prefill(params, torch.from_numpy(toks), cfg, cache_len=64)
    _close(tl, jl, TOL["float32"])
    np.testing.assert_array_equal(tc["b0"].kpos.numpy(), np.asarray(jc["b0"].kpos))
    _close(tc["b0"].k, jc["b0"].k, TOL["float32"])
    slots = np.arange(13, 45) % 32
    np.testing.assert_array_equal(tc["b0"].kpos[0, 0, slots].numpy(), np.arange(13, 45))


def test_ring_width_when_cache_len_is_below_the_window():
    """``cache_len < window``: the ring has ``cache_len`` slots (the
    reference's ``min(window, cache_len)``), decode writes at ``pos %
    window``; a position past ``cache_len`` is clamped to the ring's last
    slot, as the reference's ``dynamic_update_slice`` clamps it."""
    jcfg, cfg = _cfgs("mixtral_8x22b")
    jp, params = _both_params("mixtral_8x22b", "float32", cfg)
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (1, 30), np.int32)
    plen, cache_len = 10, 24
    assert tfm.block_cache_shapes(cfg, "swa", 3, cache_len).kpos[-1] == cache_len
    jl, jc = jax.jit(jtfm.prefill, static_argnums=(2, 3, 4))(
        jp, jnp.asarray(toks[:, :plen]), jcfg, None, cache_len)
    tl, tc = tfm.prefill(params, torch.from_numpy(toks[:, :plen]), cfg, cache_len=cache_len)
    assert tuple(tc["b0"].k.shape)[3] == cache_len
    step = jax.jit(jtfm.decode_step, static_argnums=(4, 5))
    for t in range(plen, cache_len + 2):  # the last two steps write past cache_len
        tok, pos = toks[:, t:t + 1], np.full((1,), t, np.int32)
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.asarray(pos), jcfg, None)
        tl, tc = tfm.decode_step(params, tc, torch.from_numpy(tok), torch.from_numpy(pos), cfg)
        np.testing.assert_array_equal(tc["b0"].kpos.numpy(), np.asarray(jc["b0"].kpos))
        _close(tl, jl, DECODE_TOL["float32"], f"decode logits at {t}")
    assert int(tc["b0"].kpos[0, 0, -1]) == cache_len + 1  # the clamped slot's last writer


def test_ring_decode_attention_matches_reference():
    """The reference's one-token ring decode, on a ring wrapped past its
    window: output and ``kpos`` (written in place in the port)."""
    jcfg, cfg = _cfgs("mixtral_8x22b")
    jp, params = _both_params("mixtral_8x22b", "float32", cfg)
    rng = np.random.default_rng(8)
    w = cfg.sliding_window
    k, v = (rng.standard_normal((2, cfg.num_kv_heads, 40, cfg.head_dim_)).astype(np.float32)
            for _ in range(2))
    jring = jattn.ring_prefill_cache(jnp.asarray(k), jnp.asarray(v), 40, w)
    ring = attn.ring_prefill_cache(torch.from_numpy(k), torch.from_numpy(v), 40, w)
    np.testing.assert_array_equal(ring.kpos.numpy(), np.asarray(jring.kpos))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([40, 41], np.int32)
    jp0 = jax.tree.map(lambda a: a[0], jp["layers"]["b0"]["attn"])
    jout, jring = jattn.ring_decode_attention(jp0, jnp.asarray(x), jcfg, jring, jnp.asarray(pos), w)
    kpos_before = ring.kpos
    out, ring = attn.ring_decode_attention(params.layers[0].b0.attn, torch.from_numpy(x), cfg,
                                           ring, torch.from_numpy(pos), w)
    assert ring.kpos is kpos_before
    _close(out, jout, DECODE_TOL["float32"], "ring decode output")
    np.testing.assert_array_equal(ring.kpos.numpy(), np.asarray(jring.kpos))
    _close(ring.k, jring.k, TOL["float32"], "ring k")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_aux_and_loss_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, params = _both_params(arch, "float32", cfg)
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size, (2, 48), np.int32)
    jl, jaux = jtfm.forward_train(jp, jnp.asarray(toks), jcfg, None)
    tl, aux = tfm.forward_train(params, torch.from_numpy(toks), cfg)
    _close(tl, jl, TOL["float32"], "forward logits")
    _close(aux, jaux, dict(rtol=1e-5, atol=1e-6), "aux")
    assert float(aux) > 0.5
    jloss, jm = jtfm.loss_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    loss, m = tfm.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg)
    for key in ("loss", "ce", "moe_aux"):
        _close(m[key], jm[key], dict(rtol=1e-5, atol=1e-5), key)
    assert m["moe_dropped"].numel() == 0  # no layer took EP
    torch.testing.assert_close(m["loss"], m["ce"] + 0.01 * m["moe_aux"])


def test_loss_gradients_reach_the_router_and_every_expert():
    """The MoE trains on one card: the aux and the CE reach the router and
    the experts through the period's recomputation (remat)."""
    _, cfg = _cfgs("mixtral_8x22b")
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_train(0)
    toks = np.random.default_rng(7).integers(1, cfg.vocab_size, (2, 33), np.int32)
    loss, _ = bundle.loss(params, {"tokens": toks})
    loss.backward()
    m = params.layers[1].b0.mlp.moe
    for w in (m.router, m.w_gate, m.w_up, m.w_down):
        assert w.grad is not None and bool(torch.isfinite(w.grad).all())
        assert float(w.grad.abs().sum()) > 0


def test_batcher_token_streams_match_reference():
    """7 requests through 3 slots of 48, f32, mixtral smoke (32-slot rings):
    the port's batcher emits the reference batcher's tokens; a short prompt
    after a long one in the same slot keeps no position of the slot's last
    sequence (the whole ring, ``kpos`` included, is overwritten)."""
    jcfg, cfg = _cfgs("mixtral_8x22b")
    jp, params = _both_params("mixtral_8x22b", "float32", cfg)
    slots, cache_len = 3, 48
    jb = jax_build_model(jcfg, single_device_parallel())
    bundle = build_model(cfg, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=36, dtype=np.int32) for _ in range(7)]
    jbatcher = JaxBatcher(jp, jb.init_cache(slots, cache_len),
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
    assert len(got) == 7 and got == want
    np.testing.assert_array_equal(batcher.caches["b0"].kpos.numpy(),
                                  np.asarray(jbatcher.caches["b0"].kpos))
    short = rng.integers(1, cfg.vocab_size, size=5, dtype=np.int32)
    batcher.submit(Request(uid=7, prompt=short, max_new_tokens=1))
    batcher.step()  # admitted into slot 0 (a 36-token prompt's ring before it), one decode
    kpos = batcher.caches["b0"].kpos[:, 0].numpy()
    np.testing.assert_array_equal(kpos[:, :6], np.broadcast_to(np.arange(6), (4, 6)))
    assert (kpos[:, 6:] == -1).all()


def test_convert_carries_the_moe_leaves():
    arch = "grok_1_314b"
    tree = jax.tree.map(np.asarray, _jax_params(arch))
    _, cfg = _cfgs(arch)
    model = convert.params_from_numpy(tree, cfg, device="cpu")
    m = model.layers[3].b0.mlp.moe
    assert tuple(m.w_down.shape) == (4, 256, 128) and tuple(m.router.shape) == (128, 4)
    np.testing.assert_array_equal(m.w_up.numpy(), tree["layers"]["b0"]["mlp"]["moe"]["w_up"][3])
    back = convert.params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_full_width_configs_count_their_parameters():
    """mixtral-8x22b: 2.504e9 parameters a layer (experts 2.416e9,
    attention 8.8e7, router 4.9e4) and the 0.40e9-element embedding and
    head; grok-1: 64 layers of 8 experts at d_ff 32768."""
    cfg = get_config("mixtral_8x22b")
    assert (cfg.block_pattern, cfg.sliding_window, cfg.num_experts, cfg.experts_per_token) == \
        (("swa",), 4096, 8, 2)
    model = tfm.Transformer(dataclasses.replace(cfg, num_layers=1), dtype=torch.bfloat16,
                            device="meta")
    layer = sum(p.numel() for n, p in model.named_parameters() if n.startswith("layers."))
    experts = sum(p.numel() for n, p in model.named_parameters() if ".moe.w_" in n)
    assert experts == 3 * 8 * 6144 * 16384 == 2_415_919_104
    # attention 88,080,384, router 49,152, two norms 12,288
    assert layer == experts + 2 * 6144 * (6144 + 1024) + 6144 * 8 + 2 * 6144 == 2_504_060_928
    grok = get_config("grok_1_314b")
    assert (grok.num_layers, grok.d_ff, grok.vocab_size, grok.block_pattern) == \
        (64, 32768, 131072, ("attn",))
