"""Training on one card, held against the JAX package on the CPU.

The reference's f32 weights of the smoke qwen3-4b and xlstm-1.3b configs
(4 layers, d_model 128) are carried across with ``convert.params_from_numpy``
and made trainable; token ids come from numpy with a seed.  The port's
attention runs kernel 6's ``FlashAttention`` (its plain twin forward on the
CPU, the plain twin's gradient) and its sLSTM kernel 7's ``SlstmSequence``;
the reference differentiates its einsum attention and its scan.

Tolerances:
* loss and ce: 1e-4 relative; each gradient leaf: max |port - reference| at
  most 1e-3 of the leaf's largest |reference| entry (the same f32
  arithmetic summed in another order; the port adds the sLSTM bias before
  the recurrent product, the reference after it);
* AdamW, clip, the schedules and error feedback on the same numpy trees:
  bit for bit where the arithmetic is the same (the moments, the
  quantization), else 1e-6 relative (``pow`` and ``cos`` of XLA and of
  PyTorch, a norm summed in another leaf order);
* one train step at microbatches 1 and 2: the metrics at 1e-4 relative, the
  moments at 1e-3 of each leaf's scale and the parameters within 1e-2 of
  the learning rate where the reference's gradient is at least 1e-4 of its
  leaf's largest (AdamW's first step moves a weight by lr g / (|g| + eps),
  whose direction rounding decides where g is near 0; there within 2 lr).
  The reference also decays the per-layer norm vectors (stacked over
  periods they are 2-D); the port decays matrices only, and the check
  undoes that decay.

The reference's ``test_optim.py``, ``test_checkpoint.py`` and
``test_trainer_integration.py`` cases follow, rewritten for the port.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.distributed.parallel import single_device_parallel as jax_single
from repro.models.api import build_model as jax_build_model
from repro.train import TrainStepConfig as JaxTrainStepConfig
from repro.train import make_train_step as jax_make_train_step
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_smoke_config
from repro_torch.data import ShardedLoader, SyntheticCorpus
from repro_torch.distributed.parallel import AbstractMesh, ParallelConfig, single_device_parallel
from repro_torch.launch import train as train_cli
from repro_torch.models import convert, transformer
from repro_torch.models.api import build_model
from repro_torch.train import (SimulatedFailure, Trainer, TrainerConfig, TrainStepConfig,
                               make_train_state, make_train_step)
from repro_torch.utils import named_leaves, tree_global_norm, tree_param_count, tree_size_bytes
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

ARCHS = ["qwen3_4b", "xlstm_1_3b"]
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3  # of each leaf's largest reference entry
SEQ, BATCH = 32, 4


def _tokens(vocab: int, seed: int = 0, batch: int = BATCH) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (batch, SEQ + 1), dtype=np.int32)


def _flat(tree: dict, num_periods: int) -> dict:
    """A reference pytree by the port's parameter names (periods unstacked)."""
    out = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{name}.{k}" if name else k)
            return
        arr = np.asarray(node, np.float32)
        if name.startswith("layers."):
            for i in range(num_periods):
                out[f"layers.{i}.{name[len('layers.'):]}"] = arr[i]
        else:
            out[name] = arr

    walk(tree, "")
    return out


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's f32 weights, a token batch and its loss,
    metrics and gradients (one ``value_and_grad`` a config)."""
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        bundle = jax_build_model(jcfg, jax_single())
        params = bundle.init(jax.random.key(1))
        toks = _tokens(jcfg.vocab_size)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(bundle.loss, has_aux=True))(
            params, {"tokens": jnp.asarray(toks)})
        out[arch] = dict(params=jax.tree.map(np.asarray, params), tokens=toks,
                         loss=float(loss), ce=float(metrics["ce"]),
                         grads=_flat(grads, jcfg.num_periods))
    return out


def _port(arch: str, params: dict, **cfg_kw):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **cfg_kw)
    model = convert.params_from_numpy(params, cfg, device="cpu", dtype=torch.float32)
    return cfg, transformer.trainable_params(model)


def _close_leaf(got, want, name):
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= GRAD_TOL * scale, f"{name}: max |diff| {err} > {GRAD_TOL} x {scale}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, reference):
    ref = reference[arch]
    cfg, model = _port(arch, ref["params"])
    loss, metrics = transformer.loss_fn(model, {"tokens": torch.from_numpy(ref["tokens"])}, cfg)
    assert loss.item() == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    assert float(metrics["ce"]) == pytest.approx(ref["ce"], rel=LOSS_RTOL)
    assert float(metrics["moe_aux"]) == 0.0
    loss.backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(ref["grads"])
    for name, want in ref["grads"].items():
        _close_leaf(got[name], want, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_plain_attention_give_the_same_gradients(arch, reference):
    """Remat recomputes each period in the backward pass and changes no
    gradient; the plain attention path (the reference's training
    semantics) and the kernel-backed ``FlashAttention`` agree on the CPU."""
    ref = reference[arch]
    toks = torch.from_numpy(ref["tokens"])
    runs = {}
    for label, remat, impl in (("remat", True, "flash"), ("whole", False, "flash"),
                               ("plain", True, "plain")):
        cfg, model = _port(arch, ref["params"], attention_impl=impl)
        loss, _ = transformer.loss_fn(model, {"tokens": toks}, cfg, remat=remat)
        loss.backward()
        runs[label] = (float(loss), {n: p.grad.clone() for n, p in model.named_parameters()})
    for label in ("whole", "plain"):
        assert runs[label][0] == runs["remat"][0]
        for n, g in runs["remat"][1].items():
            assert torch.equal(runs[label][1][n], g), (label, n)


def test_cross_entropy_matches_reference():
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7), dtype=np.int32)
    mask = rng.random((3, 7)) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        want = jlayers.softmax_cross_entropy_logits(
            jnp.asarray(logits), jnp.asarray(labels), None if m is None else jnp.asarray(m))
        got = layers.softmax_cross_entropy_logits(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)


# ---------------------------------------------------------------------------
# optimizer pieces against the reference, on the same numpy trees
# ---------------------------------------------------------------------------
def _trees(seed: int = 0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    return params, grads


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype):
    params, grads = _trees()
    jcfg = joptim.AdamWConfig(moment_dtype=moment_dtype)
    cfg = optim.AdamWConfig(moment_dtype=moment_dtype)
    jp, js = jax.tree.map(jnp.asarray, params), joptim.adamw_init(params, jcfg)
    pp = _t(params)
    ps = optim.adamw_init(pp, cfg)
    for g in grads:
        jp, js = joptim.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jnp.float32(3e-3), jcfg)
        pp, ps = optim.adamw_update(pp, _t(g), ps, torch.tensor(3e-3), cfg)
    assert int(ps["step"]) == int(js["step"]) == 3
    for k in params:
        for mom in ("m", "v"):  # the same arithmetic: bit for bit
            np.testing.assert_array_equal(ps[mom][k].float().numpy(),
                                          np.asarray(js[mom][k], np.float32))
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_clip_and_tree_helpers_match_reference():
    from repro.utils import treeutil

    _, grads = _trees(1)
    g = grads[0]
    assert tree_param_count(_t(g)) == treeutil.tree_param_count(g) == 35
    assert tree_size_bytes(_t(g)) == treeutil.tree_size_bytes(g) == 140
    assert float(tree_global_norm(_t(g))) == pytest.approx(
        float(treeutil.tree_global_norm(jax.tree.map(jnp.asarray, g))), rel=1e-6)
    for cap in (1.0, 1e9):
        got, norm = optim.clip_by_global_norm(_t(g), cap)
        want, jnorm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), cap)
        assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7)


def test_schedules_match_reference():
    for fn, jfn, kw in ((optim.warmup_cosine, joptim.warmup_cosine, {"floor": 0.1}),
                        (optim.warmup_linear, joptim.warmup_linear, {})):
        for step in (0, 1, 5, 10, 11, 55, 99, 100, 140):
            got = float(fn(torch.tensor(step, dtype=torch.int32), peak_lr=3e-4,
                           warmup_steps=10, total_steps=100, **kw))
            want = float(jfn(jnp.int32(step), peak_lr=3e-4, warmup_steps=10,
                             total_steps=100, **kw))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (fn.__name__, step)


def test_error_feedback_matches_reference():
    _, grads = _trees(2)
    jerr = {k: jnp.zeros(v.shape, jnp.bfloat16) for k, v in grads[0].items()}
    err = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in grads[0].items()}
    for g in grads:
        jsent, jerr = joptim.error_feedback_compress(jax.tree.map(jnp.asarray, g), jerr)
        sent, err = optim.error_feedback_compress(_t(g), err)
        for k in g:
            np.testing.assert_array_equal(sent[k].numpy(), np.asarray(jsent[k]))
            np.testing.assert_array_equal(err[k].float().numpy(), np.asarray(jerr[k], np.float32))
    q, s = optim.quantize_int8(torch.from_numpy(grads[0]["w"]))
    jq, js = joptim.quantize_int8(jnp.asarray(grads[0]["w"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


@pytest.mark.parametrize("k", [1, 2])
def test_train_step_matches_reference(k, reference):
    ref = reference["qwen3_4b"]
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_4b"), dtype="float32")
    jbundle = jax_build_model(jcfg, dataclasses.replace(jax_single(), microbatches=k))
    jt = JaxTrainStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    params = jax.tree.map(jnp.asarray, ref["params"])
    state = joptim.adamw_init(params, jt.adamw)
    jp, js, jm = jax.jit(jax_make_train_step(jbundle, jt))(
        params, state, {"tokens": jnp.asarray(ref["tokens"])})

    cfg, model = _port("qwen3_4b", ref["params"])
    bundle = build_model(cfg, dataclasses.replace(single_device_parallel(), microbatches=k),
                         device="cpu")
    tcfg = TrainStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    opt = optim.adamw_init(model, tcfg.adamw)
    model, opt, metrics = make_train_step(bundle, tcfg)(
        model, opt, {"tokens": torch.from_numpy(ref["tokens"])})
    for name in ("loss", "ce", "grad_norm", "lr", "tokens"):
        assert float(metrics[name]) == pytest.approx(float(jm[name]), rel=LOSS_RTOL), name
    assert int(opt["step"]) == 1
    want_p = _flat(jp, cfg.num_periods)
    lr = float(jm["lr"])
    for mom in ("m", "v"):
        want = _flat(js[mom], cfg.num_periods)
        for n, t in opt[mom].items():
            _close_leaf(t.numpy(), want[n], f"{mom}.{n}")
    before = _flat(ref["params"], cfg.num_periods)
    grads = _flat(js["m"], cfg.num_periods)  # m = (1 - b1) g after one step
    wd = tcfg.adamw.weight_decay
    for n, p in model.named_parameters():
        want = want_p[n]
        if p.ndim == 1 and n.startswith("layers."):
            # The reference decays the per-layer norm vectors: stacked over
            # periods they are 2-D to its ``ndim >= 2`` rule.  The port
            # decays matrices only; undo that decay here.
            want = want + lr * wd * before[n]
        err = np.abs(p.detach().numpy() - want)
        # AdamW's first step moves a weight by lr * g / (|g| + eps): where
        # |g| is within rounding of 0 the direction is not determined.
        settled = np.abs(grads[n]) >= 1e-4 * np.abs(grads[n]).max()
        assert float(err[settled].max(initial=0.0)) <= 1e-2 * lr, n
        assert float(err.max()) <= 2 * lr, n


def test_attention_only_stack_train_step_matches_reference():
    """One train step of a ``d_ff == 0`` attention stack (no MLP) against the
    reference's, at :func:`test_train_step_matches_reference`'s tolerances."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_4b"), dtype="float32", d_ff=0)
    jbundle = jax_build_model(jcfg, jax_single())
    params = jbundle.init(jax.random.key(2))
    toks = _tokens(jcfg.vocab_size, seed=3)
    jt = JaxTrainStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jp, js, jm = jax.jit(jax_make_train_step(jbundle, jt))(
        params, joptim.adamw_init(params, jt.adamw), {"tokens": jnp.asarray(toks)})
    ref = jax.tree.map(np.asarray, params)
    cfg, model = _port("qwen3_4b", ref, d_ff=0)
    assert not any(".mlp." in n or n.endswith("norm2") for n, _ in model.named_parameters())
    bundle = build_model(cfg, single_device_parallel(), device="cpu")
    tcfg = TrainStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    opt = optim.adamw_init(model, tcfg.adamw)
    model, opt, metrics = make_train_step(bundle, tcfg)(model, opt,
                                                        {"tokens": torch.from_numpy(toks)})
    for name in ("loss", "ce", "grad_norm"):
        assert float(metrics[name]) == pytest.approx(float(jm[name]), rel=LOSS_RTOL), name
    for n, t in opt["m"].items():
        _close_leaf(t.numpy(), _flat(js["m"], cfg.num_periods)[n], f"m.{n}")
    want_p, before = _flat(jp, cfg.num_periods), _flat(ref, cfg.num_periods)
    lr, wd = float(jm["lr"]), tcfg.adamw.weight_decay
    for n, p in model.named_parameters():
        want = want_p[n] + (lr * wd * before[n] if p.ndim == 1 and n.startswith("layers.") else 0)
        assert float(np.abs(p.detach().numpy() - want).max()) <= 2 * lr, n


# ---------------------------------------------------------------------------
# the reference's optimizer, checkpoint and trainer cases, for the port
# ---------------------------------------------------------------------------
def test_adamw_converges_on_quadratic():
    cfg = optim.AdamWConfig(weight_decay=0.0)
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros((3, 1))}
    state = optim.adamw_init(params, cfg)
    for _ in range(300):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(((w[:, 0] - target) ** 2).sum(), [w])
        params, state = optim.adamw_update(params, {"w": g}, state, torch.tensor(0.05), cfg)
    np.testing.assert_allclose(params["w"][:, 0].numpy(), target.numpy(), atol=1e-2)
    assert int(state["step"]) == 300


def test_adamw_bf16_moments_track_f32_and_decay_skips_vectors():
    p32, p16 = {"w": torch.ones((8, 8))}, {"w": torch.ones((8, 8))}
    g = {"w": torch.full((8, 8), 0.1)}
    c32 = optim.AdamWConfig(moment_dtype="float32", weight_decay=0.0)
    c16 = optim.AdamWConfig(moment_dtype="bfloat16", weight_decay=0.0)
    s32, s16 = optim.adamw_init(p32, c32), optim.adamw_init(p16, c16)
    for _ in range(10):
        p32, s32 = optim.adamw_update(p32, g, s32, 0.01, c32)
        p16, s16 = optim.adamw_update(p16, g, s16, 0.01, c16)
    np.testing.assert_allclose(p32["w"].numpy(), p16["w"].numpy(), rtol=0.03, atol=3e-3)
    assert s16["m"]["w"].dtype == torch.bfloat16
    cfg = optim.AdamWConfig(weight_decay=0.5)
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    params, _ = optim.adamw_update(params, zero, optim.adamw_init(params, cfg), 0.1, cfg)
    assert float(params["w"][0, 0]) < 1.0 and float(params["b"][0]) == 1.0


def test_error_feedback_is_lossless_in_aggregate():
    rng = np.random.default_rng(0)
    err = {"w": torch.zeros(32)}
    sent_total, g_total = np.zeros(32), np.zeros(32)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
        sent, err = optim.error_feedback_compress({"w": g}, err)
        sent_total += sent["w"].numpy()
        g_total += g.numpy()
    resid = np.abs(g_total - sent_total)
    np.testing.assert_allclose(resid, np.abs(err["w"].numpy()), atol=1e-5)
    assert resid.max() < 0.05
    # The int8 all-reduce over one rank is the int8 round trip (its
    # requantization's scale within an f32 rounding of the first's).
    from repro_torch.distributed import collectives

    x = torch.from_numpy(rng.standard_normal(37).astype(np.float32))
    torch.testing.assert_close(optim.compressed_psum_int8(x, collectives.SINGLE),
                               optim.dequantize_int8(*optim.quantize_int8(x)), rtol=1e-6, atol=0)


def _ck_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g), "b": torch.zeros((4,)),
                       "h": torch.randn((3,), generator=g).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_checkpoint_round_trip_latest_specific_and_async(tmp_path):
    m = CheckpointManager(str(tmp_path / "a"), async_write=False)
    t = _ck_tree()
    m.save(10, t, extra={"loader_step": 10})
    m.save(12, _ck_tree(3))
    step, got, extra = m.restore(_zeros_like(t), step=10)
    assert step == 10 and extra["loader_step"] == 10
    for n, a in named_leaves(t).items():
        assert torch.equal(named_leaves(got)[n], a), n
    assert m.restore(_zeros_like(t))[0] == 12
    assert not [p for p in os.listdir(tmp_path / "a") if p.endswith(".tmp")]
    m2 = CheckpointManager(str(tmp_path / "b"), async_write=True)
    live = _ck_tree(1)
    for s in (1, 2, 3):
        m2.save(s, live)
        live["params"]["w"].add_(1.0)  # the snapshot was taken at save()
    m2.wait()
    assert m2.all_steps() == [1, 2, 3]
    _, first, _ = m2.restore(_zeros_like(live), step=1)
    assert torch.equal(first["params"]["w"], _ck_tree(1)["params"]["w"])
    m2.close()


def test_checkpoint_retention_mismatch_and_missing(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in range(5):
        m.save(s, _ck_tree(s))
    assert m.all_steps() == [3, 4] and m.latest_step() == 4
    with pytest.raises(ValueError, match="mismatch"):
        m.restore({"different": torch.zeros(3)})
    bad = _zeros_like(_ck_tree())
    bad["params"]["w"] = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="params.w"):
        m.restore(bad)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty"), async_write=False).restore({"x": torch.zeros(1)})


def _mk(microbatches: int = 1, seed: int = 0, arch: str = "qwen3_4b", **parallel_kw):
    cfg = get_smoke_config(arch)
    parallel = dataclasses.replace(single_device_parallel(), microbatches=microbatches,
                                   **parallel_kw)
    bundle = build_model(cfg, parallel, device="cpu")
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=SEQ, seed=seed, device="cpu")
    return bundle, ShardedLoader(corpus, batch_size=BATCH)


def test_loss_decreases_and_stragglers_count():
    bundle, loader = _mk()
    tr = Trainer(bundle, loader, TrainStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=16),
                 TrainerConfig(total_steps=16, log_every=4), log_fn=lambda s: None)
    hist = tr.run()["history"]
    assert [h["step"] for h in hist] == [4, 8, 12, 16]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h[k]) for h in hist for k in ("loss", "grad_norm", "lr"))
    assert hist[0]["tokens"] == BATCH * SEQ and hist[0]["tokens_per_s"] > 0
    tr.straggler_steps, tr._ewma = 0, None
    for _ in range(6):
        tr._track_stragglers(0.1)
    assert tr.straggler_steps == 0
    tr._track_stragglers(1.0)  # 10x the EWMA
    assert tr.straggler_steps == 1


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8-ef"])
def test_crash_restart_resumes_exactly(tmp_path, compress):
    """Run A: 8 steps straight.  Run B: a checkpoint every 3 steps, a crash
    at step 4, a new trainer on the same directory resumes from step 3 and
    reaches run A's final loss and weights bit for bit (the CPU's kernels
    are deterministic)."""
    tcfg = TrainStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=8)

    def trainer(**kw):
        bundle, loader = _mk(seed=11, grad_compression=compress)
        return Trainer(bundle, loader, tcfg, TrainerConfig(total_steps=8, log_every=1, **kw),
                       log_fn=lambda s: None), loader

    tr_a, _ = trainer()
    loss_a = tr_a.run()["history"][-1]["loss"]
    ck = str(tmp_path / "ck")
    tr_b1, _ = trainer(checkpoint_every=3, checkpoint_dir=ck, crash_at_step=4)
    with pytest.raises(SimulatedFailure):
        tr_b1.run()
    tr_b2, loader = trainer(checkpoint_every=3, checkpoint_dir=ck)
    assert tr_b2.step == 3 and loader.state.step == 3
    assert tr_b2.run()["history"][-1]["loss"] == loss_a
    for (n, a), b in zip(tr_a.params.named_parameters(), tr_b2.params.parameters()):
        assert torch.equal(a, b), n
    if compress:
        assert set(tr_b2.opt_state["ef_error"]) == set(tr_a.opt_state["ef_error"])


def test_microbatched_matches_full_batch():
    tcfg = TrainStepConfig(peak_lr=5e-4, warmup_steps=1, total_steps=4)
    losses = {}
    for k in (1, 2):
        bundle, loader = _mk(microbatches=k, seed=3)
        tr = Trainer(bundle, loader, tcfg, TrainerConfig(total_steps=4, log_every=1),
                     log_fn=lambda s: None)
        losses[k] = [h["loss"] for h in tr.run()["history"]]
    np.testing.assert_allclose(losses[1], losses[2], rtol=2e-3, atol=2e-3)


def test_xlstm_trains_through_the_slstm_function():
    bundle, loader = _mk(arch="xlstm_1_3b", seed=5)
    tr = Trainer(bundle, loader, TrainStepConfig(peak_lr=1e-3, warmup_steps=1, total_steps=3),
                 TrainerConfig(total_steps=3, log_every=1), log_fn=lambda s: None)
    hist = tr.run()["history"]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    assert tr.params.layers[0].b1.mixer.r.dtype == torch.float32  # the f32 master


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--smoke", "--steps", "2", "--batch", "2", "--seq", "16"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke_config("qwen3_4b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(args + ["--fake-devices", "4"])  # its ranks too
    out = train_cli.main(args + ["--device", "cpu", "--dedup", "local", "--microbatches", "2",
                                 "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "1"])
    assert out["final_step"] == 2 and len(out["history"]) == 2
    assert CheckpointManager(str(tmp_path), async_write=False).all_steps() == [1, 2]


def test_training_over_a_mesh_raises():
    """Over a mesh of several devices the bundle must be built over the
    process group (its layout bound); one that names a mesh it was not built
    over is refused.  Training over a bound mesh: test_torch_train_procs.py."""
    cfg = get_smoke_config("qwen3_4b")
    mesh = ParallelConfig(mesh=AbstractMesh((2, 2), ("data", "model")))
    bundle = dataclasses.replace(build_model(cfg, device="cpu"), parallel=mesh)
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(bundle, TrainStepConfig())
    with pytest.raises(ValueError, match="mesh"):
        make_train_state(bundle, TrainStepConfig(), 0)


def test_mlstm_gradients_stay_finite_where_the_masked_decay_overflows():
    """A 256-token chunk with forget gates near 0 takes ``logF_t - logF_s``
    far above 88 above the diagonal, where exp overflows: the port masks the
    exponent before exp, so the masked entries carry no 0 * inf into the
    gradient (the forward values are the reference's either way)."""
    cfg = dataclasses.replace(get_smoke_config("xlstm_1_3b"), dtype="float32")
    bundle = build_model(cfg, device="cpu")
    params = bundle.init_train(0)
    with torch.no_grad():
        for name, t in params.named_parameters():
            if name.endswith("w_if"):
                t.mul_(40)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 257),
                                                             dtype=np.int32))
    loss, _ = bundle.loss(params, {"tokens": toks})
    loss.backward()
    assert np.isfinite(loss.item())
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.parameters())
