"""Kernel 7's plain twin (the sLSTM recurrence) and the port's sLSTM block
against the JAX package, on the CPU.

Inputs come from numpy with a seed and are handed to both packages.  The
JAX side runs the Pallas kernel in interpret mode (``ops.slstm_recurrence``)
and its scan oracle (``ref.slstm_sequence_ref``); the block is held against
``repro.models.ssm.slstm_block`` and ``slstm_decode_step``.

Tolerances (f32 throughout):
* 2e-5 relative and absolute for the recurrence, as the JAX kernel tests
  hold the Pallas kernel to its oracle: the same f32 arithmetic with the
  hd-term dot products summed in another order.
* 3e-5 for the block, the JAX package's own kernel-against-block bound:
  the port folds the bias into the input projection (``pre = x·W + b``,
  then ``pre + h·r``, as the kernel test wires it), the reference's scan
  adds it last (``(x·W + h·r) + b``), an ulp apart per step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax
import jax.numpy as jnp

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import slstm
from repro_torch.models import ssm
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK_TOL = dict(rtol=3e-5, atol=3e-5)
# The JAX kernel tests' shapes: (b, h, s, hd, t_block).
JAX_CASES = [(1, 1, 8, 16, 8), (2, 2, 32, 32, 16), (1, 4, 100, 64, 32), (2, 1, 256, 128, 256)]


def _inputs(b, h, s, hd, seed):
    rng = np.random.default_rng(seed)
    pre = (rng.standard_normal((b, h, s, 4, hd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((h, 4, hd, hd)) / np.sqrt(hd)).astype(np.float32)
    z = np.zeros((b, h, hd), np.float32)
    return pre, r, (z, z, z, np.full((b, h, hd), -1e30, np.float32))


def _close(got, want, tol, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **tol)


def _check_all(pre, r, states, t_block):
    t = [torch.from_numpy(a) for a in (pre, r, *states)]
    before = dict(build.LAUNCHES)
    results = {
        "twin": slstm.slstm_sequence_plain(*t),
        "wrapper": slstm.slstm_sequence(*t),  # a CPU tensor: the twin, no launch
        "ops": ops.slstm_recurrence(*t),
        "port ref": ref.slstm_sequence_ref(*t),
    }
    assert dict(build.LAUNCHES) == before
    j = [jnp.asarray(a) for a in (pre, r, *states)]
    want_pallas = jops.slstm_recurrence(*j, t_block=t_block, interpret=True)
    want_ref = jref.slstm_sequence_ref(*j)
    for name, (hs, fin) in results.items():
        assert hs.shape == pre.shape[:3] + pre.shape[4:]
        for label, (w_hs, w_fin) in (("pallas", want_pallas), ("ref", want_ref)):
            _close(hs, w_hs, KERNEL_TOL, f"{name} hs vs {label}")
            for g, w, s in zip(fin, w_fin, "cnhm"):
                _close(g, w, KERNEL_TOL, f"{name} final {s} vs {label}")


@pytest.mark.parametrize("b,h,s,hd,t_block", JAX_CASES)
def test_twin_matches_pallas_kernel_and_oracle(b, h, s, hd, t_block):
    pre, r, states = _inputs(b, h, s, hd, b * 1000 + s)
    _check_all(pre, r, states, t_block)


def test_twin_from_nonzero_states_with_ragged_length():
    """Initial states reached after 7 steps of other inputs (non-zero, m
    finite), and S = 45 with t_block 16: the Pallas kernel pads the time
    axis and must leave the state unchanged on the padding."""
    b, h, s, hd = 2, 3, 45, 32
    pre, r, zero = _inputs(b, h, s, hd, 7)
    prefix = (np.random.default_rng(8).standard_normal((b, h, 7, 4, hd)) * 0.5).astype(np.float32)
    _, fin = jref.slstm_sequence_ref(jnp.asarray(prefix), jnp.asarray(r),
                                     *(jnp.asarray(a) for a in zero))
    states = tuple(np.array(a, np.float32) for a in fin)
    assert np.all(states[3] > -1e29) and np.abs(states[0]).max() > 0
    _check_all(pre, r, states, 16)


def test_bf16_r_is_widened_exactly():
    """A bf16 r gives what its f32 widening gives (the serving copy's r)."""
    pre, r, states = _inputs(2, 2, 20, 32, 5)
    t = [torch.from_numpy(a) for a in (pre, *states)]
    r16 = torch.from_numpy(r).to(torch.bfloat16)
    got = slstm.slstm_sequence(t[0], r16, *t[1:])
    want = slstm.slstm_sequence(t[0], r16.float(), *t[1:])
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(g, w)


def test_strided_pre_and_shape_checks():
    pre, r, states = _inputs(2, 2, 9, 16, 6)
    flat = torch.from_numpy(pre.transpose(0, 2, 3, 1, 4).copy())  # (B, S, 4, H, hd)
    view = flat.permute(0, 3, 1, 2, 4)
    t = [torch.from_numpy(a) for a in (r, *states)]
    got = slstm.slstm_sequence(view, *t)
    want = slstm.slstm_sequence(torch.from_numpy(pre), *t)
    # equal values; PyTorch's CPU exp differs by an ulp between strided and contiguous inputs
    _close(got[0], want[0].numpy(), KERNEL_TOL)
    with pytest.raises(ValueError, match="r"):
        slstm.slstm_sequence(view, t[0][:, :, :8], *t[1:])
    with pytest.raises(TypeError, match="float32"):
        slstm.slstm_sequence(view.double(), *t)
    empty = slstm.slstm_sequence(view[:, :, :0], *t)
    assert empty[0].shape == (2, 2, 0, 16) and torch.equal(empty[1][3], t[4])


# ---------------------------------------------------------------------------
# the card kernel's launch plan and its split product, in plain Python
# ---------------------------------------------------------------------------
PLAN_HDS = (16, 20, 32, 48, 64, 128, 256, 512)


@pytest.mark.parametrize("r_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", PLAN_HDS)
def test_launch_plan_fits_the_card(hd, r_dtype):
    """bf16 r: a cluster of at most 16 blocks whose units cover hd exactly
    here, whose r fragments and reserve fit the register file and whose
    shared memory fits a block; f32 r: the cooperative kernel (at hd = 512
    too: an f32 slice would not fit)."""
    plan = slstm.launch_plan(hd, r_dtype, 1)
    assert plan["cluster"] * plan["units"] == hd
    assert plan["smem_bytes"] <= slstm.MAX_SMEM_OPTIN
    if r_dtype == torch.float32:
        assert plan["variant"] == "cooperative" and plan["threads"] == slstm.COOP_THREADS
        assert plan["units"] in (4, 8, 16)
        return
    assert plan["variant"] == "cluster"
    assert 1 <= plan["cluster"] <= slstm.MAX_CLUSTER and plan["units"] % 4 == 0
    assert plan["threads"] == 8 * plan["units"]  # a warp a 4 units
    assert 16 * plan["k_steps"] >= hd and plan["r_regs"] == 4 * plan["k_steps"]
    assert plan["threads"] * (plan["r_regs"] + slstm.REG_RESERVE) <= slstm.REG_FILE
    warps = slstm._max_warps(plan["k_steps"])  # a power of two that fits the file
    assert plan["threads"] <= 32 * warps
    if plan["cluster"] > 1:  # the smallest cluster: one block fewer would not fit
        fewer = plan["cluster"] - 1
        assert -(-hd // (4 * fewer)) > warps
    if hd == 512:
        assert (plan["cluster"], plan["units"], plan["threads"]) == (16, 32, 256)


def test_launch_plan_batch_slices_and_refusals():
    """Up to 2 rows a cluster for batches of 1-2, 4 above; slices cover the
    batch; an f32 r at hd = 512 takes 32 blocks of 16 units; the cluster
    kernel refuses hd > 512 and every plan hd % 4 != 0."""
    for batch, rows, slices in ((1, 2, 1), (2, 2, 1), (3, 4, 1), (4, 4, 1), (5, 4, 2), (16, 4, 4)):
        plan = slstm.launch_plan(512, torch.bfloat16, batch)
        assert (plan["rows"], plan["slices"]) == (rows, slices)
        assert plan["rows"] * plan["slices"] >= batch
    assert slstm.launch_plan(512, torch.float32, 4)["cluster"] == 32
    # every cluster size the plan picks for hd a multiple of 4 up to 512
    sizes = {slstm.launch_plan(hd, torch.bfloat16, 1)["cluster"] for hd in range(4, 513, 4)}
    assert sizes == {1, 2, 3, 4} | set(range(9, 17))
    for hd in range(4, 513, 4):  # uneven splits still cover hd, short of a whole block
        plan = slstm.launch_plan(hd, torch.bfloat16, 1)
        assert hd <= plan["cluster"] * plan["units"] < hd + plan["units"]
    with pytest.raises(ValueError, match="up to 512"):
        slstm.launch_plan(516, torch.bfloat16, 1)
    with pytest.raises(ValueError, match="multiples of 4"):
        slstm.launch_plan(18, torch.float32, 1)


def _split3(h):
    """The card kernel's three bf16 parts of an f32 tensor (round to nearest even)."""
    hi = h.bfloat16().float()
    mid = (h - hi).bfloat16().float()
    lo = (h - hi - mid).bfloat16().float()
    return hi, mid, lo


def _split_product_sequence(pre, r16, c0, n0, h0, m0):
    """The recurrence with h.r computed as the card kernel does: bf16 r times
    each bf16 part of h, accumulated in f32 (each product exact), the three
    part sums added."""
    rf = r16.float()
    c, n, h, m = c0, n0, h0, m0
    hs = []
    for t in range(pre.shape[2]):
        rec = sum(torch.einsum("bhd,hgde->bhge", part, rf) for part in _split3(h))
        c, n, h, m = slstm._gates(pre[:, :, t] + rec, c, n, m)
        hs.append(h)
    return torch.stack(hs, 2), (c, n, h, m)


def test_split_parts_sum_to_h_exactly():
    rng = np.random.default_rng(21)
    h = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 0.3, rng.uniform(-1, 1, 4096), [0.0, -0.0, 1e-30, -3.5e-20, 1.0]
    ]).astype(np.float32))
    hi, mid, lo = _split3(h)
    assert torch.equal((hi + mid) + lo, h)
    for part in (hi, mid, lo):
        assert torch.equal(part, part.bfloat16().float())


@pytest.mark.parametrize("b,h,s,hd,t_block", JAX_CASES)
def test_split_product_matches_twin_and_pallas_kernel(b, h, s, hd, t_block):
    """The numeric premise of the card kernel's bf16 path: the split product
    agrees with the twin and with the Pallas kernel (interpret mode) on the
    bf16 widening of r, within KERNEL_TOL."""
    pre, r, states = _inputs(b, h, s, hd, b * 1000 + s + 7)
    r16 = torch.from_numpy(r).bfloat16()
    t = [torch.from_numpy(a) for a in (pre, *states)]
    got_hs, got_fin = _split_product_sequence(t[0], r16, *t[1:])
    twin_hs, twin_fin = slstm.slstm_sequence_plain(t[0], r16, *t[1:])
    rw = np.asarray(r16.float().numpy())
    j = [jnp.asarray(a) for a in (pre, rw, *states)]
    want_hs, want_fin = jops.slstm_recurrence(*j, t_block=t_block, interpret=True)
    for label, (w_hs, w_fin) in (("twin", (twin_hs, twin_fin)), ("pallas", (want_hs, want_fin))):
        _close(got_hs, w_hs, KERNEL_TOL, f"split hs vs {label}")
        for g, w, name in zip(got_fin, w_fin, "cnhm"):
            _close(g, w, KERNEL_TOL, f"split final {name} vs {label}")


def test_split_product_at_full_width_matches_twin():
    """hd = 512 (the xlstm-1.3b head), 16 steps from warm states."""
    b, h, s, hd = 1, 4, 16, 512
    pre, r, zero = _inputs(b, h, s, hd, 31)
    r16 = torch.from_numpy(r).bfloat16()
    prefix = torch.from_numpy((np.random.default_rng(32).standard_normal((b, h, 5, 4, hd)) * 0.5)
                              .astype(np.float32))
    _, states = slstm.slstm_sequence_plain(prefix, r16, *(torch.from_numpy(a) for a in zero))
    got = _split_product_sequence(torch.from_numpy(pre), r16, *states)
    want = slstm.slstm_sequence_plain(torch.from_numpy(pre), r16, *states)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        _close(g, w.numpy(), KERNEL_TOL)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def _block_params(seed):
    jcfg = dataclasses.replace(jax_smoke_config("xlstm_1_3b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("xlstm_1_3b"), dtype="float32")
    jp = jssm.init_slstm(jax.random.key(seed), jcfg)
    # a non-zero bias, so its place in the sum is exercised
    jp["b"] = jnp.asarray(np.random.default_rng(seed).standard_normal(4 * cfg.d_model) * 0.3,
                          jnp.float32)
    p = ssm.SLSTM(cfg, dtype=torch.float32, device="meta")
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()}, assign=True)
    return jcfg, cfg, jp, p


def _state_np(st):
    return [np.asarray(a) for a in st]


def test_slstm_block_and_decode_match_reference():
    jcfg, cfg, jp, p = _block_params(0)
    rng = np.random.default_rng(3)
    b, s, d = 2, 24, cfg.d_model
    x = (rng.standard_normal((b, s, d)) * 0.1).astype(np.float32)
    want, want_st = jssm.slstm_block(jp, jnp.asarray(x), jcfg, return_state=True)
    got, got_st = ssm.slstm_block(p, torch.from_numpy(x), cfg, return_state=True)
    _close(got, want, BLOCK_TOL, "block output")
    for g, w, name in zip(got_st, _state_np(want_st), "cnhm"):
        _close(g, w, BLOCK_TOL, f"block state {name}")
    # the port's own per-step scan (the reference's wiring) agrees as well
    xin = torch.from_numpy(np.asarray(jax.numpy.dot(
        jssm.layers.rmsnorm(jnp.asarray(x), jp["norm"]), jp["w_in"])))
    st = ssm.slstm_init_state(cfg, b, "cpu")
    for t in range(s):
        _, st = ssm._slstm_step(p, cfg, xin[:, t], st)
    for g, w, name in zip(got_st, st, "cnhm"):
        _close(g, w.numpy(), BLOCK_TOL, f"block state {name} vs the step scan")
    # three decode steps from the block's state
    jst, tst = want_st, got_st
    for t in range(3):
        y = (rng.standard_normal((b, 1, d)) * 0.1).astype(np.float32)
        jo, jst = jssm.slstm_decode_step(jp, jnp.asarray(y), jcfg, jst)
        to, tst = ssm.slstm_decode_step(p, torch.from_numpy(y), cfg, tst)
        _close(to, jo, BLOCK_TOL, f"decode output {t}")
        for g, w, name in zip(tst, _state_np(jst), "cnhm"):
            _close(g, w, BLOCK_TOL, f"decode state {name} at step {t}")
