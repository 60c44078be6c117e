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
