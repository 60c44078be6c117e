"""Parity of the port's flash attention (kernel 6's plain twin and its
entry points) with the JAX package.

On the CPU the kernel's wrapper runs its plain twin.  It is held against the
Pallas ``flash_attention_fhsd`` in interpret mode (through
``repro.kernels.ops.flash_attention``) and against the reference oracle
``ref.attention_ref``, on the seven ``ATTN_CASES`` of the JAX package's
kernel tests, in f32 (tolerance 2e-5: the same f32 arithmetic in another
summation order, as the JAX tests allow) and bf16 (2e-2: outputs rounded to
8 significant bits, where a different f32 sum can land one bf16 step away,
the JAX tests' bf16 tolerance).  The port's own oracle
``repro_torch.kernels.ref.attention_ref`` is checked against the JAX one too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ref

# (b, hq, hkv, sq, skv, d, causal, window) — tests/test_kernels.py ATTN_CASES
ATTN_CASES = [
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 128, 128, 64, True, None),  # GQA 2:1
    (1, 4, 1, 256, 256, 32, True, None),  # GQA 4:1 (MQA)
    (1, 2, 2, 128, 128, 64, False, None),  # encoder (full)
    (1, 2, 2, 256, 256, 32, True, 64),  # sliding window
    (1, 2, 1, 1, 384, 64, True, None),  # decode: 1 query vs long cache
    (1, 2, 2, 100, 100, 64, True, None),  # ragged seq
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, dtype):
    b, hq, hkv, sq, skv, d, _, _ = case
    rng = np.random.default_rng(ATTN_CASES.index(case))
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    # The same values on both sides: bf16 inputs are rounded once, by JAX.
    tx = [torch.from_numpy(np.array(a, np.float32)).to(TORCH[dtype]) for a in jx]
    return jx, tx


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_twin_matches_pallas_and_oracle(case, dtype):
    b, hq, hkv, sq, skv, d, causal, window = case
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=64, block_kv=64, interpret=True)
    group = hq // hkv
    oracle = np.stack([
        _np(jref.attention_ref(jq[i], jk[i], jv[i], causal=causal, window=window,
                               q_heads_per_kv=group))
        for i in range(b)
    ])
    before = dict(build.LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert dict(build.LAUNCHES) == before  # CPU tensors take the twin: no launch
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), oracle, atol=tol, rtol=tol)
    for i in range(b):
        mine = ref.attention_ref(q[i], k[i], v[i], causal=causal, window=window,
                                 q_heads_per_kv=group)
        np.testing.assert_allclose(_np(mine), oracle[i], atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 3), (True, 5)])
def test_fully_masked_rows_give_zero(causal, window):
    """Rows with no live key (window 0, or a decode offset past the window)
    come out as 0 in the twin, as in the reference and the TPU kernel."""
    rng = np.random.default_rng(window)
    q = torch.from_numpy(rng.standard_normal((2, 7, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 20, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 20, 32)).astype(np.float32))
    got = flash.flash_attention_fhsd(q, k, v, causal=causal, window=window, q_heads_per_kv=2)
    want = jref.attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(v.numpy()), causal=causal, window=window,
                              q_heads_per_kv=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    dead = ~flash.live_mask(7, 20, causal=causal, window=window, device="cpu").any(dim=1)
    assert torch.equal(got[:, dead], torch.zeros_like(got[:, dead]))


def test_explicit_scale_and_argument_checks():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((4, 9, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(np.float32))
    got = flash.flash_attention_fhsd(q, k, k, scale=0.3, q_heads_per_kv=2)
    want = jref.attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(k.numpy()), scale=0.3, q_heads_per_kv=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="GQA"):
        flash.flash_attention_fhsd(q, k, k, q_heads_per_kv=3)
    with pytest.raises(TypeError):
        flash.flash_attention_fhsd(q.half(), k.half(), k.half(), q_heads_per_kv=2)
    with pytest.raises(ValueError, match="window"):
        flash.flash_attention_fhsd(q, k, k, window=-1, q_heads_per_kv=2)
