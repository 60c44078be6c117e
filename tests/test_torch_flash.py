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
torch.set_num_threads(1)  # one intra-op thread a worker: xdist runs several on the cores

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ref
from jax_reference import cheap_reference_compiles  # noqa: F401  (an autouse fixture)

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


# (d, causal, window) for the projection-view tests: B = 2, GQA 4:1 (8 query
# heads over 2 kv heads), a ragged S = 75; causal, and causal with a window.
VIEW_CASES = [(32, True, None), (32, True, 20), (128, True, None), (128, True, 20)]


def _projection_views(d, dtype, seed):
    """q (B, KV, G, S, d), k/v (B, KV, S, d) as ``_project_qkv`` hands them
    over (permuted views of the (B, S, heads, d) projections), with the same
    values as (B, H, S, D) JAX arrays."""
    b, kv, g, s = 2, 2, 4, 75
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, kv, g, d), (b, s, kv, d), (b, s, kv, d))]
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(TORCH[dtype]) for a in jx)
    q, k, v = tq.permute(0, 2, 3, 1, 4), tk.permute(0, 2, 1, 3), tv.permute(0, 2, 1, 3)
    jq = jnp.transpose(jx[0], (0, 2, 3, 1, 4)).reshape(b, kv * g, s, d)
    jk, jv = (jnp.transpose(a, (0, 2, 1, 3)) for a in jx[1:])
    return (q, k, v), (jq, jk, jv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", VIEW_CASES)
def test_projection_views_match_pallas(case, dtype):
    """``ops.flash_attention`` on the strided views the model hands over,
    into a (B, S, Hq, D) output buffer, against the Pallas kernel in
    interpret mode; and the model's ``_flash_attention`` returning the merged
    (B, S, Hq·D) view of that buffer."""
    from repro_torch.models import attention

    d, causal, window = case
    (q, k, v), (jq, jk, jv) = _projection_views(d, dtype, VIEW_CASES.index(case))
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    pallas = _np(jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                      block_q=64, block_kv=64, interpret=True))
    b, kv, g, s, _ = q.shape
    buf = torch.full((b, s, kv * g, d), float("nan"), dtype=TORCH[dtype])
    got = ops.flash_attention(q.reshape(b, kv * g, s, d), k, v, causal=causal, window=window,
                              out=buf.permute(0, 2, 1, 3))
    assert got.data_ptr() == buf.data_ptr() and got.shape == (b, kv * g, s, d)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(buf.permute(0, 2, 1, 3)), pallas, atol=tol, rtol=tol)
    merged = attention._flash_attention(q, k, v, causal=causal, window=window)
    assert merged.shape == (b, s, kv * g * d) and merged.is_contiguous()
    np.testing.assert_allclose(_np(merged), pallas.transpose(0, 2, 1, 3).reshape(b, s, -1),
                               atol=tol, rtol=tol)


def test_card_strides_takes_views_and_refuses_the_rest():
    """What the card path accepts, checked without a card: the last dim
    contiguous, the other strides multiples of 16 bytes, a 16-byte aligned
    base; a dim of size 1 gets a valid stride whatever its own."""
    buf = torch.zeros((2, 75, 12, 128), dtype=torch.bfloat16)
    q = buf[:, :, :8].permute(0, 2, 1, 3)  # (B, H, S, D) view of a fused projection
    assert flash.card_strides(q, "q") == (75 * 12 * 128, 128, 12 * 128)
    k = buf[:, :, 8:10].permute(0, 2, 1, 3)
    assert flash.card_strides(k, "k") == (75 * 12 * 128, 128, 12 * 128)
    f32 = torch.zeros((3, 5, 32))
    assert flash.card_strides(f32, "q") == (160, 32)
    assert flash.card_strides(f32[None], "q") == (4 * 32, 160, 32)
    assert flash.card_strides(f32[:1, :1], "q") == (4 * 32, 4 * 32)
    with pytest.raises(ValueError, match="contiguous last dim"):
        flash.card_strides(buf[..., ::2], "q")
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash.card_strides(torch.zeros((4, 9, 68), dtype=torch.bfloat16)[..., :64], "k")
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash.card_strides(torch.zeros((4, 9, 34))[..., :32], "v")
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash.card_strides(torch.zeros(4 * 9 * 64 + 4, dtype=torch.bfloat16)[4:].view(4, 9, 64),
                           "q")
