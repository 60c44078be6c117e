"""The port's ``data/`` against the JAX package.

* ``pack_documents`` under the reference's hypothesis property, equal to
  the reference's rows and segment ids.
* ``sequence_fingerprints``, ``dedup_mask`` and ``dedup_mask_distributed``
  (D = 1 and D = 8) equal to the reference's on the same numpy tokens,
  with one row repeated 100 times (past the 64-row run window) and nine
  more cloned 120 times among them.  Tolerance: none.
* ``SyntheticCorpus``'s Zipf transform on the same numpy float32 uniforms
  equal to the reference's formula, exactly (both raise float32 to the same
  power and truncate; the check found no differing bit).  The corpus's own
  uniforms come from a ``torch.Generator``, so its batches are not the
  reference's (JAX's threefry stream cannot be reproduced).
* The corpus and loader properties of ``tests/test_data_pipeline.py``: a
  batch is a pure function of the step, duplicates are injected, resume is
  exact, dedup keeps the shape and leaves every row unique.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis (requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.core.table import DistributedHashTable as JTable
from repro.data import dedup as jdedup
from repro.data.packing import pack_documents as jpack
from repro_torch import DistributedHashTable
from repro_torch.data import (
    LoaderState,
    ShardedLoader,
    SyntheticCorpus,
    dedup_mask,
    dedup_mask_distributed,
    pack_documents,
    sequence_fingerprints,
)
from repro_torch.data.packing import packing_efficiency
from repro_torch.data.synthetic import zipf_tokens
from test_torch_state import _mesh, _np

MESHES = pytest.mark.parametrize("d", [1, 8], ids=["mesh1", "mesh8"])


@settings(max_examples=25, deadline=None)
@given(
    lengths=st.lists(st.integers(0, 40), min_size=1, max_size=30),
    seq_len=st.integers(8, 64),
)
def test_packing_preserves_tokens_and_matches_reference(lengths, seq_len):
    rng = np.random.default_rng(0)
    max_len = max(max(lengths), 1)
    docs = rng.integers(1, 100, size=(len(lengths), max_len)).astype(np.int32)
    lens = np.array(lengths, np.int32)
    rows, segs = pack_documents(docs, lens, seq_len)
    want_rows, want_segs = jpack(docs, lens, seq_len)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(segs, want_segs)
    out_tokens = rows[segs > 0]
    expect = np.concatenate(
        [docs[i, : min(n, seq_len)] for i, n in enumerate(lengths) if n > 0]
    ) if any(n > 0 for n in lengths) else np.array([], np.int32)
    np.testing.assert_array_equal(out_tokens, expect)
    for r in range(rows.shape[0]):
        seg = segs[r][segs[r] > 0]
        if len(seg):
            np.testing.assert_array_equal(np.unique(seg), np.arange(1, len(np.unique(seg)) + 1))
    if rows.size:
        assert 0.0 < packing_efficiency(segs) <= 1.0


def _tokens(rows: int = 512, seq: int = 24):
    """Rows of random tokens with duplicates: row 0 repeated 100 times
    (beyond the 64-row run window), 120 clones of rows 1-9, and five equal
    rows at the end."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 1 << 31, size=(rows, seq), dtype=np.int64).astype(np.int32)
    toks[rng.choice(np.arange(1, rows), 100, replace=False)] = toks[0]
    src = rng.integers(1, 10, 120)
    dst = rng.choice(np.arange(rows), 120, replace=False)
    toks[dst] = toks[src]
    toks[-5:] = 0xFFFF  # five equal rows at the end
    return toks


def test_fingerprints_and_local_dedup_match_reference():
    toks = _tokens()
    fp = sequence_fingerprints(torch.from_numpy(toks))
    np.testing.assert_array_equal(
        _np(fp).view(np.uint32), np.asarray(jdedup.sequence_fingerprints(jnp.asarray(toks))))
    got = _np(dedup_mask(torch.from_numpy(toks)))
    np.testing.assert_array_equal(got, np.asarray(jdedup.dedup_mask(jnp.asarray(toks))))
    _, first = np.unique(toks, axis=0, return_index=True)
    want = np.zeros(len(toks), bool)
    want[first] = True
    np.testing.assert_array_equal(got, want)
    seeded = dedup_mask(torch.from_numpy(toks), seed=77)
    np.testing.assert_array_equal(_np(seeded), np.asarray(jdedup.dedup_mask(jnp.asarray(toks), seed=77)))


@MESHES
def test_distributed_dedup_matches_reference(request, d):
    toks = _tokens()
    jt = JTable(_mesh(request, d), ("d",), hash_range=1 << 12)
    pt = DistributedHashTable(num_shards=d, hash_range=1 << 12, device="cpu")
    got = _np(dedup_mask_distributed(pt, torch.from_numpy(toks)))
    np.testing.assert_array_equal(got, np.asarray(jdedup.dedup_mask_distributed(jt, jnp.asarray(toks))))
    # Below the dispatch slots every duplicate goes: the local mask.
    light = toks[np.r_[0:8, 150:510]]
    light[-16:] = light[:16]
    got = _np(dedup_mask_distributed(pt, torch.from_numpy(light)))
    np.testing.assert_array_equal(got, _np(dedup_mask(torch.from_numpy(light))))


def test_zipf_transform_matches_reference_formula():
    rng = np.random.default_rng(9)
    u = rng.random(1 << 16, dtype=np.float32)
    u = np.maximum(np.float32(1e-6), u * np.float32(1 - 1e-6) + np.float32(1e-6))
    u[:4] = [1e-6, 1.0 - 2**-24, 0.5, 3e-6]
    for alpha, vocab in ((1.1, 151_936), (0.9, 1000), (1.5, 50_304)):
        want = jnp.clip(jnp.power(jnp.asarray(u), -1.0 / alpha).astype(jnp.int32) % vocab,
                        0, vocab - 1)
        got = zipf_tokens(torch.from_numpy(u), alpha, vocab)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_synthetic_batches_are_pure_functions_of_step():
    c = SyntheticCorpus(vocab_size=1000, seq_len=32, seed=5, dup_rate=0.2, device="cpu")
    a = _np(c.batch(7, 16))
    np.testing.assert_array_equal(a, _np(c.batch(7, 16)))
    assert not np.array_equal(a, _np(c.batch(8, 16)))
    assert not np.array_equal(
        a, _np(SyntheticCorpus(1000, 32, seed=6, dup_rate=0.2, device="cpu").batch(7, 16)))
    assert a.shape == (16, 33) and a.dtype == np.int32
    assert a.min() >= 0 and a.max() < 1000


def test_synthetic_dup_rate_injects_duplicates():
    c = SyntheticCorpus(vocab_size=10_000, seq_len=64, seed=1, dup_rate=0.5, device="cpu")
    toks = c.batch(0, 64)
    assert len(np.unique(_np(sequence_fingerprints(toks[:, :-1])))) < 64


def test_corpus_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticCorpus(vocab_size=100, seq_len=8)


def test_loader_resume_is_exact():
    c = SyntheticCorpus(vocab_size=500, seq_len=16, seed=2, device="cpu")
    l1 = ShardedLoader(c, batch_size=4)
    batches = [_np(l1.next_batch()["tokens"]) for _ in range(5)]
    l2 = ShardedLoader(c, batch_size=4)
    l2.skip_to(3)
    np.testing.assert_array_equal(_np(l2.next_batch()["tokens"]), batches[3])
    np.testing.assert_array_equal(_np(l2.next_batch()["tokens"]), batches[4])


@pytest.mark.parametrize("mode", ["local", "distributed"])
def test_loader_dedup_replaces_duplicates_keeps_shape(mode):
    c = SyntheticCorpus(vocab_size=50_000, seq_len=32, seed=3, dup_rate=0.5, device="cpu")
    table = DistributedHashTable(num_shards=8, hash_range=1 << 12, device="cpu")
    loader = ShardedLoader(c, batch_size=32, dedup=mode, dedup_table=table)
    toks = loader.next_batch()["tokens"]
    assert toks.shape == (32, 33)
    assert len(np.unique(_np(sequence_fingerprints(toks[:, :-1])))) == 32
    raw = c.batch(0, 32)
    keep = dedup_mask(raw[:, :-1])
    assert torch.equal(toks[keep], raw[keep]) and int((~keep).sum()) > 0
    assert int(toks.min()) >= 0 and int(toks.max()) < 50_000
    again = ShardedLoader(c, batch_size=32, dedup=mode, dedup_table=table)
    assert torch.equal(again.next_batch()["tokens"], toks)


def test_loader_state_roundtrip():
    s = LoaderState(step=42)
    assert LoaderState.restore(s.checkpoint_payload()).step == 42
