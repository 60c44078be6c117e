"""Greedy sequence packing: variable-length documents → fixed-length rows
(a numpy copy of ``repro.data.packing``).

Host-side numpy, shape-static: documents come as a (num_docs, max_doc_len) padded
matrix plus lengths; the packer lays docs head-to-tail into rows of
``seq_len`` and emits a segment-id mask so attention can stay per-document
(segment ids are consumed by the train step as an attention mask when
``pack_attention=True``; the default trainer treats rows as contiguous
streams, the common LM pretraining setup).
"""
from __future__ import annotations

import numpy as np


def pack_documents(
    docs: np.ndarray,  # (D, L) int32, padded with pad_id
    lengths: np.ndarray,  # (D,) int32
    seq_len: int,
    pad_id: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side packing (data pipeline runs on CPU workers in production).

    Returns ``(rows, segment_ids)`` of shape (R, seq_len): token rows and
    1-based per-document segment ids (0 = padding).
    """
    rows, segs = [], []
    cur = np.full((seq_len,), pad_id, np.int32)
    cur_seg = np.zeros((seq_len,), np.int32)
    fill, seg = 0, 0
    for d in range(docs.shape[0]):
        ln = int(lengths[d])
        if ln <= 0:
            continue
        ln = min(ln, seq_len)  # over-long docs are truncated to one row
        if fill + ln > seq_len:
            rows.append(cur)
            segs.append(cur_seg)
            cur = np.full((seq_len,), pad_id, np.int32)
            cur_seg = np.zeros((seq_len,), np.int32)
            fill, seg = 0, 0
        seg += 1
        cur[fill : fill + ln] = docs[d, :ln]
        cur_seg[fill : fill + ln] = seg
        fill += ln
    if fill:
        rows.append(cur)
        segs.append(cur_seg)
    if not rows:
        return (
            np.zeros((0, seq_len), np.int32),
            np.zeros((0, seq_len), np.int32),
        )
    return np.stack(rows), np.stack(segs)


def packing_efficiency(segment_ids: np.ndarray) -> float:
    """Fraction of non-padding tokens in packed rows."""
    if segment_ids.size == 0:
        return 0.0
    return float((segment_ids > 0).mean())
