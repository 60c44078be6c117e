"""Deterministic synthetic token corpus (port of ``repro.data.synthetic``).

Batches are a pure function of ``(seed, step)``: the loader can resume at
any step with no replayed state.  The stream is a Zipf-like marginal over
the vocab with injected duplicate documents (rate ``dup_rate``), so the
HashGraph dedup stage has real work.

The tokens are drawn on ``device`` (default: the CUDA card) from a
``torch.Generator`` seeded by ``(seed, step)``.  JAX's threefry streams
cannot be reproduced, so a batch's tokens differ from the reference's; the
transform of the uniforms (:func:`zipf_tokens`) and the duplicate
injection are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# The reference draws its uniforms in [1e-6, 1): the power law stays finite.
UNIFORM_MIN = 1e-6


_M64 = (1 << 64) - 1


def stream_seed(seed: int, step: int) -> int:
    """One generator seed per ``(seed, step)`` pair: the splitmix64
    finalizer of ``seed * golden + step``, so its low 32 bits (all the CPU
    generator reads) change with either input too."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step)) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def zipf_tokens(u: torch.Tensor, alpha: float, vocab_size: int) -> torch.Tensor:
    """The reference's Zipf-like transform of float32 uniforms ``u`` in
    ``[1e-6, 1)``: ``u^(-1/alpha)``, truncated to int32, mod the vocab,
    clipped to it."""
    ranks = torch.pow(u, -1.0 / alpha)
    return torch.clamp(ranks.to(torch.int32) % vocab_size, 0, vocab_size - 1)


def default_device(device) -> torch.device:
    """``device``, or the CUDA card when it is None (raise if there is none)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the data pipeline draws on the CUDA card by default and none is "
                "available; pass device='cpu'"
            )
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    vocab_size: int
    seq_len: int
    seed: int = 0
    dup_rate: float = 0.0  # fraction of documents that clone another doc
    zipf_alpha: float = 1.1
    device: Optional[object] = None

    def __post_init__(self):
        object.__setattr__(self, "device", default_device(self.device))

    def _generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(stream_seed(self.seed, step))

    def batch(self, step: int, batch_size: int) -> torch.Tensor:
        """``(batch, seq_len + 1)`` int32 tokens for ``step`` (labels =
        shift by one), on the corpus's device."""
        g = self._generator(step)
        shape = (batch_size, self.seq_len + 1)
        u = torch.rand(shape, generator=g, device=self.device)
        u = torch.clamp(u * (1.0 - UNIFORM_MIN) + UNIFORM_MIN, min=UNIFORM_MIN)
        toks = zipf_tokens(u, self.zipf_alpha, self.vocab_size)
        del u
        if self.dup_rate > 0.0:
            # Clone row src[i] into row i for a dup_rate fraction of rows.
            src = torch.randint(0, batch_size, (batch_size,), generator=g, device=self.device)
            is_dup = torch.rand(batch_size, generator=g, device=self.device) < self.dup_rate
            toks = torch.where(is_dup[:, None], toks[src], toks)
        return toks
