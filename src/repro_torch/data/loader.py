"""Deterministic loader with O(1) skip and resume (port of
``repro.data.loader``).

``ShardedLoader`` materializes the batch of a step on the corpus's device.
:class:`SyntheticCorpus` batches are pure functions of ``(seed, step)``, so
resuming from a checkpoint is setting the step counter.  With
``dedup="local"`` / ``"distributed"`` each batch goes through the HashGraph
dedup, and duplicate rows are re-drawn from a generator seeded by the step
(not dropped), so the batch keeps its shape.  Placing batches over several
cards (``mesh``) belongs to the several-cards slice and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.data import dedup as dedup_mod
from repro_torch.data.synthetic import SyntheticCorpus, stream_seed

SEVERAL_CARDS_SLICE = "the port's several-cards slice (torch.distributed meshes)"
# The refill stream's seed is the corpus seed with these bits flipped.
REFILL_SEED_XOR = 0x5EED


@dataclasses.dataclass
class LoaderState:
    step: int

    def checkpoint_payload(self) -> dict:
        return {"step": self.step}

    @staticmethod
    def restore(payload: dict) -> "LoaderState":
        return LoaderState(step=int(payload["step"]))


@dataclasses.dataclass
class ShardedLoader:
    corpus: SyntheticCorpus
    batch_size: int
    mesh: Optional[object] = None
    dp_axes: tuple = ("data",)
    dedup: Optional[str] = None  # None | "local" | "distributed"
    dedup_table: Optional[object] = None  # DistributedHashTable for "distributed"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(f"a loader over a mesh belongs to {SEVERAL_CARDS_SLICE}")
        self.state = LoaderState(step=0)

    def next_batch(self) -> dict:
        step = self.state.step
        toks = self.corpus.batch(step, self.batch_size)
        if self.dedup is not None:
            toks = self._dedup(toks, step)
        self.state.step += 1
        return {"tokens": toks}

    def _dedup(self, toks: torch.Tensor, step: int) -> torch.Tensor:
        if self.dedup == "distributed" and self.dedup_table is not None:
            keep = dedup_mod.dedup_mask_distributed(self.dedup_table, toks[:, :-1])
        else:
            keep = dedup_mod.dedup_mask(toks[:, :-1])
        # Re-draw the dropped rows from the step's own stream: static shapes.
        g = torch.Generator(device=toks.device).manual_seed(
            stream_seed(self.corpus.seed ^ REFILL_SEED_XOR, step)
        )
        fresh = torch.randint(0, self.corpus.vocab_size, toks.shape, generator=g,
                              device=toks.device, dtype=torch.int32)
        return torch.where(keep.to(toks.device)[:, None], toks, fresh)

    # -- resume ----------------------------------------------------------------
    def skip_to(self, step: int) -> None:
        """O(1) resume: batches are pure functions of the step index."""
        self.state.step = step
