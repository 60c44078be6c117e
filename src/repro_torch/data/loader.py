"""Deterministic loader with O(1) skip and resume (port of
``repro.data.loader``).

``ShardedLoader`` materializes the batch of a step on the corpus's device.
:class:`SyntheticCorpus` batches are pure functions of ``(seed, step)``, so
resuming from a checkpoint is setting the step counter.  With
``dedup="local"`` / ``"distributed"`` each batch goes through the HashGraph
dedup, and duplicate rows are re-drawn from a generator seeded by the step
(not dropped), so the batch keeps its shape.

Over a mesh (``mesh``, a ``DeviceMesh`` or ``AbstractMesh`` over the
process group) every rank draws the same global batch and keeps its rows of
the ``dp_axes`` block, as the reference's ``P(dp_axes, None)`` placement.
``dedup="distributed"`` over a process-group table dedups the global batch
with each rank passing its block of rows to the table and the masks
all-gathered over the table's group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.data import dedup as dedup_mod
from repro_torch.data.synthetic import SyntheticCorpus, stream_seed

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
        self.state = LoaderState(step=0)

    def _rows(self) -> slice:
        """This rank's rows of the global batch."""
        if self.mesh is None:
            return slice(None)
        from repro_torch.distributed import sharding
        from repro_torch.distributed.parallel import mesh_shape

        shape = mesh_shape(self.mesh)
        n = sharding._axis_size(shape, self.dp_axes)
        if self.batch_size % n:
            raise ValueError(f"batch of {self.batch_size} does not divide over {self.dp_axes} "
                             f"({n})")
        return sharding.block_slices((self.batch_size,), (tuple(self.dp_axes),), self.mesh)[0]

    def next_batch(self) -> dict:
        step = self.state.step
        toks = self.corpus.batch(step, self.batch_size)
        if self.dedup is not None:
            toks = self._dedup(toks, step)
        self.state.step += 1
        return {"tokens": toks[self._rows()]}

    def _dedup(self, toks: torch.Tensor, step: int) -> torch.Tensor:
        if self.dedup == "distributed" and self.dedup_table is not None:
            keep = self._distributed_mask(toks[:, :-1])
        else:
            keep = dedup_mod.dedup_mask(toks[:, :-1])
        # Re-draw the dropped rows from the step's own stream: static shapes.
        g = torch.Generator(device=toks.device).manual_seed(
            stream_seed(self.corpus.seed ^ REFILL_SEED_XOR, step)
        )
        fresh = torch.randint(0, self.corpus.vocab_size, toks.shape, generator=g,
                              device=toks.device, dtype=torch.int32)
        return torch.where(keep.to(toks.device)[:, None], toks, fresh)

    def _distributed_mask(self, rows: torch.Tensor) -> torch.Tensor:
        """The global batch's keep-mask through the table: over a process
        group each rank passes its block of rows and the blocks are
        all-gathered."""
        table = self.dedup_table
        group = table.group
        if not getattr(group, "is_process", False):
            return dedup_mod.dedup_mask_distributed(table, rows)
        n = rows.shape[0] // group.size
        mine = dedup_mod.dedup_mask_distributed(table, rows[group.rank * n:(group.rank + 1) * n])
        return group.all_gather(mine[None]).reshape(-1)

    # -- resume ----------------------------------------------------------------
    def skip_to(self, step: int) -> None:
        """O(1) resume: batches are pure functions of the step index."""
        self.state.step = step
