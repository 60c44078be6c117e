"""Checkpoint manager: atomic, asynchronous, restorable on any device (port
of ``repro.checkpoint.manager``).

Layout (one directory per step)::

    <dir>/step_00000042/
        manifest.json     # leaf paths, shapes, dtypes, step, user extra
        arrays.npz        # one entry per leaf, keyed by manifest index

* **Atomicity**: a step is written into ``step_X.tmp/`` and renamed into
  place last (rename is atomic on POSIX), so a crash mid-write never
  corrupts the latest checkpoint and no tmp directory outlives a save.
* **Asynchrony**: ``save()`` copies every tensor to host memory as numpy
  (the device-to-host copy; a CPU tensor is copied too, so later in-place
  updates cannot reach the snapshot) and hands the write to a thread;
  ``wait()`` drains the queue and re-raises the writer's first error.
* **Any device**: arrays are stored from the host, and ``restore`` copies
  them into the tensors of ``like`` in place, on whatever device those
  live: a checkpoint written from the card restores on the CPU and back.
  ``bfloat16`` tensors, which numpy has no type for, are stored as their
  16-bit patterns and the manifest names their type.
* **Retention**: the newest ``keep`` checkpoints stay; older ones are
  deleted after each successful save.
* **Over a mesh** (``sharding``, a ``distributed.sharding.TreeSharding``):
  every rank calls ``save`` alike, each leaf is gathered whole from the
  ranks' blocks and the group's rank 0 alone writes it, so the layout on
  disk is the unsharded one; ``wait()`` returns on every rank once the
  write has landed.  ``restore`` gives each rank exactly its block of every
  leaf under the sharding it is given, whatever mesh wrote the checkpoint
  (the reference's elastic restore).

A tree is an ``nn.Module`` (its named parameters), a tensor, or a nested
dict of trees (``repro_torch.utils.named_leaves``).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils import named_leaves

# Tensor types numpy has no counterpart for, stored as same-width integers.
_BITS = {torch.bfloat16: torch.int16}
_DTYPES = {str(t).removeprefix("torch."): t for t in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8, torch.uint8,
    torch.int16, torch.int32, torch.int64, torch.bool)}


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.to("cpu", copy=True).numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._sharding = None  # the last save's, whose group wait() joins
        self._thread: Optional[threading.Thread] = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             sharding=None) -> None:
        """Snapshot ``tree`` at ``step``.  Returns once the data is on the
        host; the write happens on the writer thread (``async_write``).
        With ``sharding`` the leaves are the rank's blocks: every rank
        gathers them whole and the group's rank 0 writes."""
        leaves = named_leaves(tree)
        if sharding is not None:
            self._sharding = sharding
            leaves = {name: sharding.whole(name, t.detach()) for name, t in leaves.items()}
            if not sharding.writer:
                return
        host = [_to_host(t) for t in leaves.values()]
        manifest = {
            "step": int(step),
            "paths": list(leaves),
            "shapes": [list(t.shape) for t in leaves.values()],
            "dtypes": [_dtype_name(t) for t in leaves.values()],
            "extra": extra or {},
        }
        if self.async_write:
            self._q.put((step, manifest, host))
        else:
            self._write(step, manifest, host)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write(*item)
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, manifest: dict, host: list) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **{str(i): a for i, a in enumerate(host)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def wait(self) -> None:
        """Drain pending writes; re-raise the first writer error.  After a
        save over a mesh every rank of the group waits here until rank 0's
        write has landed."""
        if self.async_write:
            self._q.join()
        if self._sharding is not None:
            self._sharding.barrier()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        if self._thread is not None:
            self._q.join()
            self._q.put(None)
            self._thread.join()
            self._thread = None

    # -- restore -------------------------------------------------------------
    @torch.no_grad()
    def restore(self, like: Any, step: Optional[int] = None,
                sharding=None) -> tuple[int, Any, dict]:
        """Load a checkpoint (the latest, or ``step``) into the tensors of
        ``like``, in place, on their devices.  Returns ``(step, like,
        extra)``.  Raises ``FileNotFoundError`` without a checkpoint and
        ``ValueError`` when the stored tree's paths, shapes or types differ
        from ``like``'s.  With ``sharding`` ``like`` holds the rank's blocks,
        and each gets its block of the stored whole leaf."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = named_leaves(like)
        paths = list(leaves)
        if manifest["paths"] != paths:
            raise ValueError("checkpoint tree mismatch:\n"
                             f"  stored:  {manifest['paths'][:5]}...\n  wanted: {paths[:5]}...")
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for i, (path, t) in enumerate(leaves.items()):
                shape, dtype = manifest["shapes"][i], manifest["dtypes"][i]
                src = torch.from_numpy(data[str(i)])
                if _DTYPES[dtype] in _BITS:
                    src = src.view(_DTYPES[dtype])
                if sharding is not None:
                    src = sharding.block(path, src)
                    shape = list(src.shape)
                if shape != list(t.shape) or dtype != _dtype_name(t):
                    raise ValueError(f"checkpoint leaf {path}: stored {dtype}{shape}, wanted "
                                     f"{_dtype_name(t)}{list(t.shape)}")
                t.copy_(src)
        return step, like, manifest["extra"]
