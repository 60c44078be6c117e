"""Continuous batching over a fixed slot grid (port of ``repro.serve.batcher``).

The engine keeps ``num_slots`` decode lanes hot; finished or empty lanes
are refilled from the request queue between decode steps (prefill writes
the new sequence's KV, or its recurrent state, into the lane's cache
region).  Shapes are static; admission is host-side bookkeeping.  Unlike
the reference, which returns a new cache pytree, the slot write and the
decode step update the batched caches in place (JAX donates those buffers).

Over a mesh the batcher runs unchanged on every rank: its admissions and
argmaxes are host decisions made from logits that are the same bits on
every rank (gathered over tp and dp), and each rank holds its slots of the
caches.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Drives (prefill_fn, decode_fn) over a slot grid.

    ``prefill_fn(params, {"tokens": (1, L)}) -> (logits (1, V), caches_for_one)``
    ``decode_fn(params, caches, token (B, 1), pos (B,)) -> (logits, caches)``

    The batcher owns the batched caches; each prefill's caches are copied
    into slot ``i`` (axis 1 of every cache tensor) by :func:`_write_slot`.
    Greedy decoding (the reference's ``greedy`` flag is always greedy and is
    left out): ``argmax`` takes the first of tied maxima, as ``jnp.argmax``
    does.
    """

    def __init__(
        self,
        params,
        init_caches,
        prefill_fn: Callable,
        decode_fn: Callable,
        num_slots: int,
        eos_id: int = -1,
    ):
        self.params = params
        self.caches = init_caches
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.num_slots = num_slots
        self.eos_id = eos_id
        self.device = _cache_device(init_caches)
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * num_slots
        self.pos = np.zeros((num_slots,), np.int32)
        self.next_token = np.zeros((num_slots,), np.int32)
        self.completed: list[Request] = []

    # -- admission ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.num_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                tokens = torch.as_tensor(np.asarray(req.prompt)[None, :], device=self.device)
                logits, one_cache = self.prefill_fn(self.params, {"tokens": tokens})
                tok = int(torch.argmax(logits[-1] if logits.ndim == 1 else logits[0]))
                req.out_tokens.append(tok)
                _write_slot(self.caches, one_cache, i)
                self.slots[i] = req
                self.pos[i] = len(req.prompt)
                self.next_token[i] = tok

    # -- decode loop --------------------------------------------------------------
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def step(self) -> None:
        """Admit, then decode one token for every live lane."""
        self._admit()
        if self.active() == 0:
            return
        token = torch.as_tensor(self.next_token[:, None], device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.caches = self.decode_fn(self.params, self.caches, token, pos)
        new = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(new[i])
            req.out_tokens.append(tok)
            self.pos[i] += 1
            self.next_token[i] = tok
            if tok == self.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self.completed.append(req)
                self.slots[i] = None

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or self.active()) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed


def _cache_tensors(caches) -> list[torch.Tensor]:
    return [t for c in caches.values() for t in c]


def _cache_device(caches) -> torch.device:
    return _cache_tensors(caches)[0].device


def _write_slot(batched_caches, one_cache, slot: int) -> None:
    """Copy a single-sequence cache into slot ``slot``, in place.

    Cache tensors (every field of a KVCache, RingKVCache, MLSTMState,
    SLSTMState or RGLRUState) are stacks ``(num_periods, B, ...)``: the
    batch dim is axis 1.  The whole slot is overwritten, the entries past
    the new prompt with the prefill cache's zeros; a value is cast to the
    slot's type (an RG-LRU conv tail comes out of prefill in the activation
    type into an f32 slot, as the reference's ``.at[].set`` casts).  A rank's caches over a mesh hold the slots
    ``batched_caches.slots``; another rank writes the others."""
    lo, hi = getattr(batched_caches, "slots", (0, None))
    if slot < lo or (hi is not None and slot >= hi):
        return
    for dst, src in zip(_cache_tensors(batched_caches), _cache_tensors(one_cache)):
        if dst.ndim >= 2:
            dst[:, slot - lo] = src[:, 0]
