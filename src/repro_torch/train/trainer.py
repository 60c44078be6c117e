"""Fault-tolerant training loop (port of ``repro.train.trainer``), on one
card or over a mesh of ranks.

* **checkpoint/restart**: asynchronous snapshots every
  ``checkpoint_every`` steps; on construction the trainer restores the
  latest checkpoint in its directory, if any, and resumes the loader by its
  step counter (a batch is a pure function of the step, so the resume is
  exact);
* **straggler counting**: each step's wall time (the card synchronized) is
  tracked by an EWMA, and a step slower than ``straggler_factor`` times it
  is counted and logged;
* **failure injection**: ``crash_at_step`` raises :class:`SimulatedFailure`
  before that step, after flushing pending snapshots.

Over a mesh (a bundle built over the process group) every rank runs the
loop alike: the state is the rank's blocks (``make_train_state``), a
checkpoint holds every leaf whole, written by rank 0 (``TreeSharding``),
and restores onto any mesh; a step's wall is the slowest rank's (an
all-reduce of the maximum), so every rank counts the same stragglers.  The
loader gives every rank the global batch.

Each logged step's history entry holds the step's metrics as floats, its
wall ``step_time_s``, ``tokens_per_s`` and, on the card, the peak bytes
allocated during the step (``peak_bytes``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.train.step import (TrainStepConfig, make_train_state, make_train_step, on_mesh,
                                    train_state_specs)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 0  # 0 = off
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    crash_at_step: Optional[int] = None  # failure injection (tests)


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, bundle, loader, tcfg: TrainStepConfig = TrainStepConfig(),
                 run_cfg: TrainerConfig = TrainerConfig(),
                 log_fn: Callable[[str], None] = print):
        self.bundle = bundle
        self.loader = loader
        self.tcfg = tcfg
        self.cfg = run_cfg
        self.log = log_fn
        self.device = bundle.device
        self.step = 0
        self.metrics_history: list[dict] = []
        self.straggler_steps = 0
        self._ewma: Optional[float] = None
        self._ckpt = CheckpointManager(run_cfg.checkpoint_dir) if run_cfg.checkpoint_dir else None
        self._sharding, self._group = None, None
        if on_mesh(bundle):
            from repro_torch.distributed import collectives, sharding

            self._sharding = sharding.TreeSharding(train_state_specs(bundle), bundle.layout)
            self._group = collectives.world()
        self.params, self.opt_state = make_train_state(bundle, tcfg, run_cfg.seed)
        self._step_fn = make_train_step(bundle, tcfg)
        if self._ckpt is not None and self._ckpt.latest_step() is not None:
            self._restore()

    # -- checkpoint / restore ------------------------------------------------
    def _save(self) -> None:
        if self._ckpt is None:
            return
        self._ckpt.save(self.step, {"params": self.params, "opt": self.opt_state},
                        extra={"loader_step": self.loader.state.step}, sharding=self._sharding)

    def _restore(self) -> None:
        step, tree, extra = self._ckpt.restore({"params": self.params, "opt": self.opt_state},
                                               sharding=self._sharding)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = step
        self.loader.skip_to(int(extra.get("loader_step", step)))
        self.log(f"[trainer] restored step {step} from {self.cfg.checkpoint_dir}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- loop ----------------------------------------------------------------
    def run(self) -> dict:
        while self.step < self.cfg.total_steps:
            if self.cfg.crash_at_step is not None and self.step == self.cfg.crash_at_step:
                if self._ckpt is not None:
                    self._ckpt.wait()  # flush pending snapshots, then die mid-training
                raise SimulatedFailure(f"injected failure at step {self.step}")
            batch = self.loader.next_batch()
            self._sync()
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self._sync()
            dt = self._agreed(time.perf_counter() - t0)
            self._track_stragglers(dt)
            self.step += 1
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step_time_s=dt, tokens_per_s=m["tokens"] / dt)
                if self.device.type == "cuda":
                    m["peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
                self.metrics_history.append({"step": self.step, **m})
                self.log(f"[trainer] step {self.step} loss={m['loss']:.4f} "
                         f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} {dt * 1e3:.0f}ms")
            if self.cfg.checkpoint_every and self.step % self.cfg.checkpoint_every == 0:
                self._save()
        if self._ckpt is not None:
            self._save()
            self._ckpt.wait()
        return {"final_step": self.step, "stragglers": self.straggler_steps,
                "history": self.metrics_history}

    def _agreed(self, dt: float) -> float:
        """The step's wall over the group: the slowest rank's."""
        if self._group is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float64, device=self.device)
        return float(self._group.all_reduce(t, op="max"))

    def _track_stragglers(self, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.straggler_steps += 1
            self.log(f"[trainer] straggler step: {dt * 1e3:.0f}ms vs EWMA "
                     f"{self._ewma * 1e3:.0f}ms")
        self._ewma = (1 - self.cfg.ewma_alpha) * self._ewma + self.cfg.ewma_alpha * dt
