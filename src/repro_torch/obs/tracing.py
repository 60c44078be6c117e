"""Request tracing — per-phase spans through the async serving pipeline (a
copy of ``repro.obs.tracing``: no name or rendered line differs).

Every ``AsyncFrontend`` submission can carry a :class:`Trace` that is
stamped at each pipeline boundary::

    admission -> linger -> dispatch -> device -> scatter

* **admission** — time spent inside ``submit_query`` getting the request
  into the deadline batcher (backpressure shows up here).
* **linger** — enqueue until the batcher flushed the request's batch
  (fill-triggered or deadline-triggered).
* **dispatch** — snapshot pin + bucket/pad + AOT executor launch.
* **device** — waiting on the batch's CUDA event (the device result).
* **scatter** — host-side de-pad/slice and future resolution.

Phase durations aggregate into one registry histogram family
(``trace_phase_seconds{phase=...}``) plus an end-to-end
``request_latency_seconds``; the most recent completed traces are kept in
a bounded ring (constant memory) and can be dumped as JSONL for offline
timeline inspection.  A disabled tracer (``enabled=False``) costs one
attribute check per request and records nothing.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Optional

from repro_torch.obs.registry import MetricsRegistry

PHASES = ("admission", "linger", "dispatch", "device", "scatter")


class Trace:
    """One request's span: monotonic phase timestamps plus metadata.

    ``t0`` is the submission instant; ``marks[phase]`` is the *end* of that
    phase.  Phases are contiguous, so durations are successive differences.
    """

    __slots__ = ("trace_id", "t0", "marks", "size", "seqno", "bucket")

    def __init__(self, trace_id: int, t0: float, size: int):
        self.trace_id = trace_id
        self.t0 = t0
        self.marks: dict = {}
        self.size = size
        self.seqno = -1
        self.bucket = -1

    def mark(self, phase: str, t: float) -> None:
        self.marks[phase] = t

    def durations(self) -> dict:
        out = {}
        prev = self.t0
        for phase in PHASES:
            t = self.marks.get(phase)
            if t is None:
                continue
            out[phase] = max(0.0, t - prev)
            prev = t
        return out

    @property
    def total(self) -> float:
        last = max(self.marks.values()) if self.marks else self.t0
        return max(0.0, last - self.t0)

    def as_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "size": self.size,
            "seqno": self.seqno,
            "bucket": self.bucket,
            "total_seconds": self.total,
            "phases": self.durations(),
        }


class Tracer:
    """Factory + sink for :class:`Trace` spans, backed by a registry.

    ``start``/``finish`` bracket a request; in between the pipeline stamps
    phase marks directly on the trace object (no tracer lock touched).
    ``finish`` folds the phase durations into the registry histograms and
    appends the trace to the bounded ring.  ``live()`` counts traces
    started but not finished — the CI gate asserts it returns to zero
    after drain (a leak here means a request fell out of the pipeline).
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        ring: int = 256,
        enabled: bool = True,
        clock=time.perf_counter,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.enabled = enabled
        self.clock = clock
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=max(0, ring))
        self._next_id = 0
        self._started = 0
        self._finished = 0
        self._phase_hists = {
            phase: self.registry.histogram(
                "trace_phase_seconds",
                labels={"phase": phase},
                help="Per-phase request latency through the async pipeline.",
            )
            for phase in PHASES
        }
        self._total_hist = self.registry.histogram(
            "request_latency_seconds",
            help="End-to-end submit-to-result latency.",
        )
        self._recorded = self.registry.counter(
            "traces_recorded_total", help="Completed traces folded into histograms."
        )

    def start(self, size: int = 1) -> Optional[Trace]:
        if not self.enabled:
            return None
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self._started += 1
        return Trace(tid, self.clock(), size)

    def finish(self, trace: Optional[Trace]) -> None:
        if trace is None:
            return
        for phase, dur in trace.durations().items():
            self._phase_hists[phase].observe(dur)
        self._total_hist.observe(trace.total)
        self._recorded.inc()
        with self._lock:
            self._finished += 1
            if self._ring.maxlen:
                self._ring.append(trace)

    def abandon(self, trace: Optional[Trace]) -> None:
        """Drop a trace whose request failed — keeps ``live()`` honest
        without polluting the latency histograms with error paths."""
        if trace is None:
            return
        with self._lock:
            self._finished += 1

    def live(self) -> int:
        with self._lock:
            return self._started - self._finished

    def recent(self) -> list:
        """Most recent completed traces, oldest first."""
        with self._lock:
            return list(self._ring)

    def dump_jsonl(self, path: str) -> int:
        """Append the ring's traces to ``path`` as JSONL; returns count."""
        traces = self.recent()
        with open(path, "a") as f:
            for t in traces:
                f.write(json.dumps(t.as_dict(), sort_keys=True) + "\n")
        return len(traces)


__all__ = ["PHASES", "Trace", "Tracer"]
