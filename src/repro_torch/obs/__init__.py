"""Observability — one registry, request tracing, executor cost accounting
(port of ``repro.obs``).

* :mod:`repro_torch.obs.registry` — ``MetricsRegistry`` with counters,
  gauges and log-bucketed latency histograms; one-lock-consistent snapshots.
* :mod:`repro_torch.obs.tracing` — per-request spans through the async
  pipeline (admission → linger → dispatch → device → scatter).
* :mod:`repro_torch.obs.profiling` — exchange rounds, bytes and kernel
  launches of one executor run, counted on the calling thread
  (``ExecutorCost``); the reference's jaxpr walk has no counterpart.
* :mod:`repro_torch.obs.export` — Prometheus-text and JSONL renderers and
  the scrape-side parser.

    from repro_torch.obs import render_prometheus

    print(render_prometheus(server.metrics()))
"""
from repro_torch.obs.export import (
    parse_prometheus,
    render_jsonl,
    render_prometheus,
    write_jsonl,
)
from repro_torch.obs.profiling import (
    COLLECTIVE_PRIMITIVES,
    ExecutorCost,
    profile_executor,
)
from repro_torch.obs.registry import (
    DEFAULT_BOUNDS,
    Counter,
    Gauge,
    Histogram,
    HistogramSnapshot,
    MetricsRegistry,
    RegistrySnapshot,
)
from repro_torch.obs.tracing import PHASES, Trace, Tracer

__all__ = [
    "COLLECTIVE_PRIMITIVES",
    "Counter",
    "DEFAULT_BOUNDS",
    "ExecutorCost",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "MetricsRegistry",
    "PHASES",
    "RegistrySnapshot",
    "Trace",
    "Tracer",
    "parse_prometheus",
    "profile_executor",
    "render_jsonl",
    "render_prometheus",
    "write_jsonl",
]
