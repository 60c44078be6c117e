"""MetricsRegistry — counters, gauges, and log-bucketed latency histograms (a
copy of ``repro.obs.registry``: no name or rendered line differs).

One registry instance is the single source of truth for every counter the
serving stack keeps.  Design constraints, in order:

* **snapshot-consistent**: every instrument shares the registry's one
  lock, so :meth:`MetricsRegistry.snapshot` is ONE lock acquisition that
  observes all instruments at the same instant — no field-by-field
  tearing.  The stat views (``ServerStats``/``FrontendStats``/
  ``BatcherStats``) are built from one snapshot each.
* **lock-cheap**: instrument updates are a single uncontended-lock
  increment (~100ns under CPython); every update site in the serving
  stack is per-request or per-batch, orders of magnitude above that.
  The registry lock is a *leaf* lock: no instrument ever calls out while
  holding it, so it composes under the server's writer mutex and the
  batchers' condition variables without ordering hazards.
* **quantile readout**: histograms are log-bucketed (geometric bounds,
  ``√2`` spacing by default) with p50/p99/p999 read off the bucket
  cumulative counts via within-bucket linear interpolation — constant
  memory per histogram regardless of observation count.

Instruments are get-or-create by ``(name, labels)``: asking twice returns
the same instrument, so components can re-bind to a shared registry (a
``MicroBatcher`` adopted by a ``TableServer``) without losing counts, and
sequential front ends over one server accumulate into one export stream
(per-instance views subtract a base snapshot).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import threading
from typing import Optional

# Default histogram bounds: geometric, factor sqrt(2), spanning ~1us to
# ~92s — latency-shaped.  Callers measuring non-latency quantities pass
# their own bounds.
_BASE = 1e-6
_FACTOR = math.sqrt(2.0)
DEFAULT_BOUNDS = tuple(_BASE * _FACTOR**i for i in range(54))


def _label_key(labels: Optional[dict]) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter.  ``inc`` under the registry lock; never decreases."""

    __slots__ = ("_lock", "_value", "name", "labels")

    def __init__(self, lock: threading.RLock, name: str, labels: tuple):
        self._lock = lock
        self._value = 0
        self.name = name
        self.labels = labels

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value; ``set``/``add`` under the registry lock."""

    __slots__ = ("_lock", "_value", "name", "labels")

    def __init__(self, lock: threading.RLock, name: str, labels: tuple):
        self._lock = lock
        self._value = 0.0
        self.name = name
        self.labels = labels

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def add(self, v) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self):
        with self._lock:
            return self._value


@dataclasses.dataclass(frozen=True)
class HistogramSnapshot:
    """Immutable histogram readout: totals + bucket counts + quantiles.

    ``bounds[i]`` is the inclusive upper edge of bucket ``i``; the last
    bucket (``counts[-1]``) is the overflow.  Quantiles interpolate
    linearly inside the target bucket, clamped to observed min/max, so a
    histogram that saw one value reports that value at every quantile.
    """

    count: int
    sum: float
    min: float
    max: float
    bounds: tuple
    counts: tuple

    def quantile(self, q: float) -> float:
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (target - seen) / c
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            seen += c
        return self.max

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def p999(self) -> float:
        return self.quantile(0.999)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "p50": self.p50,
            "p99": self.p99,
            "p999": self.p999,
        }


class Histogram:
    """Log-bucketed histogram with constant memory and quantile readout."""

    __slots__ = (
        "_lock", "_bounds", "_counts", "_count", "_sum", "_min", "_max",
        "name", "labels",
    )

    def __init__(
        self,
        lock: threading.RLock,
        name: str,
        labels: tuple,
        bounds: Optional[tuple] = None,
    ):
        self._lock = lock
        self._bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        if list(self._bounds) != sorted(self._bounds):
            raise ValueError("histogram bounds must be sorted ascending")
        self._counts = [0] * (len(self._bounds) + 1)  # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self.name = name
        self.labels = labels

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> HistogramSnapshot:
        return HistogramSnapshot(
            count=self._count,
            sum=self._sum,
            min=self._min if self._count else 0.0,
            max=self._max if self._count else 0.0,
            bounds=self._bounds,
            counts=tuple(self._counts),
        )


@dataclasses.dataclass(frozen=True)
class RegistrySnapshot:
    """One atomic sample of every instrument in a registry.

    ``values`` maps ``(name, labels_tuple)`` to an int/float (counter,
    gauge) or a :class:`HistogramSnapshot`; ``types`` maps metric name to
    ``"counter" | "gauge" | "histogram"``; ``helps`` carries the help
    strings for the exporters.
    """

    values: dict
    types: dict
    helps: dict

    def value(self, name: str, labels: Optional[dict] = None, default=0):
        """The sampled value of one instrument (``default`` if absent)."""
        return self.values.get((name, _label_key(labels)), default)

    def histogram(
        self, name: str, labels: Optional[dict] = None
    ) -> Optional[HistogramSnapshot]:
        v = self.values.get((name, _label_key(labels)))
        return v if isinstance(v, HistogramSnapshot) else None

    def labels_of(self, name: str) -> list:
        """Every label set sampled under ``name`` (list of dicts)."""
        return [
            dict(lk) for (n, lk) in self.values.keys() if n == name
        ]

    def as_dict(self) -> dict:
        """JSON-able view: ``{name: value}`` or ``{name: {label-repr: value}}``."""
        out: dict = {}
        for (name, lk), v in sorted(self.values.items()):
            payload = v.as_dict() if isinstance(v, HistogramSnapshot) else v
            if not lk:
                out[name] = payload
            else:
                key = ",".join(f"{k}={val}" for k, val in lk)
                out.setdefault(name, {})[key] = payload
        return out


class MetricsRegistry:
    """Get-or-create instrument registry with one-lock-consistent snapshots."""

    def __init__(self):
        # RLock: Histogram.snapshot() may be called both standalone and
        # from within registry.snapshot()'s locked section.
        self._lock = threading.RLock()
        self._instruments: dict = {}  # (name, labels_key) -> instrument
        self._types: dict = {}  # name -> "counter"|"gauge"|"histogram"
        self._helps: dict = {}  # name -> help string

    def _get(self, cls, kind: str, name: str, labels, help, **kwargs):
        lk = _label_key(labels)
        with self._lock:
            existing = self._types.get(name)
            if existing is not None and existing != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {existing}, "
                    f"requested {kind}"
                )
            inst = self._instruments.get((name, lk))
            if inst is None:
                inst = cls(self._lock, name, lk, **kwargs)
                self._instruments[(name, lk)] = inst
                self._types[name] = kind
                if help:
                    self._helps[name] = help
            return inst

    def counter(
        self, name: str, labels: Optional[dict] = None, help: Optional[str] = None
    ) -> Counter:
        return self._get(Counter, "counter", name, labels, help)

    def gauge(
        self, name: str, labels: Optional[dict] = None, help: Optional[str] = None
    ) -> Gauge:
        return self._get(Gauge, "gauge", name, labels, help)

    def histogram(
        self,
        name: str,
        labels: Optional[dict] = None,
        help: Optional[str] = None,
        bounds: Optional[tuple] = None,
    ) -> Histogram:
        return self._get(Histogram, "histogram", name, labels, help, bounds=bounds)

    def snapshot(self) -> RegistrySnapshot:
        """All instruments at one instant: a single lock acquisition."""
        with self._lock:
            values = {}
            for key, inst in self._instruments.items():
                if isinstance(inst, Histogram):
                    values[key] = inst._snapshot_locked()
                else:
                    values[key] = inst._value
            return RegistrySnapshot(
                values=values, types=dict(self._types), helps=dict(self._helps)
            )


__all__ = [
    "Counter",
    "DEFAULT_BOUNDS",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "MetricsRegistry",
    "RegistrySnapshot",
]
