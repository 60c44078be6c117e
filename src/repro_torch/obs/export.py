"""Exporters — Prometheus text format and JSONL renderers for a registry (a
copy of ``repro.obs.export``: no name or rendered line differs).

Both operate on a :class:`~repro_torch.obs.registry.RegistrySnapshot` (one
consistent sample), never on the live registry, so an export can never
tear across instruments.  :func:`parse_prometheus` is the inverse of
:func:`render_prometheus` for the simple subset emitted here — the CI
smoke gates *scrape* the rendered text and assert on the parsed values,
exercising the same path an external scraper would.
"""
from __future__ import annotations

import json
import math
from typing import Optional, Union

from repro_torch.obs.registry import (
    HistogramSnapshot,
    MetricsRegistry,
    RegistrySnapshot,
)


def _snap(registry_or_snapshot) -> RegistrySnapshot:
    if isinstance(registry_or_snapshot, MetricsRegistry):
        return registry_or_snapshot.snapshot()
    return registry_or_snapshot


def _fmt_labels(lk: tuple, extra: Optional[dict] = None) -> str:
    pairs = [f'{k}="{v}"' for k, v in lk]
    if extra:
        pairs += [f'{k}="{v}"' for k, v in extra.items()]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_val(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def render_prometheus(registry_or_snapshot) -> str:
    """The snapshot in Prometheus text exposition format.

    Counters render as ``name`` totals, gauges as plain samples, and
    histograms as the standard cumulative ``_bucket{le=...}`` series plus
    ``_sum``/``_count``.
    """
    snap = _snap(registry_or_snapshot)
    by_name: dict = {}
    for (name, lk), v in snap.values.items():
        by_name.setdefault(name, []).append((lk, v))
    lines = []
    for name in sorted(by_name):
        help_txt = snap.helps.get(name)
        if help_txt:
            lines.append(f"# HELP {name} {help_txt}")
        lines.append(f"# TYPE {name} {snap.types.get(name, 'untyped')}")
        for lk, v in sorted(by_name[name]):
            if isinstance(v, HistogramSnapshot):
                cum = 0
                for bound, c in zip(v.bounds, v.counts):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(lk, {'le': _fmt_val(float(bound))})} {cum}"
                    )
                lines.append(
                    f"{name}_bucket{_fmt_labels(lk, {'le': '+Inf'})} {v.count}"
                )
                lines.append(f"{name}_sum{_fmt_labels(lk)} {_fmt_val(v.sum)}")
                lines.append(f"{name}_count{_fmt_labels(lk)} {v.count}")
            else:
                lines.append(f"{name}{_fmt_labels(lk)} {_fmt_val(v)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Parse the exposition subset :func:`render_prometheus` emits.

    Returns ``{(name, labels_tuple): value}`` — histogram series appear
    under their ``_bucket``/``_sum``/``_count`` sample names.  The scrape
    half of the CI gates: assertions run against this dict.
    """
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        sample, _, val = line.rpartition(" ")
        if "{" in sample:
            name, _, rest = sample.partition("{")
            labels = []
            for pair in rest.rstrip("}").split(","):
                if not pair:
                    continue
                k, _, v = pair.partition("=")
                labels.append((k, v.strip('"')))
            key = (name, tuple(sorted(labels)))
        else:
            key = (sample, ())
        if val in ("+Inf", "-Inf"):
            out[key] = math.inf if val == "+Inf" else -math.inf
        else:
            f = float(val)
            out[key] = int(f) if f.is_integer() else f
    return out


def render_jsonl(registry_or_snapshot, **stamp) -> str:
    """One JSON line per metric: ``{"metric": name, "labels": {...}, ...}``.

    ``stamp`` keys (e.g. ``ts=...``, ``run="ycsb-A"``) are merged into
    every line, so streams from many runs concatenate into one greppable
    log.
    """
    snap = _snap(registry_or_snapshot)
    lines = []
    for (name, lk), v in sorted(snap.values.items()):
        rec = dict(stamp)
        rec["metric"] = name
        rec["type"] = snap.types.get(name, "untyped")
        if lk:
            rec["labels"] = dict(lk)
        if isinstance(v, HistogramSnapshot):
            rec.update(v.as_dict())
        else:
            rec["value"] = v
        lines.append(json.dumps(rec, sort_keys=True))
    return "\n".join(lines) + "\n"


def write_jsonl(path: Union[str, "object"], registry_or_snapshot, **stamp) -> None:
    """Append :func:`render_jsonl` output to ``path``."""
    with open(path, "a") as f:
        f.write(render_jsonl(registry_or_snapshot, **stamp))


__all__ = [
    "parse_prometheus",
    "render_jsonl",
    "render_prometheus",
    "write_jsonl",
]
