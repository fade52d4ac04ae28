"""Metrics registry: counters, gauges, histograms with labeled series.

Absorbs the ad-hoc stat dicts that used to live in `sweep.py`,
`resilience.py`, `cache.py`, and `placement_batch.py` into one registry
with a JSON snapshot.  The snapshot has exactly two top-level namespaces,
and the split IS the determinism contract that `resilience.py` used to
enforce "by convention only":

  * `comparable` — values that are a pure function of (inputs, seed):
    placement descent iterations, quarantine counts, nocsim saturation
    bounds, unit totals.  Two runs over the same grid must produce
    identical `comparable` namespaces, resumed or not — tests assert it.
  * `non_comparable` — anything wall-clock-, cache-, or resume-dependent:
    stage seconds, peak RSS, cache hit/miss/shard-retry counts, resumed
    vs computed unit counts.  Excluded from byte-comparisons by placement
    in this namespace, not by callers remembering to skip keys.

Metric kinds:

  * counter — monotone accumulator (`inc`).
  * gauge   — last-write-wins (`set`).
  * histogram — bounded reservoir keeping count/sum/min/max plus the
    first `reservoir` observations (enough for tests and reports without
    unbounded memory in long training loops).

Every metric holds labeled series: `counter("cache.events",
non_comparable=True).inc(1, kind="trace_hit")` creates/updates the series
keyed by the sorted label items.  Registering the same name twice with a
different kind or namespace is a bug and raises.
"""
from __future__ import annotations

import json
import os
import threading

__all__ = [
    "Metric",
    "MetricsRegistry",
    "registry",
    "get_registry",
    "reset",
    "snapshot",
    "write_snapshot",
    "series_map",
    "series_value",
]

_KINDS = ("counter", "gauge", "histogram")


def _series_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Metric:
    """One named metric holding labeled series.  Created via the registry
    accessors, never directly."""

    def __init__(self, name: str, kind: str, non_comparable: bool, reservoir: int = 256):
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.non_comparable = non_comparable
        self.reservoir = reservoir
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        if self.kind != "counter":
            raise ValueError(f"{self.name} is a {self.kind}, not a counter")
        key = _series_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def set(self, value: float, **labels) -> None:
        if self.kind != "gauge":
            raise ValueError(f"{self.name} is a {self.kind}, not a gauge")
        with self._lock:
            self._series[_series_key(labels)] = value

    def observe(self, value: float, **labels) -> None:
        if self.kind != "histogram":
            raise ValueError(f"{self.name} is a {self.kind}, not a histogram")
        key = _series_key(labels)
        with self._lock:
            h = self._series.get(key)
            if h is None:
                h = {"count": 0, "sum": 0.0, "min": value, "max": value, "samples": []}
                self._series[key] = h
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            if len(h["samples"]) < self.reservoir:
                h["samples"].append(value)

    def as_dict(self) -> dict:
        with self._lock:
            series = [
                {"labels": dict(key), "value": _copy_value(val)}
                for key, val in sorted(self._series.items())
            ]
        return {"kind": self.kind, "series": series}


def _copy_value(val):
    if isinstance(val, dict):
        out = dict(val)
        out["samples"] = list(val["samples"])
        return out
    return val


class MetricsRegistry:
    """Process-wide metric store with pid-aware reset (a forked child
    starts from an empty registry rather than double-counting the
    parent's series)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._metrics: dict[str, Metric] = {}

    def _get(self, name: str, kind: str, non_comparable: bool) -> Metric:
        with self._lock:
            if os.getpid() != self._pid:
                self._pid = os.getpid()
                self._metrics = {}
            m = self._metrics.get(name)
            if m is None:
                m = Metric(name, kind, non_comparable)
                self._metrics[name] = m
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, requested {kind}"
                )
            elif m.non_comparable != non_comparable:
                raise ValueError(
                    f"metric {name!r} already registered with "
                    f"non_comparable={m.non_comparable}"
                )
            return m

    def counter(self, name: str, non_comparable: bool = False) -> Metric:
        return self._get(name, "counter", non_comparable)

    def gauge(self, name: str, non_comparable: bool = False) -> Metric:
        return self._get(name, "gauge", non_comparable)

    def histogram(self, name: str, non_comparable: bool = False) -> Metric:
        return self._get(name, "histogram", non_comparable)

    def reset(self) -> None:
        with self._lock:
            self._metrics = {}
            self._pid = os.getpid()

    def snapshot(self) -> dict:
        """`{"version": 1, "comparable": {...}, "non_comparable": {...}}` —
        metric names sorted, series sorted by labels; byte-stable for a
        given sequence of updates."""
        with self._lock:
            metrics = list(self._metrics.values())
        comparable: dict[str, dict] = {}
        non_comparable: dict[str, dict] = {}
        for m in sorted(metrics, key=lambda m: m.name):
            (non_comparable if m.non_comparable else comparable)[m.name] = m.as_dict()
        return {"version": 1, "comparable": comparable, "non_comparable": non_comparable}

    def write_snapshot(self, path: str) -> dict:
        snap = self.snapshot()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(snap, fh, indent=1, sort_keys=True, default=_json_default)
            fh.write("\n")
        return snap


def _json_default(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)


registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return registry


def reset() -> None:
    registry.reset()


def snapshot() -> dict:
    return registry.snapshot()


def write_snapshot(path: str) -> dict:
    return registry.write_snapshot(path)


def series_map(snap: dict, name: str, label: str) -> dict:
    """Flatten one metric from a snapshot into `{label_value: value}` —
    the report-side accessor (`series_map(snap, "sweep.stage_seconds",
    "stage")["placement"]`).  Looks in both namespaces; histograms map to
    their summary dict."""
    for ns in ("comparable", "non_comparable"):
        m = snap.get(ns, {}).get(name)
        if m is not None:
            return {s["labels"].get(label): s["value"] for s in m["series"]}
    return {}


def series_value(snap: dict, name: str, **labels):
    """Single-series accessor: exact label match or None."""
    key = dict(labels)
    for ns in ("comparable", "non_comparable"):
        m = snap.get(ns, {}).get(name)
        if m is None:
            continue
        for s in m["series"]:
            if s["labels"] == key:
                return s["value"]
    return None
