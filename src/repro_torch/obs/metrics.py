"""Deterministic metrics primitives for the serving stack (a copy of
``repro.obs.metrics``).

Three instrument kinds behind one registry:

    Counter    — monotone event count (frames received, decode errors,
                 rounds served, speculation hits);
    Gauge      — last-set value plus its running peak (queue depth,
                 uplink backlog seconds, active slots);
    Histogram  — FIXED-bucket distribution (RPC round trips, verify
                 wall-clock).  Bucket bounds are chosen at construction
                 and never adapt, so two runs observing the same values
                 produce byte-identical snapshots — the determinism
                 contract the obs tests pin.

``MetricsRegistry.snapshot()`` renders everything as one JSON-able dict
with SORTED keys: same observations, same snapshot, independent of
creation or thread interleaving order.  A disabled registry hands out
shared no-op instruments, so hot-path call sites never branch — the
zero-perturbation / near-zero-cost invariant of the obs layer.

This module also owns the latency-stat helpers: ``percentile`` keeps
the report semantics (NaN on empty — a report field that means "no
data"), ``summary_stats`` the record semantics (all-zero dict on empty —
a JSON-able record that means "nothing measured").
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "percentile", "summary_stats"]


def percentile(xs, q) -> float:
    """q-th percentile of ``xs``; NaN on empty (report semantics)."""
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) \
        else float("nan")


def summary_stats(xs: Sequence[float]) -> dict:
    """mean/p50/p95/n of ``xs``; all-zero on empty (JSON semantics)."""
    if not len(xs):
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "n": 0}
    a = np.asarray(xs, np.float64)
    return {"mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "n": int(a.size)}


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n


class Gauge:
    __slots__ = ("value", "peak")

    def __init__(self):
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float):
        self.value = float(v)
        if self.value > self.peak:
            self.peak = self.value


# Default histogram bounds: log-ish spacing from 100 µs to 30 s — wide
# enough for both modeled round times and real RPC wall-clock.
DEFAULT_BOUNDS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                  1.0, 3.0, 10.0, 30.0)


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` counts observations with
    ``v <= bounds[i]`` (first matching bucket); the final overflow
    bucket takes everything above the last bound."""

    __slots__ = ("bounds", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS):
        b = tuple(float(x) for x in bounds)
        assert b and all(x < y for x, y in zip(b, b[1:])), \
            f"bounds must be strictly increasing, got {b}"
        self.bounds = b
        self.counts = [0] * (len(b) + 1)
        self.n = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float):
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def snapshot(self) -> dict:
        buckets = {f"le_{b:g}": c for b, c in zip(self.bounds, self.counts)}
        buckets["inf"] = self.counts[-1]
        return {"buckets": buckets, "count": self.n, "sum": self.total,
                "min": self.vmin if self.n else 0.0,
                "max": self.vmax if self.n else 0.0,
                "mean": self.total / self.n if self.n else 0.0}


class _NullCounter(Counter):
    def inc(self, n: int = 1):
        pass


class _NullGauge(Gauge):
    def set(self, v: float):
        pass


class _NullHistogram(Histogram):
    def observe(self, v: float):
        pass


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Name -> instrument, created on first use.  ``enabled=False``
    returns shared no-op instruments — call sites stay branch-free and
    a disabled registry costs one dict-free method call per event."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(bounds or DEFAULT_BOUNDS)
        return h

    def snapshot(self) -> dict:
        """Deterministic JSON-able snapshot: sorted names, plain
        numbers.  Same observations -> identical snapshot, regardless
        of instrument creation order."""
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: {"value": self._gauges[k].value,
                           "peak": self._gauges[k].peak}
                       for k in sorted(self._gauges)},
            "histograms": {k: self._histograms[k].snapshot()
                           for k in sorted(self._histograms)},
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
