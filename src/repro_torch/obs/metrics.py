"""Metrics registry: counters, gauges, streaming histograms.

A copy of the reference package's ``obs/metrics.py`` with the same API:
a process-wide registry every layer can write into, so health state is
readable from ONE place — ``Registry.snapshot()`` — instead of scattered
ad-hoc counters.

Histograms are STREAMING: log-spaced buckets (growth ``2**(1/8)`` ≈ 9%
per bucket) accumulate counts only, so p50/p99 come from bucket
interpolation at O(1) memory per series — no sample storage, bounded
error (one bucket width, ~9% relative).

Everything is thread-safe (one lock per registry; instruments mutate
only under it). A module-level default registry mirrors the tracer's
singleton pattern; isolated consumers (tests, parallel engines) build
their own ``Registry``.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

# Histogram geometry: log-spaced buckets covering ~[1e-9, 1e12) with
# 2**(1/8) growth — 9% relative quantile error, ~560 buckets worst case
# (allocated lazily per series as a dict).
_GROWTH = 2.0 ** 0.125
_LOG_GROWTH = math.log(_GROWTH)


class Counter:
    """Monotonic counter."""

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Streaming log-bucket histogram with interpolated quantiles."""

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}   # bucket index -> count
        self._underflow = 0                  # values <= 0

    @staticmethod
    def _index(v: float) -> int:
        return int(math.floor(math.log(v) / _LOG_GROWTH))

    def record(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= 0.0:
            self._underflow += 1
            return
        i = self._index(v)
        self._buckets[i] = self._buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]); NaN when empty."""
        if self.count == 0:
            return math.nan
        rank = q / 100.0 * (self.count - 1)
        if rank <= self._underflow - 1:
            return min(self.min, 0.0)
        seen = self._underflow
        for i in sorted(self._buckets):
            n = self._buckets[i]
            if seen + n > rank:
                lo, hi = _GROWTH ** i, _GROWTH ** (i + 1)
                frac = (rank - seen + 1) / n  # position inside the bucket
                v = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return float(min(max(v, self.min), self.max))
            seen += n
        return float(self.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def summary(self) -> dict:
        return {
            "count": self.count, "sum": self.sum,
            "min": self.min if self.count else math.nan,
            "max": self.max if self.count else math.nan,
            "mean": self.mean,
            "p50": self.percentile(50.0), "p99": self.percentile(99.0),
        }


class Registry:
    """Named instruments, created on first use; one lock, snapshot-able."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(name, Histogram())

    def names(self) -> List[str]:
        with self._lock:
            return sorted(set(self._counters) | set(self._gauges)
                          | set(self._histograms))

    def snapshot(self) -> dict:
        """One JSON-safe dict of everything: the operator dashboard /
        ``--stats-json`` surface."""
        with self._lock:
            return {
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {k: h.summary()
                               for k, h in sorted(self._histograms.items())},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_default = Registry()


def default_registry() -> Registry:
    return _default
