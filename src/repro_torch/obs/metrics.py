"""Process-local metrics: counters, gauges, fixed-bucket histograms (a
copy of ``repro.obs.metrics``: the port imports nothing of the reference).

The serving/training hot paths need numbers that survive aggregation —
"how many requests", "what is the p99 request latency", "how full are
the batches" — without dragging in a metrics daemon.  This module is a
dependency-free registry of three primitives:

* :class:`Counter` — monotonically increasing int (requests, batches,
  padded images, drift events);
* :class:`Gauge` — last-write-wins float (images/sec, batch fill ratio);
* :class:`Histogram` — FIXED log-spaced buckets with p50/p90/p99
  summaries.  Fixed buckets are the deliberate choice over reservoir
  sampling: observation is O(log buckets) with bounded memory forever
  (a "millions of users" serving path cannot keep raw samples), and two
  histograms merge by adding counts.  Percentiles interpolate inside
  the bucket, so their error is bounded by the bucket ratio (~12% with
  the default 20-buckets-per-decade layout); exact min/max/sum/count
  ride along and clamp the estimates.

Everything supports ``reset()`` — the test contract: a test may enable
obs, exercise a path, assert on the registry, and reset without leaking
state into the next test.  ``export_jsonl`` writes one JSON object per
metric (the CI artifact format).

Thread-safe: each instrument takes a lock per observation; the registry
locks around instrument creation.  Stdlib only — the obs subsystem must
be importable (and no-op) everywhere.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence


def default_buckets(lo: float = 1.0, hi: float = 1e8,
                    per_decade: int = 20) -> List[float]:
    """Log-spaced bucket upper bounds covering [lo, hi] — the default is
    1 µs … 100 s at ~12% resolution, which brackets everything from one
    int8 GEMM dispatch to an interpret-mode large-map pass."""
    n = int(math.ceil(per_decade * math.log10(hi / lo)))
    return [lo * 10 ** (i / per_decade) for i in range(n + 1)]


class Counter:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "type": "counter", "value": self.value}


class Gauge:
    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = None

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``bounds`` are ascending bucket UPPER bounds; an observation lands in
    the first bucket whose bound is ≥ the value, values beyond the last
    bound land in an overflow bucket.  ``percentile(p)`` walks the
    cumulative counts to the target rank and interpolates linearly
    inside the bucket (clamped to the exact observed min/max), so the
    estimate is within one bucket ratio of the true order statistic —
    the property tests/test_obs.py checks against numpy."""

    __slots__ = ("name", "bounds", "_lock", "_counts", "_overflow",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds = list(bounds) if bounds is not None \
            else default_buckets()
        if any(b <= a for a, b in zip(self.bounds, self.bounds[1:])):
            raise ValueError(f"histogram {name!r}: bucket bounds must be "
                             "strictly ascending")
        self._lock = threading.Lock()
        self._counts = [0] * len(self.bounds)
        self._overflow = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            if i < len(self.bounds):
                self._counts[i] += 1
            else:
                self._overflow += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, vs: Iterable[float]) -> None:
        for v in vs:
            self.observe(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        """Interpolated percentile estimate, p in [0, 100]."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile wants p in [0, 100], got {p}")
        with self._lock:
            n = self._count
            if n == 0:
                return 0.0
            # nearest-rank target (1-indexed), then interpolate in-bucket
            rank = max(1, math.ceil(p / 100.0 * n))
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c >= rank:
                    lo = self.bounds[i - 1] if i > 0 else min(
                        self._min, self.bounds[0])
                    hi = self.bounds[i]
                    frac = (rank - cum) / c
                    est = lo + (hi - lo) * frac
                    return min(max(est, self._min), self._max)
                cum += c
            return self._max            # rank fell in the overflow bucket

    def summary(self) -> Dict[str, float]:
        with self._lock:
            n, s = self._count, self._sum
            mn = self._min if n else 0.0
            mx = self._max if n else 0.0
        return {"count": n, "sum": s, "min": mn, "max": mx,
                "mean": s / n if n else 0.0,
                "p50": self.percentile(50.0),
                "p90": self.percentile(90.0),
                "p99": self.percentile(99.0)}

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self.bounds)
            self._overflow = 0
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "type": "histogram", **self.summary()}


class MetricsRegistry:
    """A named collection of instruments.  ``counter``/``gauge``/
    ``histogram`` get-or-create (idempotent, type-checked), ``reset()``
    zeroes every instrument (the test contract), ``export_jsonl`` writes
    one JSON line per instrument."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        if bounds is None:
            return self._get(name, Histogram)
        return self._get(name, Histogram, bounds)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def clear(self) -> None:
        """Drop every instrument (reset() keeps them registered at
        zero)."""
        with self._lock:
            self._metrics.clear()

    def to_dicts(self) -> List[Dict[str, Any]]:
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        return [m.to_dict() for m in metrics]

    def export_jsonl(self, path: str) -> str:
        """One JSON object per line per instrument, stamped with export
        wall time (the only place wall time belongs: provenance, not
        measurement)."""
        ts = time.time()
        with open(path, "w") as f:
            for d in self.to_dicts():
                d["exported_at"] = ts
                f.write(json.dumps(d) + "\n")
        return path
