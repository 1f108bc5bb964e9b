"""Process-local metric registry: counters, gauges and latency histograms.

The part of ``distributed_embeddings_tpu/obs/registry.py`` the serving path
reads, copied: named instruments with labeled families, the geometric-bucket
`LatencyHistogram`, and a point-in-time ``snapshot()``. Instruments are
plain Python objects updated from host-side code.
"""

import threading
from typing import Dict, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "LatencyHistogram", "MetricRegistry",
           "metric_key"]


def metric_key(name: str, labels: Dict[str, object]) -> str:
    """Canonical flat key: ``name`` or ``name{k=v,...}`` with labels
    sorted."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic count."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, object]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, object]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class LatencyHistogram:
    """Geometric-bucket latency histogram with percentile estimates: O(1)
    `record`, fixed memory; percentiles interpolate within the winning
    bucket (< 7.5% edge error at 32 buckets per decade)."""

    def __init__(self, lo: float = 1e-6, hi: float = 120.0,
                 bins_per_decade: int = 32):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self.lo = float(lo)
        decades = np.log10(hi / lo)
        self.bins = int(np.ceil(decades * bins_per_decade)) + 1
        self._ratio = 10.0 ** (1.0 / bins_per_decade)
        # edges[i] = lo * ratio^i; bucket i holds (edges[i-1], edges[i]]
        self._edges = lo * self._ratio ** np.arange(self.bins)
        self._counts = np.zeros((self.bins + 1,), np.int64)  # +overflow
        self._total = 0.0
        self._max = 0.0

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        idx = int(np.searchsorted(self._edges, s, side="left"))
        self._counts[min(idx, self.bins)] += 1
        self._total += s
        self._max = max(self._max, s)

    @property
    def count(self) -> int:
        return int(self._counts.sum())

    def percentile(self, p: float) -> float:
        """The p-th percentile (0..100) in seconds; 0.0 when empty."""
        n = self.count
        if n == 0:
            return 0.0
        rank = np.ceil(n * min(max(p, 0.0), 100.0) / 100.0)
        cum = np.cumsum(self._counts)
        idx = int(np.searchsorted(cum, max(rank, 1)))
        if idx >= self.bins:
            return self._max
        hi = self._edges[idx]
        lo = self._edges[idx - 1] if idx else 0.0
        prev = cum[idx - 1] if idx else 0
        frac = (rank - prev) / max(self._counts[idx], 1)
        return float(min(lo + (hi - lo) * frac, self._max))

    def summary(self) -> dict:
        n = self.count
        return {
            "count": n,
            "mean_ms": round(self._total / n * 1e3, 3) if n else 0.0,
            "p50_ms": round(self.percentile(50) * 1e3, 3),
            "p95_ms": round(self.percentile(95) * 1e3, 3),
            "p99_ms": round(self.percentile(99) * 1e3, 3),
            "max_ms": round(self._max * 1e3, 3),
        }


_LabelKey = Tuple[Tuple[str, object], ...]


class MetricRegistry:
    """Named counters/gauges/histograms with labeled families:
    ``counter(name, **labels)`` returns the one instrument for that (name,
    labels); one name means one kind."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, _LabelKey], object] = {}

    def _resolve(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name, tuple(sorted(labels.items())))
        with self._lock:
            for other in ("counter", "gauge", "histogram"):
                if other != kind and (other, name, key[2]) in self._metrics:
                    raise ValueError(
                        f"metric {metric_key(name, labels)!r} already "
                        f"registered as a {other}, requested as {kind}")
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._resolve("counter", name, labels,
                             lambda: Counter(name, labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._resolve("gauge", name, labels,
                             lambda: Gauge(name, labels))

    def histogram(self, name: str, **labels) -> LatencyHistogram:
        return self._resolve("histogram", name, labels, LatencyHistogram)

    def snapshot(self) -> dict:
        """``{"counters": {key: int}, "gauges": {key: float},
        "histograms": {key: summary-dict}}`` with flat
        ``name{label=value,...}`` keys."""
        with self._lock:
            items = sorted(self._metrics.items(),
                           key=lambda kv: (kv[0][1], kv[0][2]))
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (kind, name, kl), m in items:
            key = metric_key(name, dict(kl))
            if kind == "histogram":
                out["histograms"][key] = m.summary()
            else:
                out[kind + "s"][key] = m.value
        return out
