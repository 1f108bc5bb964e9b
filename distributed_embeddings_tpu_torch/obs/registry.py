"""Process-local metric registry: ONE namespace for runtime telemetry.

Counterpart of ``distributed_embeddings_tpu/obs/registry.py``, copied (the
port imports nothing of the JAX package): named counters, gauges and
histograms with labeled families (``table=``, ``group=``, ``stage=``), a
point-in-time ``snapshot()`` dict every caller can embed (``fit`` history,
`chip_smoke.py`), JSONL append export for soak runs, and a Prometheus-style
text dump for scraping.

`LatencyHistogram`, the geometric-bucket histogram of the serving path and
the ingest pipeline, is the registry's histogram type
(``utils.metrics`` re-exports it). Components obtain instruments through a
registry, so a composed run has one metric namespace.

Sharing model: `MetricRegistry()` is instantiable (a component given no
registry makes a private one) and `default_registry()` is the
process-local instance callers use to unify a run (`training.fit` threads
ONE registry through the pipeline, lookahead engine, store and vocabulary
manager it drives). Instruments are plain Python objects updated from
host-side code only.
"""

import json
import os
import re
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "LatencyHistogram", "MetricRegistry",
           "default_registry", "reset_default_registry", "metric_key"]


def metric_key(name: str, labels: Dict[str, object]) -> str:
    """Canonical flat key: ``name`` or ``name{k=v,...}`` with labels
    sorted — the snapshot/export key AND the address SLO rules use."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic count (requests, admissions, publish bytes...)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, object]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (occupancy, version lag, compile count...)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, object]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class LatencyHistogram:
    """Geometric-bucket latency histogram with percentile estimates.

    O(1) `record`, fixed memory (`~bins_per_decade * decades` int64 slots),
    so a long-lived server can keep one per metric without unbounded
    per-request lists. Percentiles interpolate within the winning bucket —
    with the default 32 buckets/decade the edge-quantization error is
    < 7.5%, far below the run-to-run variance of real serving latencies.

    Usage (through a registry):
      h = registry.histogram("serve/request_seconds")
      h.record(0.0123)                  # seconds
      h.percentile(99)                  # seconds
      h.summary()                       # {"count", "p50_ms", ...}
    """

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

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold another histogram's counts into this one (in place;
        returns self for chaining). Lets per-rep/per-stage histograms
        aggregate into one distribution — e.g. an ingest pipeline's
        per-stage timings across repeated runs — instead of
        only the last rep surviving. Bucket layouts must match exactly
        (same lo/hi/bins_per_decade): merging differently-edged
        histograms would silently misfile counts."""
        if (self.lo, self.bins, self._ratio) != (other.lo, other.bins,
                                                 other._ratio):
            raise ValueError(
                "cannot merge LatencyHistograms with different bucket "
                f"layouts: (lo={self.lo}, bins={self.bins}, "
                f"ratio={self._ratio}) vs (lo={other.lo}, "
                f"bins={other.bins}, ratio={other._ratio})")
        self._counts += other._counts
        self._total += other._total
        self._max = max(self._max, other._max)
        return self

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
        # linear interpolation inside the bucket by rank position, capped
        # by the true max so a wide top bucket cannot report p99 > max
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
    """Named counters/gauges/histograms with labeled families.

    ``counter(name, **labels)`` (and gauge/histogram) returns the ONE
    instrument for that (name, labels) — repeated calls are a lookup,
    so components can resolve their instruments per event without
    holding references. Kinds live in separate namespaces (requesting a
    gauge where a counter exists raises: one name means one thing).
    For histograms the first creation's bucket layout wins; a later
    request with a different layout raises rather than silently
    misfiling.

    Instrument updates are single-writer-cheap plain attribute writes;
    the registry's own map is lock-protected so pipeline worker threads
    can resolve instruments concurrently.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, _LabelKey], object] = {}

    def _resolve(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name, tuple(sorted(labels.items())))
        with self._lock:
            for other in ("counter", "gauge", "histogram"):
                if other != kind and (other, name,
                                      key[2]) in self._metrics:
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

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 120.0,
                  bins_per_decade: int = 32, **labels) -> LatencyHistogram:
        h = self._resolve("histogram", name, labels,
                          lambda: LatencyHistogram(
                              lo=lo, hi=hi,
                              bins_per_decade=bins_per_decade))
        # full layout check (lo, ratio AND bin count — bins derive from
        # hi, so a differing hi alone must also refuse): the same triple
        # merge() guards on
        want_bins = int(np.ceil(np.log10(hi / lo) * bins_per_decade)) + 1
        if (h.lo, h.bins, h._ratio) != (float(lo), want_bins,
                                        10.0 ** (1.0 / bins_per_decade)):
            raise ValueError(
                f"histogram {metric_key(name, labels)!r} exists with a "
                "different bucket layout (first creation wins; merging "
                "layouts would misfile counts)")
        return h

    # ------------------------------------------------------------ views
    def _by_kind(self, kind: str):
        with self._lock:
            items = [(name, key_labels, m) for (k, name, key_labels), m
                     in self._metrics.items() if k == kind]
        return sorted(items, key=lambda t: (t[0], t[1]))

    def snapshot(self) -> dict:
        """Point-in-time dict of every instrument: ``{"counters":
        {key: int}, "gauges": {key: float}, "histograms": {key:
        summary-dict}}`` with ``name{label=value,...}`` flat keys —
        the schema `obs.slo` rules address and callers embed."""
        return {
            "counters": {metric_key(n, dict(kl)): m.value
                         for n, kl, m in self._by_kind("counter")},
            "gauges": {metric_key(n, dict(kl)): m.value
                       for n, kl, m in self._by_kind("gauge")},
            "histograms": {metric_key(n, dict(kl)): m.summary()
                           for n, kl, m in self._by_kind("histogram")},
        }

    def export_jsonl(self, path: str, extra: Optional[dict] = None,
                     fsync: bool = False) -> dict:
        """Append one timestamped snapshot line to `path` (creating it);
        the soak-run export format: one JSON object per line, so a
        watcher can tail it and `obs.slo.evaluate_rules` can window
        over the parsed lines. Returns the line's dict.

        The line is FLUSHED to the OS before the file closes — a
        crashed soak must not lose the tail lines its SLO window
        evaluates over (the postmortem reads the last written step).
        ``fsync=True`` additionally fsyncs, for the final/explicit
        export of a run (per-line fsync would put a disk barrier on the
        snapshot cadence; per-line flush already survives a process
        crash, and the closing export survives power loss)."""
        line = {"ts": round(time.time(), 3), **(extra or {}),
                **self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        return line

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the registry: counters as
        ``*_total``, gauges verbatim, histograms as summaries
        (quantile series + ``_count``/``_sum``). Metric names sanitize
        ``/`` and other non-identifier characters to ``_``; label
        VALUES escape per the text-format spec (backslash, double
        quote, newline) — degraded reasons and quarantine paths put
        arbitrary filesystem strings into labels, and one unescaped
        quote makes the whole exposition unparseable."""
        def sane(name: str) -> str:
            return re.sub(r"[^a-zA-Z0-9_:]", "_", name)

        def esc(value: object) -> str:
            # the exposition-format escape set, in spec order:
            # backslash first (or the others' escapes double-escape)
            return (str(value).replace("\\", "\\\\")
                    .replace('"', '\\"').replace("\n", "\\n"))

        def fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
            merged = {**labels, **(extra or {})}
            if not merged:
                return ""
            inner = ",".join(f'{sane(str(k))}="{esc(merged[k])}"'
                             for k in sorted(merged))
            return "{" + inner + "}"

        out = []
        for name, kl, m in self._by_kind("counter"):
            mn = sane(name) + "_total"
            out.append(f"# TYPE {mn} counter")
            out.append(f"{mn}{fmt_labels(dict(kl))} {m.value}")
        for name, kl, m in self._by_kind("gauge"):
            mn = sane(name)
            out.append(f"# TYPE {mn} gauge")
            out.append(f"{mn}{fmt_labels(dict(kl))} {m.value}")
        for name, kl, m in self._by_kind("histogram"):
            mn = sane(name)
            labels = dict(kl)
            out.append(f"# TYPE {mn} summary")
            for q in (0.5, 0.95, 0.99):
                v = m.percentile(q * 100)
                out.append(f"{mn}{fmt_labels(labels, {'quantile': q})} "
                           f"{v:.9f}")
            out.append(f"{mn}_count{fmt_labels(labels)} {m.count}")
            out.append(f"{mn}_sum{fmt_labels(labels)} {m._total:.9f}")
        return "\n".join(out) + ("\n" if out else "")


_default_lock = threading.Lock()
_default: Optional[MetricRegistry] = None


def default_registry() -> MetricRegistry:
    """The process-local registry callers share. Long-lived processes composing
    several independent runs should create per-run `MetricRegistry`
    instances instead — counts here accumulate for the process
    lifetime (that is the point)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricRegistry()
        return _default


def reset_default_registry() -> None:
    """Drop the process-local registry (tests)."""
    global _default
    with _default_lock:
        _default = None
