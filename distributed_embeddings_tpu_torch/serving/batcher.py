"""Micro-batching request queue for the inference engine.

Counterpart of ``distributed_embeddings_tpu/serving/batcher.py``: requests
enqueue with `submit()`; `flush()` coalesces everything queued into the
engine's warmed padded shapes (splitting across several forwards when the
queue exceeds the largest shape), runs the engine, waits for the device and
hands each request its own slice of the results. Synchronous and
single-threaded: the caller decides when to flush. Per-request queueing +
compute latency lands in the ``serve/request_seconds`` histogram; every
flush records batch occupancy (true rows over padded rows) and the
engine's cache hit rate. `queue_depth` and `queued_rows` are the
instruments the fleet's admission control sheds on (`fleet.admission`).
"""

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry

__all__ = ["MicroBatcher"]


def _slice_rows(out, sl: slice):
    if isinstance(out, torch.Tensor):
        return out[sl]
    return [a[sl] for a in out]


class MicroBatcher:
    """Coalesce variable-size requests into padded engine batches.

    Args:
      engine: an `InferenceEngine`, already `warmup()`-ed for the shapes
        this batcher should fill.
      max_batch: cap on true rows per forward (default: the engine's
        largest warmed shape, else 1024).
      clock: injectable time source (seconds) for latency accounting.
      registry: optional `MetricRegistry` for ``serve/request_seconds``,
        ``serve/requests``, ``serve/batches``, ``serve/batch_occupancy``
        and ``serve/cache_hit_rate``.
      replica: optional replica name: every family above then carries a
        ``replica=`` label, so one registry hosts a fleet's batchers.
        Default: the engine's own ``replica``.
    """

    def __init__(self, engine, max_batch: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 registry: Optional[MetricRegistry] = None,
                 replica: Optional[str] = None):
        self.engine = engine
        warmed = getattr(engine, "_warmed", [])
        self.max_batch = int(max_batch or (max(warmed) if warmed else 1024))
        self.clock = clock
        self._queue: List[Tuple[int, Any, List, int, float]] = []
        self._next_handle = 0
        self._metrics = registry if registry is not None \
            else MetricRegistry()
        if replica is None:
            replica = getattr(engine, "replica", None)
        self.replica = replica
        self._labels = {} if replica is None else {"replica": str(replica)}
        self.latency = self._metrics.histogram("serve/request_seconds",
                                               **self._labels)
        self.requests = 0
        self.batches = 0
        self.queue_depth_max = 0
        self._occupancy_rows = 0       # true rows over padded rows
        self._padded_rows = 0

    def submit(self, batch) -> int:
        """Enqueue one request (same `batch` structure as
        `engine.predict`). Returns a handle resolved by the next `flush`."""
        if self.engine._model is None:
            numerical, cats = None, list(batch)
        else:
            numerical, cats = batch
            cats = list(cats)
        rows = int(np.asarray(cats[0][0] if isinstance(cats[0], tuple)
                              else cats[0]).shape[0])
        if rows > self.max_batch:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch={self.max_batch};"
                " split it upstream")
        handle = self._next_handle
        self._next_handle += 1
        self._queue.append((handle, numerical, cats, rows, self.clock()))
        self.requests += 1
        self._metrics.counter("serve/requests", **self._labels).inc()
        self.queue_depth_max = max(self.queue_depth_max, len(self._queue))
        return handle

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def queued_rows(self) -> int:
        """True rows queued now (the row-level signal admission control
        sheds on, beside `queue_depth`)."""
        return sum(req[3] for req in self._queue)

    def _concat(self, parts: List):
        if isinstance(parts[0], tuple):
            return (np.concatenate([np.asarray(p[0]) for p in parts]),
                    np.concatenate([np.asarray(p[1]) for p in parts]))
        return np.concatenate([np.asarray(p) for p in parts])

    def flush(self) -> Dict[int, Any]:
        """Run everything queued; returns {handle: outputs} with each
        request's rows sliced back out of the coalesced forwards."""
        results: Dict[int, Any] = {}
        while self._queue:
            group, rows = [], 0
            while self._queue and rows + self._queue[0][3] <= self.max_batch:
                req = self._queue.pop(0)
                group.append(req)
                rows += req[3]
            cats = [self._concat([req[2][i] for req in group])
                    for i in range(len(group[0][2]))]
            if group[0][1] is None:
                batch = cats
            else:
                batch = (np.concatenate([np.asarray(req[1])
                                         for req in group]), cats)
            out = self.engine.predict(batch)
            # latency covers device compute, not just the launch
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)
            done = self.clock()
            padded = self.engine._target_batch(rows)
            self.batches += 1
            self._metrics.counter("serve/batches", **self._labels).inc()
            self._occupancy_rows += rows
            self._padded_rows += padded
            start = 0
            for handle, _, _, n, t_in in group:
                results[handle] = _slice_rows(out, slice(start, start + n))
                start += n
                self.latency.record(done - t_in)
        m = self._metrics
        m.gauge("serve/batch_occupancy", **self._labels).set(
            self._occupancy_rows / self._padded_rows
            if self._padded_rows else 0.0)
        caches = getattr(self.engine, "caches", {}) or {}
        hits = sum(c.hits for c in caches.values())
        misses = sum(c.misses for c in caches.values())
        m.gauge("serve/cache_hit_rate", **self._labels).set(
            hits / (hits + misses) if hits + misses else 0.0)
        return results

    def summary(self) -> dict:
        """Serving metrics: latency percentiles, batch occupancy, queue
        depth and the engine's cache hit rate."""
        occ = (self._occupancy_rows / self._padded_rows
               if self._padded_rows else 0.0)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "queue_depth": self.queue_depth,
            "queue_depth_max": self.queue_depth_max,
            "batch_occupancy": round(occ, 4),
            "hit_rate": self.engine.cache_stats()["hit_rate"],
            **self.latency.summary(),
        }
