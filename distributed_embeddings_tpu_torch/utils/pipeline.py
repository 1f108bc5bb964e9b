"""Bounded multi-stage background ingestion pipeline.

Counterpart of ``distributed_embeddings_tpu/utils/pipeline.py``. Every
ingestion stage (read -> preprocess -> stage) runs in its own persistent
worker thread, the stages joined by bounded queues, so host-side input
cost hides under the device step and steady-state throughput is set by
the slowest stage, not the sum of them.

Contract (the JAX package's):
  * Order-preserving: one worker per stage, FIFO queues; pipelined output
    is bit-identical to serial iteration.
  * Backpressure: every inter-stage queue is bounded by `depth`, so at
    most ``(stages + 1) * depth + stages`` batches are ever materialized.
  * Failure propagation: a worker exception rides the queue behind the
    items already produced; the consumer drains those, then the original
    exception re-raises at the call site (no hang, no silent drop).
  * Clean shutdown: `close()` (or exhaustion, or the context manager)
    stops and joins every worker.
  * Accounting: per-stage wall time lands in an
    ``ingest/stage_seconds{stage=...}`` histogram of the `registry` given
    (`training.fit` passes its run's) or of a private
    `obs.registry.MetricRegistry` (`stage_summaries()` reads them), and
    each stage body runs under ``obs.spans.annotation("ingest/<stage>")``
    (``torch.profiler.record_function``), so profiler traces show where
    ingestion time goes.

The JAX package's transient-error retry and its fault-injection hook
(``faults.check_raise("ingest.stage")``) are not ported (ROADMAP Queue
A15b): a stage's exception propagates at once.
"""

import queue as queue_lib
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
from distributed_embeddings_tpu_torch.obs.spans import annotation

__all__ = ["IngestPipeline", "SerialPipeline", "staged_batches",
           "READ_STAGE", "DEFAULT_DEPTH"]

# name of the implicit first stage (pulling the source iterator)
READ_STAGE = "read"
# the bound of each inter-stage queue when `fit` is given none (the JAX
# package's default; its DET_PIPELINE_DEPTH tune seam is ROADMAP A15c)
DEFAULT_DEPTH = 2

_END = object()          # end-of-stream sentinel


class _Failure:
    """A worker exception in transit to the consumer (rides the FIFO queue
    behind the items produced before it)."""

    __slots__ = ("exc", "stage")

    def __init__(self, exc: BaseException, stage: str):
        self.exc = exc
        self.stage = stage


def _annotate(name: str):
    return annotation(f"ingest/{name}")


def _stage_names(stages):
    stages = [(str(n), fn) for n, fn in stages]
    names = [READ_STAGE] + [n for n, _ in stages]
    if len(set(names)) != len(names):
        raise ValueError(f"stage names must be unique (and not "
                         f"{READ_STAGE!r}): {names}")
    return stages, names


def _histograms(names, registry: Optional[MetricRegistry]):
    reg = registry if registry is not None else MetricRegistry()
    return {n: reg.histogram("ingest/stage_seconds", stage=n) for n in names}


class IngestPipeline:
    """Background ingestion: stages run ahead of the consumer in threads.

    Args:
      source: iterable of batches (each item is whatever the first stage
        consumes: raw buffers, numpy pytrees, ...). Pulled by a persistent
        reader thread; ``next(source)`` time is the ``read`` stage's.
      stages: sequence of ``(name, fn)``; each fn maps one item to the
        next representation (e.g. ``("preprocess", ds.preprocess)``,
        ``("stage", DeviceStager(device).stage)``). One persistent
        worker thread per stage, applied in order.
      depth: bound of every inter-stage queue (2 = double buffer).
      registry: the `obs.MetricRegistry` the per-stage histograms live in
        (``ingest/stage_seconds{stage=}``); default a private one. Each
        stage's histogram has one writer thread either way.

    Iterate it like any iterator; `close()` runs on exhaustion and on
    ``with`` exit, and is idempotent. A worker exception surfaces at the
    consumer as the original exception after the items staged before it
    have been drained.
    """

    def __init__(self, source: Iterable,
                 stages: Sequence[Tuple[str, Callable]], depth: int = 2,
                 registry: Optional[MetricRegistry] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._stages, names = _stage_names(stages)
        self._source = iter(source)
        self._depth = int(depth)
        self._stop = threading.Event()
        self._closed = False
        self._hists = _histograms(names, registry)
        # queues[0] feeds stage 0; queues[-1] feeds the consumer
        self._queues = [queue_lib.Queue(maxsize=self._depth)
                        for _ in range(len(self._stages) + 1)]
        self._threads = [threading.Thread(
            target=self._read_loop, name=f"ingest-{READ_STAGE}", daemon=True)]
        for i, (sname, fn) in enumerate(self._stages):
            self._threads.append(threading.Thread(
                target=self._stage_loop, args=(i, sname, fn),
                name=f"ingest-{sname}", daemon=True))
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ workers
    def _put(self, q: queue_lib.Queue, item) -> bool:
        """Bounded put that stays responsive to shutdown. False when the
        pipeline stopped before the item could be enqueued."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue_lib.Full:
                continue
        return False

    def _get(self, q: queue_lib.Queue):
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.05)
            except queue_lib.Empty:
                continue
        return _END

    def _read_loop(self):
        hist = self._hists[READ_STAGE]
        out = self._queues[0]
        while True:
            t0 = time.perf_counter()
            try:
                with _annotate(READ_STAGE):
                    item = next(self._source)
            except StopIteration:
                self._put(out, _END)
                return
            except BaseException as e:  # noqa: BLE001 - propagate, never hang
                self._put(out, _Failure(e, READ_STAGE))
                return
            hist.record(time.perf_counter() - t0)
            if not self._put(out, item):
                return

    def _stage_loop(self, idx: int, sname: str, fn: Callable):
        hist = self._hists[sname]
        inq, outq = self._queues[idx], self._queues[idx + 1]
        while True:
            item = self._get(inq)
            if item is _END or isinstance(item, _Failure):
                self._put(outq, item)
                return
            t0 = time.perf_counter()
            try:
                with _annotate(sname):
                    item = fn(item)
            except BaseException as e:  # noqa: BLE001 - propagate, never hang
                self._put(outq, _Failure(e, sname))
                return
            hist.record(time.perf_counter() - t0)
            if not self._put(outq, item):
                return

    # ----------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        outq = self._queues[-1]
        while True:
            try:
                item = outq.get(timeout=0.1)
                break
            except queue_lib.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
                if not self._threads[-1].is_alive() and outq.empty():
                    # the last worker exited without a sentinel: fail
                    # loudly rather than spin
                    self.close()
                    raise RuntimeError(
                        "ingestion worker exited without result") from None
        if item is _END:
            self.close()
            raise StopIteration
        if isinstance(item, _Failure):
            self.close()
            raise item.exc
        return item

    # ---------------------------------------------------------- lifecycle
    def close(self):
        """Stop and join all workers; idempotent. Safe with items still in
        flight (the bounded queues are drained so blocked putters wake)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except queue_lib.Empty:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = [t for t in self._threads if t.is_alive()]
        if self._threads:  # pragma: no cover - blocking source
            # a reader stuck inside next(source) cannot see the stop; the
            # workers are daemons, and close() runs in finally blocks
            # where raising would mask the caller's exception
            warnings.warn(
                "ingestion workers still blocked at close "
                f"({[t.name for t in self._threads]}); abandoning daemon "
                "threads (source iterator blocked in next()?)",
                RuntimeWarning, stacklevel=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    # --------------------------------------------------------- accounting
    def stage_summaries(self) -> dict:
        """Per-stage wall-time summaries: {stage: {count, mean_ms, p50_ms,
        p95_ms, p99_ms, max_ms}}; ``read`` is the implicit source stage."""
        return {n: h.summary() for n, h in self._hists.items()}

    def stage_histograms(self) -> dict:
        """The live per-stage histograms, for callers that merge them
        across runs."""
        return dict(self._hists)

    def bottleneck(self) -> Optional[str]:
        """The stage with the largest mean wall time (None before any item
        completed): the stage whose rate bounds pipelined throughput."""
        means = {n: h.summary()["mean_ms"] for n, h in self._hists.items()
                 if h.count}
        return max(means, key=means.get) if means else None


class SerialPipeline:
    """The same stages run inline in the consumer thread, with the same
    accounting: the parity reference (pipelined output must be
    bit-identical to this iteration order) and ``fit(pipelined=False)``."""

    def __init__(self, source: Iterable,
                 stages: Sequence[Tuple[str, Callable]],
                 registry: Optional[MetricRegistry] = None):
        self._source = iter(source)
        self._stages, names = _stage_names(stages)
        self._hists = _histograms(names, registry)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        with _annotate(READ_STAGE):
            item = next(self._source)
        self._hists[READ_STAGE].record(time.perf_counter() - t0)
        for sname, fn in self._stages:
            t0 = time.perf_counter()
            with _annotate(sname):
                item = fn(item)
            self._hists[sname].record(time.perf_counter() - t0)
        return item

    def close(self):
        pass

    def stage_summaries(self) -> dict:
        return {n: h.summary() for n, h in self._hists.items()}

    def stage_histograms(self) -> dict:
        return dict(self._hists)


def staged_batches(data: Iterable, stage: Callable,
                   preprocess: Optional[Callable] = None,
                   depth: int = DEFAULT_DEPTH, pipelined: bool = True,
                   registry: Optional[MetricRegistry] = None) -> Any:
    """The train and eval loops' pipeline: [preprocess ->] stage.

    Args:
      data: iterable of batches.
      stage: device staging fn (e.g. a `parallel.staging.DeviceStager`'s
        ``stage``, whose batches the consumer takes with
        `parallel.staging.ready`).
      preprocess: optional host transform run in its own worker between
        read and stage (e.g. `RawBinaryDataset.preprocess`).
      depth: per-queue bound.
      pipelined: False returns the serial (inline) form, with identical
        output: the A/B switch `training.fit(pipelined=...)` exposes.
      registry: the `obs.MetricRegistry` of the per-stage histograms
        (see `IngestPipeline`).
    """
    stages = []
    if preprocess is not None:
        stages.append(("preprocess", preprocess))
    stages.append(("stage", stage))
    if pipelined:
        return IngestPipeline(data, stages, depth=depth, registry=registry)
    return SerialPipeline(data, stages, registry=registry)
