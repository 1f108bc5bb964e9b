"""Host-side step-span tracing.

Counterpart of ``distributed_embeddings_tpu/obs/spans.py``.
``span("train/step")`` times a host-side region into a registry histogram
and opens `annotation` (``torch.profiler.record_function``, and an NVTX
range on a card) for the same region, so the spans that structure a
training or serving loop show up at once in the registry snapshot
(wall-time percentiles per span path, SLO-gateable), in a profiler trace
(next to the kernels the span launched: `obs.attribution`) and in the
flight recorder (`obs.trace.default_recorder`).

Nesting composes paths: a ``span("publish")`` opened inside
``span("train")`` records as ``train/publish``; the per-thread span stack
supplies the prefix, so pipeline worker threads and the consumer each get
their own nesting.

Spans are host-side only: a span inside a function that autograd or a
CUDA graph replays would time nothing. They read the clock and append to
host structures; they launch nothing and synchronize nothing, so a step
with spans is bit-equal to one without.

The JAX `annotation` caches a failed profiler probe; `record_function`
cannot fail that way, so the port's has no ``try``.
"""

import contextlib
import threading
import time
from typing import Optional

from distributed_embeddings_tpu_torch.obs.registry import (MetricRegistry,
                                                           default_registry)
from distributed_embeddings_tpu_torch.obs.trace import default_recorder
from distributed_embeddings_tpu_torch.utils.profiling import annotate

__all__ = ["span", "annotation", "current_span"]

_state = threading.local()


def annotation(name: str):
    """`utils.profiling.annotate(name)`: a named region in a profiler
    trace (and an NVTX range on a card)."""
    return annotate(name)


def current_span() -> Optional[str]:
    """The innermost open span path on this thread (None outside any)."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def span(name: str, registry: Optional[MetricRegistry] = None):
    """Time a host-side region into ``span_seconds{span=<path>}``.

    Args:
      name: span name; joined onto the enclosing span's path with ``/``
        (top-level spans may themselves be pre-pathed: "train/step").
      registry: target registry (default: the process-local one).

    The duration records even when the body raises (a failing step is
    still a step that took time), and the annotation closes with the
    region, so the profiler's nesting matches the histogram paths.
    """
    reg = registry if registry is not None else default_registry()
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    path = f"{stack[-1]}/{name}" if stack else name
    stack.append(path)
    rec = default_recorder()
    rec.begin(path)
    t0 = time.perf_counter()
    try:
        with annotation(path):
            yield path
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        rec.end(path)
        reg.histogram("span_seconds", span=path).record(dt)
