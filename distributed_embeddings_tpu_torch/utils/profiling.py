"""Profiler helpers: named regions and captures.

The part of ``distributed_embeddings_tpu/utils/profiling.py`` the spans
and the device-time attribution need: `annotate` (a named region in a
profiler trace) and `trace` (a capture of everything inside a block,
written where the JAX profiler writes its own, so
`obs.attribution.find_trace_file` is the same function in both packages).
The JAX module's benchmark helpers (`benchmark`, `benchmark_batches`,
`benchmark_chained`) are ROADMAP Queue A17; its ``hlo_*`` readers parse
XLA text and have no counterpart.
"""

import contextlib
import os
import socket
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           resolve_device)

__all__ = ["annotate", "trace"]


@contextlib.contextmanager
def _nvtx_range(name: str):
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def annotate(name: str):
    """A named region: ``torch.profiler.record_function(name)`` (a
    ``user_annotation`` event while a profiler runs), and on a process
    with a card also an NVTX range of the same name."""
    with record_function(name):
        if torch.cuda.is_available():
            with _nvtx_range(name):
                yield
        else:
            yield


def _trace_path(logdir: str) -> str:
    """Where a capture started now lands: ``logdir/plugins/profile/<run>/
    <host>.trace.json.gz``, the JAX profiler's layout (``<run>`` a UTC
    timestamp, made unique within `logdir`)."""
    base = os.path.join(logdir, "plugins", "profile",
                        time.strftime("%Y_%m_%d_%H_%M_%S", time.gmtime()))
    run, n = base, 1
    while os.path.exists(run):
        run = f"{base}_{n}"
        n += 1
    return os.path.join(run, f"{socket.gethostname()}.trace.json.gz")


@contextlib.contextmanager
def trace(logdir: str, device: DeviceLike = None):
    """Capture a `torch.profiler` trace of everything inside the block:

        with profiling.trace("/tmp/trace"):
            step(...)
            torch.cuda.synchronize()

    The capture records the CPU, and the card's activity too when
    `device` is a card (None: cuda), without shapes. On exit the Chrome
    trace is written gzipped to `_trace_path(logdir)`; view it in
    ui.perfetto.dev, or attribute it with `obs.attribution`. Yields the
    ``torch.profiler.profile`` object."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=False)
    with prof:
        yield prof
        if dev.type == "cuda":
            # kernels still queued when the capture stops are lost
            torch.cuda.synchronize(dev)
    path = _trace_path(logdir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
