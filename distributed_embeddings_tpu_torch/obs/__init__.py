"""Runtime telemetry: one metric registry, host-side step spans, SLO
rules, a bounded flight recorder with version-lineage tracks, and
device-time attribution from `torch.profiler` captures, across training,
serving, the store, the vocabulary and lookahead.

Counterpart of ``distributed_embeddings_tpu/obs/``; the short form:

    from distributed_embeddings_tpu_torch import obs

    reg = obs.MetricRegistry()            # or obs.default_registry()
    reg.counter("train/steps").inc()
    with obs.span("train/step", reg):
        ...
    snap = reg.snapshot()
    findings = obs.evaluate_rules(obs.load_rules("slo.json"), snap)
    obs.default_recorder().export("trace.json")   # Perfetto-loadable
    obs.attribution.attribute_logdir(profiler_logdir, registry=reg)
"""

from distributed_embeddings_tpu_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, LatencyHistogram, MetricRegistry, default_registry,
    metric_key, reset_default_registry)
from distributed_embeddings_tpu_torch.obs.slo import (  # noqa: F401
    evaluate_rules, load_rules, metric_value, summarize)
from distributed_embeddings_tpu_torch.obs.spans import (  # noqa: F401
    annotation, current_span, span)
from distributed_embeddings_tpu_torch.obs.instrument import (  # noqa: F401
    export_exchange_gauges, export_kernel_gauges)
from distributed_embeddings_tpu_torch.obs.trace import (  # noqa: F401
    FlightRecorder, default_recorder, dump_postmortem,
    reset_default_recorder)
from distributed_embeddings_tpu_torch.obs import attribution  # noqa: F401

__all__ = [
    "Counter", "Gauge", "LatencyHistogram", "MetricRegistry",
    "default_registry", "reset_default_registry", "metric_key",
    "span", "annotation", "current_span",
    "load_rules", "evaluate_rules", "metric_value", "summarize",
    "export_exchange_gauges", "export_kernel_gauges",
    "FlightRecorder", "default_recorder", "reset_default_recorder",
    "dump_postmortem", "attribution",
]
