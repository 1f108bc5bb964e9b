"""Bridging helpers: existing accounting surfaces -> registry.

Counterpart of ``distributed_embeddings_tpu/obs/instrument.py``. The
padding, byte and touched-row report
(`DistributedEmbedding.exchange_padding_report`) is the static model of
every per-step volume; `export_exchange_gauges` publishes its headline
fields as registry gauges, so SLO rules and snapshots address them as
they address runtime counters, and a test can hold the gauges a driven
run exported equal to a fresh report's fields.
"""

from typing import Optional

from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry

__all__ = ["export_exchange_gauges", "export_kernel_gauges",
           "EXCHANGE_GAUGE_FIELDS", "EXCHANGE_GROUP_GAUGE_FIELDS"]

# the JAX package's gate labels, each with the library of its counterpart
# kernels (`ops/kernel_build`): the raw-stream family, the row kernels, the
# lookup
KERNEL_GAUGE_LIBRARIES = {"tiled": "sorted_stream",
                          "pallas-dma": "sparse_apply",
                          "pallas": "lookup_combine"}


def export_kernel_gauges(registry: MetricRegistry) -> dict:
    """Set ``kernels/gate_verdict{impl=}`` gauges under the JAX package's
    labels (``tiled``, ``pallas-dma``, ``pallas``), so one rule file reads
    the same in both packages. The port has no kernel gates: a verdict is
    1 when the counterpart's library (`KERNEL_GAUGE_LIBRARIES`) has been
    built and loaded in this process by `ops.kernel_build.load`, and -1
    when it never was (a CPU run); a failed build raises, so 0 never
    occurs. Returns the verdict dict."""
    from distributed_embeddings_tpu_torch.ops import kernel_build
    loaded = kernel_build.loaded()
    verdicts = {impl: 1 if lib in loaded else -1
                for impl, lib in KERNEL_GAUGE_LIBRARIES.items()}
    for impl, verdict in verdicts.items():
        registry.gauge("kernels/gate_verdict", impl=impl).set(verdict)
    return verdicts


# top-level report fields exported as exchange/<field> gauges
EXCHANGE_GAUGE_FIELDS = (
    "true_ids", "exchanged_ids", "ratio",
    "exchanged_bytes", "true_bytes", "act_wire_reduction",
    "touched_rows_per_step", "delta_bytes_per_step",
    "occupancy", "slack_rows", "evictions_per_step",
    "prefetch_patch_rows_per_step", "prefetch_patch_bytes_per_step",
)

# per-group fields exported with a group= label
EXCHANGE_GROUP_GAUGE_FIELDS = (
    "touched_rows_per_step", "occupancy",
    "prefetch_patch_rows_per_step",
)


def export_exchange_gauges(registry: MetricRegistry, emb, *,
                           batch: int = 1, vocab=None, lookahead: int = 0,
                           hot_hit_rate=None,
                           hotness: Optional[list] = None) -> dict:
    """Set ``exchange/*`` gauges from one `exchange_padding_report` call
    (same arguments, same numbers); per-group entries land under a
    ``group=<index>`` label with the bucket index alongside. Returns the
    report."""
    rep = emb.exchange_padding_report(hotness=hotness,
                                      hot_hit_rate=hot_hit_rate,
                                      batch=batch, vocab=vocab,
                                      lookahead=lookahead)
    for field in EXCHANGE_GAUGE_FIELDS:
        registry.gauge(f"exchange/{field}").set(rep[field])
    for gi, entry in enumerate(rep["groups"]):
        for field in EXCHANGE_GROUP_GAUGE_FIELDS:
            registry.gauge(f"exchange/{field}", group=gi,
                           bucket=entry["bucket"]).set(entry[field])
    return rep
