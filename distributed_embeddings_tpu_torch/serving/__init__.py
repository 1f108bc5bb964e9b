"""Serving: apply-only inference over trained embedding models
(counterpart of ``distributed_embeddings_tpu/serving``).

  * `InferenceEngine` (engine.py): the apply-only forward over a
    `DistributedEmbedding` (and a dense model), padded to warmed shapes,
    owning a `TableStore` that consumes a training job's row deltas.
  * `HotRowCache` (cache.py): the device-resident cache of an offloaded
    bucket's hot rows, with counter-based admission and an explicit
    refresh.
  * `MicroBatcher` (batcher.py): coalesces variable-size requests into
    the engine's padded shapes and records the serving metrics.
"""

from distributed_embeddings_tpu_torch.serving.batcher import MicroBatcher
from distributed_embeddings_tpu_torch.serving.cache import HotRowCache
from distributed_embeddings_tpu_torch.serving.engine import InferenceEngine

__all__ = ["InferenceEngine", "HotRowCache", "MicroBatcher"]
