"""Versioned table store: training-to-serving weight streaming.

Counterpart of ``distributed_embeddings_tpu/store``: a training job owns
its layer's tables through a `TableStore`, publishes row-delta files
(deduplicated touched-row keys, their rows and a version header) every N
steps, and consumers apply them in place (`DeltaConsumer`), with no
restart and no full-table copy.
"""

from distributed_embeddings_tpu_torch.store.table_store import (
    DeltaChainError, DeltaConsumer, TableStore, restore_from_published,
    scan_published)

__all__ = [
    "DeltaChainError",
    "DeltaConsumer",
    "TableStore",
    "restore_from_published",
    "scan_published",
]
