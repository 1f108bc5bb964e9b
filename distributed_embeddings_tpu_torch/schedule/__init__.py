"""Step scheduling: the lookahead pipeline (`LookaheadEngine`)."""

from distributed_embeddings_tpu_torch.schedule.lookahead import (
    LookaheadEngine)

__all__ = ["LookaheadEngine"]
