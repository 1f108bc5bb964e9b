"""Dynamic vocabulary: streaming admission of new raw keys, cold-row
eviction and growth inside pre-reserved slack rows (counterpart of
``distributed_embeddings_tpu/vocab``). See `vocab.manager`."""

from distributed_embeddings_tpu_torch.vocab.manager import (
    ManagedVocab, VocabManager, default_admit_threshold, latest_vocab_state,
    vocab_state_path)

__all__ = ["ManagedVocab", "VocabManager", "default_admit_threshold",
           "latest_vocab_state", "vocab_state_path"]
