from distributed_embeddings_tpu_torch.layers.embedding import (
    ConcatOneHotEmbedding,
    Embedding,
    IntegerLookup,
)
