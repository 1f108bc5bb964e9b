"""PyTorch + CUDA port of distributed_embeddings_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package keeps its module
layout and names. It imports torch and never jax. Its entry points run on
the card unless the caller passes ``device="cpu"``; its kernels (the
lookup, the duplicate aggregation and the row-wise optimizer updates) are
hand-written CUDA (``csrc/``), built with nvcc at first use.
"""

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistEmbeddingStrategy,
    DistributedEmbedding,
)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding
from distributed_embeddings_tpu_torch.ops.embedding_ops import (
    RaggedIds,
    SparseIds,
    embedding_lookup,
)
from distributed_embeddings_tpu_torch.ops.sparse_update import (
    make_sparse_optimizer)
from distributed_embeddings_tpu_torch.serving.batcher import MicroBatcher
from distributed_embeddings_tpu_torch.serving.engine import InferenceEngine
from distributed_embeddings_tpu_torch.training import (fit,
                                                       make_sparse_train_step)

__all__ = [
    "embedding_lookup",
    "RaggedIds",
    "SparseIds",
    "Embedding",
    "DistEmbeddingStrategy",
    "DistributedEmbedding",
    "InferenceEngine",
    "MicroBatcher",
    "make_sparse_optimizer",
    "make_sparse_train_step",
    "fit",
]
