"""PyTorch + CUDA port of distributed_embeddings_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package keeps its module
layout and names. It imports torch and never jax. Its entry points run on
the card unless the caller passes ``device="cpu"``; the lookup kernel is
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
from distributed_embeddings_tpu_torch.serving.batcher import MicroBatcher
from distributed_embeddings_tpu_torch.serving.engine import InferenceEngine

__all__ = [
    "embedding_lookup",
    "RaggedIds",
    "SparseIds",
    "Embedding",
    "DistEmbeddingStrategy",
    "DistributedEmbedding",
    "InferenceEngine",
    "MicroBatcher",
]
