"""PyTorch + CUDA port of distributed_embeddings_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package keeps its module
layout and names. It imports torch and never jax. Its entry points run on
the card unless the caller passes ``device="cpu"``; its kernels (the
lookup, the duplicate aggregation and the row-wise optimizer updates) are
hand-written CUDA (``csrc/``), built with nvcc at first use. Several ranks
are the processes of a ``torch.distributed`` process group
(`initialize_distributed`).
"""

from distributed_embeddings_tpu_torch.version import __version__
from distributed_embeddings_tpu_torch.layers import dist_model_parallel
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistEmbeddingStrategy,
    DistributedEmbedding,
    broadcast_variables,
)
from distributed_embeddings_tpu_torch.layers.embedding import (
    ConcatOneHotEmbedding,
    Embedding,
    IntegerLookup,
)
from distributed_embeddings_tpu_torch.ops.embedding_ops import (
    RaggedIds,
    SparseIds,
    embedding_lookup,
)
from distributed_embeddings_tpu_torch.ops.sparse_update import (
    make_sparse_optimizer)
from distributed_embeddings_tpu_torch.parallel.mesh import (
    initialize_distributed)
from distributed_embeddings_tpu_torch.serving.batcher import MicroBatcher
from distributed_embeddings_tpu_torch.serving.engine import InferenceEngine
from distributed_embeddings_tpu_torch.training import (
    BroadcastGlobalVariablesCallback, DistributedGradientTape,
    DistributedOptimizer, fit, make_sparse_train_step)
from distributed_embeddings_tpu_torch.utils.device import (
    settle_cpu_vector_math)

settle_cpu_vector_math()

__all__ = [
    "__version__",
    "embedding_lookup",
    "RaggedIds",
    "SparseIds",
    "Embedding",
    "ConcatOneHotEmbedding",
    "IntegerLookup",
    "dist_model_parallel",
    "DistEmbeddingStrategy",
    "DistributedEmbedding",
    "InferenceEngine",
    "MicroBatcher",
    "make_sparse_optimizer",
    "make_sparse_train_step",
    "fit",
    "initialize_distributed",
    "broadcast_variables",
    "DistributedGradientTape",
    "DistributedOptimizer",
    "BroadcastGlobalVariablesCallback",
]
