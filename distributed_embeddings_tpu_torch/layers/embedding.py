"""Single-device embedding layer.

Counterpart of ``distributed_embeddings_tpu/layers/embedding.py``
`Embedding`, as an ``nn.Module`` that owns its table. A layer built on the
``meta`` device holds no memory and serves only as a table config, which is
how `DistributedEmbedding` and the models use it.
"""

from typing import Optional

import torch
from torch import nn

from distributed_embeddings_tpu_torch.ops import cuda_lookup, embedding_ops
from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           default_generator,
                                                           resolve_device)
from distributed_embeddings_tpu_torch.utils.initializers import (
    get_initializer)


class Embedding(nn.Module):
    """Turns indices into fixed-size vectors, with optional built-in combine.

    Supported inputs when combiner is set: N-D dense ids, 2-D RaggedIds,
    2-D SparseIds. Combined multi-hot dense input goes through the CUDA
    lookup kernel (its plain version on a CPU table).

    Args:
      input_dim: vocabulary size.
      output_dim: embedding width.
      embeddings_initializer: initializer spec (see utils.initializers).
      combiner: None | 'sum' | 'mean'.
      dtype: parameter dtype.
      device: where the table lives (None = cuda; 'meta' = config only).
      generator: draws the initial table (default: seed 0 on `device`).
    """

    def __init__(self,
                 input_dim: int,
                 output_dim: int,
                 embeddings_initializer="uniform",
                 combiner: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_dim <= 0 or output_dim <= 0:
            raise ValueError(
                f"Both input_dim and output_dim should be positive, "
                f"found {input_dim} and {output_dim}")
        if combiner not in (None, "sum", "mean"):
            raise ValueError(f"Unsupported combiner {combiner}")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.embeddings_initializer = embeddings_initializer
        self.combiner = combiner
        self.dtype = dtype
        self.name = name
        device = resolve_device(device)
        self.embeddings = nn.Parameter(
            torch.empty((input_dim, output_dim), dtype=dtype, device=device),
            requires_grad=False)
        if device.type != "meta":
            get_initializer(embeddings_initializer)(
                self.embeddings.data, default_generator(device, generator))

    def forward(self, inputs):
        table = self.embeddings
        ids = inputs
        if isinstance(ids, (embedding_ops.RaggedIds, embedding_ops.SparseIds)):
            return embedding_ops.embedding_lookup(table, ids,
                                                  combiner=self.combiner)
        ids = torch.as_tensor(ids, device=table.device)
        out_shape = None
        if ids.dim() == 1:
            if self.combiner is not None:
                raise ValueError("1D input with combiner is ambiguous. "
                                 "Please create batch dimension.")
            ids = ids.reshape(-1, 1)
            out_shape = (-1, self.output_dim)
        elif ids.dim() > 2:
            # reduce over the last dim only
            if self.combiner is not None:
                out_shape = (-1,) + tuple(ids.shape[1:-1]) + (self.output_dim,)
            else:
                out_shape = (-1,) + tuple(ids.shape[1:]) + (self.output_dim,)
            ids = ids.reshape(-1, ids.shape[-1])
        if self.combiner is not None and ids.dim() == 2 and ids.shape[1] > 1:
            out = cuda_lookup.fused_embedding_lookup(table, ids,
                                                     combiner=self.combiner)
        else:
            out = embedding_ops.embedding_lookup(table, ids,
                                                 combiner=self.combiner)
        if out_shape is not None:
            out = out.reshape(out_shape)
        return out

    @classmethod
    def from_config(cls, config: dict) -> "Embedding":
        """A layer of `config`'s table (`get_config`'s keys; others are
        ignored), built on the ``meta`` device: a config whose table is
        held elsewhere."""
        keys = ("input_dim", "output_dim", "embeddings_initializer",
                "combiner", "dtype", "name")
        return cls(**{k: config[k] for k in keys if k in config},
                   device="meta")

    def compute_output_shape(self, input_shape):
        """The output shape for ids of `input_shape`: one row per id
        without a combiner, else one per id row (the last axis
        combined)."""
        if self.combiner is None:
            return tuple(input_shape) + (self.output_dim,)
        return tuple(input_shape[:-1]) + (self.output_dim,)

    def get_config(self) -> dict:
        return {
            "input_dim": self.input_dim,
            "output_dim": self.output_dim,
            "embeddings_initializer": self.embeddings_initializer,
            "combiner": self.combiner,
            "dtype": self.dtype,
            "name": self.name,
        }
