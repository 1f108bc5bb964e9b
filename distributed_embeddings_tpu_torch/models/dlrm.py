"""DLRM: bottom MLP -> embedding lookups -> dot interaction -> top MLP.

Counterpart of ``distributed_embeddings_tpu/models/dlrm.py``: the forward,
the BCE loss and the learning-rate schedule. MLP kernels keep the JAX
package's [in, out] layout, so weights map across as they are.
"""

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding, broadcast_variables)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding
from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           default_generator,
                                                           resolve_device)


def dlrm_initializer():
    """Uniform(+-1/sqrt(rows)) embedding init (reference utils.py:27-41)."""
    def init(out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        maxval = 1.0 / math.sqrt(out.shape[0])
        return out.uniform_(-maxval, maxval, generator=generator)
    return init


def dot_interact(emb_outs: Sequence[torch.Tensor],
                 bottom_mlp_out: torch.Tensor) -> torch.Tensor:
    """Pairwise-dot feature interaction: the strictly-lower-triangular
    entries of the Gram matrix of [bottom_mlp_out] + emb_outs, then the
    bottom MLP output re-concatenated."""
    feats = torch.stack([bottom_mlp_out] + list(emb_outs), dim=1)  # [B, n, d]
    gram = torch.bmm(feats, feats.transpose(1, 2))
    n = feats.shape[1]
    rows, cols = np.tril_indices(n, k=-1)
    idx = torch.as_tensor(rows * n + cols, device=feats.device)
    pairwise = gram.reshape(gram.shape[0], n * n)[:, idx]
    return torch.cat([pairwise, bottom_mlp_out], dim=1)


class Dense(nn.Module):
    """``x @ w + b`` with w [in, out], as the JAX package lays it out."""

    def __init__(self, in_dim: int, out_dim: int, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        # glorot-normal kernel, bias ~ N(0, 1/out) (reference main.py:127-139)
        std = math.sqrt(2.0 / (in_dim + out_dim))
        self.w = nn.Parameter(torch.empty((in_dim, out_dim), device=device)
                              .normal_(0.0, std, generator=generator))
        self.b = nn.Parameter(torch.empty((out_dim,), device=device).normal_(
            0.0, math.sqrt(1.0 / out_dim), generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w) + self.b


class MLP(nn.ModuleList):
    """Dense layers with relu between them (and after the last with
    `final_activation`); ``mlp[i].w`` / ``mlp[i].b`` are the JAX package's
    ``params[i]['w']`` / ``['b']``."""

    def __init__(self, dims: List[int], in_dim: int, device: torch.device,
                 generator: torch.Generator, final_activation: bool = False):
        layers = []
        for out_dim in dims:
            layers.append(Dense(in_dim, out_dim, device, generator))
            in_dim = out_dim
        super().__init__(layers)
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self):
            x = layer(x)
            if i < len(self) - 1 or self.final_activation:
                x = torch.relu(x)
        return x


class DLRM(nn.Module):
    """DLRM with fused table-parallel embeddings.

    Args mirror the JAX package's class; `dist_kwargs` go to
    `DistributedEmbedding` (strategy 'memory_balanced' unless given;
    ``lookup_path`` picks its lookup, as ``DET_LOOKUP_PATH`` does there).
    ``device`` (None = cuda) and ``generator`` (default: seed 0 on
    `device`) place and draw every parameter; in a process group of more
    than one rank, each rank holds its share of the tables and every rank
    takes rank 0's MLPs. Forward: ``[B, num_numerical]`` + categorical ids
    -> ``[B, 1]`` logits.
    """

    def __init__(self,
                 table_sizes: Sequence[int],
                 embedding_dim: int = 128,
                 bottom_mlp_dims: Sequence[int] = (512, 256, 128),
                 top_mlp_dims: Sequence[int] = (1024, 1024, 512, 256, 1),
                 num_numerical_features: int = 13,
                 *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 **dist_kwargs):
        super().__init__()
        device = resolve_device(device)
        gen = default_generator(device, generator)
        self.table_sizes = list(table_sizes)
        self.embedding_dim = embedding_dim
        self.num_numerical_features = num_numerical_features
        embeddings = [
            Embedding(v, embedding_dim,
                      embeddings_initializer=dlrm_initializer(),
                      device="meta")
            for v in self.table_sizes
        ]
        dist_kwargs.setdefault("strategy", "memory_balanced")
        self.embedding = DistributedEmbedding(
            embeddings, device=device, generator=gen, **dist_kwargs)
        n_feats = len(self.table_sizes) + 1
        interact_dim = n_feats * (n_feats - 1) // 2 + bottom_mlp_dims[-1]
        self.bottom_mlp = MLP(list(bottom_mlp_dims), num_numerical_features,
                              device, gen, final_activation=True)
        self.top_mlp = MLP(list(top_mlp_dims), interact_dim, device, gen)
        # every rank starts from rank 0's dense parameters (each drew them
        # after its own share of the tables)
        broadcast_variables(self)

    def forward(self, numerical, categorical, taps=None,
                return_residuals: bool = False):
        """With `return_residuals`, ``(logits, TapResiduals)`` (see
        `DistributedEmbedding.forward` for `taps`)."""
        dev = self.embedding.device
        x = torch.as_tensor(numerical, dtype=torch.float32, device=dev)
        bottom = self.bottom_mlp(x)
        emb_outs = self.embedding(list(categorical), taps=taps,
                                  return_residuals=return_residuals)
        emb_outs, res = (emb_outs if return_residuals else (emb_outs, None))
        out = self.top_mlp(dot_interact(emb_outs, bottom))
        return (out, res) if return_residuals else out

    def loss_fn(self, numerical, categorical, labels, taps=None,
                return_residuals: bool = False):
        """Sigmoid binary cross-entropy, mean over the batch."""
        return bce_loss(self, numerical, categorical, labels, taps,
                        return_residuals)


def bce_loss(model, numerical, cats, labels, taps=None,
             return_residuals: bool = False):
    """The JAX package's loss: ``mean(max(l, 0) - l*y + log1p(exp(-|l|)))``
    over the logits l of ``model(numerical, cats)`` and labels y; with
    `return_residuals`, ``(loss, TapResiduals)``."""
    out = model(numerical, cats, taps=taps,
                return_residuals=return_residuals)
    logits, res = out if return_residuals else (out, None)
    logits = logits[:, 0].float()
    labels = torch.as_tensor(labels, dtype=torch.float32,
                             device=logits.device).reshape(-1)
    loss = torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    return (loss, res) if return_residuals else loss


def make_lr_schedule(base_lr: float, warmup_steps: int, decay_start_step: int,
                     decay_steps: int, poly_power: int = 2):
    """Warmup -> constant -> polynomial decay (the JAX package's schedule,
    reference utils.py:45-88): step -> lr, a host float computed in
    float32 arithmetic as the JAX package computes it."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(int(step))
        with np.errstate(divide="ignore", invalid="ignore"):
            warmup = (f32(1.0)
                      - (f32(warmup_steps) - step) / f32(warmup_steps))
            decay_end = decay_start_step + decay_steps
            decay = np.clip((f32(decay_end) - step) / f32(decay_steps),
                            f32(0.0), f32(1.0)) ** poly_power
        factor = (warmup if step < warmup_steps
                  else (f32(1.0) if step < decay_start_step else decay))
        return float(f32(base_lr) * f32(factor))
    return schedule
