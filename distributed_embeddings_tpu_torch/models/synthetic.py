"""Synthetic benchmark model zoo.

Counterpart of ``distributed_embeddings_tpu/models/synthetic.py``: the same
seven configurations (numerically identical to the reference's
config_v3.py), the same power-law input generator (it draws from
``np.random.RandomState`` in the same order, so a seed gives identical ids
in both packages), the forward: embeddings -> concat (or strided
average pooling) -> MLP -> logit, and the BCE loss of the training step.
"""

from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding, broadcast_variables)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding
from distributed_embeddings_tpu_torch.models.dlrm import MLP, bce_loss
from distributed_embeddings_tpu_torch.utils.device import (
    DeviceLike, default_generator, resolve_compute_dtype, resolve_device)


class EmbeddingConfig(NamedTuple):
    num_tables: int
    nnz: List[int]       # hotness per input; len>1 => shared table, many inputs
    num_rows: int
    width: int
    shared: bool


class ModelConfig(NamedTuple):
    name: str
    embedding_configs: List[EmbeddingConfig]
    mlp_sizes: List[int]
    num_numerical_features: int
    interact_stride: Optional[int]


# Benchmark-defining constants (values match reference config_v3.py:30-142).
SYNTHETIC_MODELS = {
    "criteo": ModelConfig(
        "Criteo-dlrm-like",
        [EmbeddingConfig(26, [1], 100000, 128, False)],
        [512, 256, 128], 13, None),
    "tiny": ModelConfig(
        "Tiny V3",
        [EmbeddingConfig(1, [1, 10], 10000, 8, True),
         EmbeddingConfig(1, [1, 10], 1000000, 16, True),
         EmbeddingConfig(1, [1, 10], 25000000, 16, True),
         EmbeddingConfig(1, [1], 25000000, 16, False),
         EmbeddingConfig(16, [1], 10, 8, False),
         EmbeddingConfig(10, [1], 1000, 8, False),
         EmbeddingConfig(4, [1], 10000, 8, False),
         EmbeddingConfig(2, [1], 100000, 16, False),
         EmbeddingConfig(19, [1], 1000000, 16, False)],
        [256, 128], 10, None),
    "small": ModelConfig(
        "Small V3",
        [EmbeddingConfig(5, [1, 30], 10000, 16, True),
         EmbeddingConfig(3, [1, 30], 4000000, 32, True),
         EmbeddingConfig(1, [1, 30], 50000000, 32, True),
         EmbeddingConfig(1, [1], 50000000, 32, False),
         EmbeddingConfig(30, [1], 10, 16, False),
         EmbeddingConfig(30, [1], 1000, 16, False),
         EmbeddingConfig(5, [1], 10000, 16, False),
         EmbeddingConfig(5, [1], 100000, 32, False),
         EmbeddingConfig(27, [1], 4000000, 32, False)],
        [512, 256, 128], 10, None),
    "medium": ModelConfig(
        "Medium v3",
        [EmbeddingConfig(20, [1, 50], 100000, 64, True),
         EmbeddingConfig(5, [1, 50], 10000000, 64, True),
         EmbeddingConfig(1, [1, 50], 100000000, 128, True),
         EmbeddingConfig(1, [1], 100000000, 128, False),
         EmbeddingConfig(80, [1], 10, 32, False),
         EmbeddingConfig(60, [1], 1000, 32, False),
         EmbeddingConfig(80, [1], 100000, 64, False),
         EmbeddingConfig(24, [1], 200000, 64, False),
         EmbeddingConfig(40, [1], 10000000, 64, False)],
        [1024, 512, 256, 128], 25, 7),
    "large": ModelConfig(
        "Large v3",
        [EmbeddingConfig(40, [1, 100], 100000, 64, True),
         EmbeddingConfig(16, [1, 100], 15000000, 64, True),
         EmbeddingConfig(1, [1, 100], 200000000, 128, True),
         EmbeddingConfig(1, [1], 200000000, 128, False),
         EmbeddingConfig(100, [1], 10, 32, False),
         EmbeddingConfig(100, [1], 10000, 32, False),
         EmbeddingConfig(160, [1], 100000, 64, False),
         EmbeddingConfig(50, [1], 500000, 64, False),
         EmbeddingConfig(144, [1], 15000000, 64, False)],
        [2048, 1024, 512, 256], 100, 8),
    "jumbo": ModelConfig(
        "Jumbo v3",
        [EmbeddingConfig(50, [1, 200], 100000, 128, True),
         EmbeddingConfig(24, [1, 200], 20000000, 128, True),
         EmbeddingConfig(1, [1, 200], 400000000, 256, True),
         EmbeddingConfig(1, [1], 400000000, 256, False),
         EmbeddingConfig(100, [1], 10, 32, False),
         EmbeddingConfig(200, [1], 10000, 64, False),
         EmbeddingConfig(350, [1], 100000, 128, False),
         EmbeddingConfig(80, [1], 1000000, 128, False),
         EmbeddingConfig(216, [1], 20000000, 128, False)],
        [2048, 1024, 512, 256], 200, 20),
    "colossal": ModelConfig(
        "Colossal v3",
        [EmbeddingConfig(100, [1, 300], 100000, 128, True),
         EmbeddingConfig(50, [1, 300], 40000000, 256, True),
         EmbeddingConfig(1, [1, 300], 2000000000, 256, True),
         EmbeddingConfig(1, [1], 1000000000, 256, False),
         EmbeddingConfig(100, [1], 10, 32, False),
         EmbeddingConfig(400, [1], 10000, 128, False),
         EmbeddingConfig(100, [1], 100000, 128, False),
         EmbeddingConfig(800, [1], 1000000, 128, False),
         EmbeddingConfig(450, [1], 40000000, 256, False)],
        [4096, 2048, 1024, 512, 256], 500, 30),
}


def expand_embedding_configs(model_config: ModelConfig):
    """Flatten EmbeddingConfigs into (table specs, input_table_map, hotness).
    A config with len(nnz) > 1 and shared=True creates num_tables tables each
    fed by len(nnz) inputs."""
    tables, table_map, hotness = [], [], []
    for cfg in model_config.embedding_configs:
        if len(cfg.nnz) > 1 and not cfg.shared:
            raise NotImplementedError(
                "Non-shared multi-hot embedding is not implemented")
        for _ in range(cfg.num_tables):
            tables.append((cfg.num_rows, cfg.width))
            for h in cfg.nnz:
                table_map.append(len(tables) - 1)
                hotness.append(h)
    return tables, table_map, hotness


def power_law(k_min, k_max, alpha, r):
    """Map U(0,1) samples to a power-law distribution."""
    gamma = 1 - alpha
    return ((r * (k_max ** gamma - k_min ** gamma) + k_min ** gamma)
            ** (1.0 / gamma)).astype(np.int64)


def gen_power_law_data(batch_size, hotness, num_rows, alpha, rng=None):
    rng = rng or np.random
    y = power_law(1, num_rows + 1, alpha, rng.rand(batch_size * hotness)) - 1
    return y.reshape(batch_size, hotness)


class InputGenerator:
    """Synthetic input generator: (numerical [B, n], categorical list of
    [B, hotness] int32, labels [B, 1]) as CPU tensors, where requests
    arrive. alpha=0 -> uniform ids; alpha>0 -> power-law ids."""

    def __init__(self, model_config: ModelConfig, global_batch_size: int,
                 alpha: float = 0.0, num_batches: int = 10, seed: int = 0):
        rng = np.random.RandomState(seed)
        tables, table_map, hotness = expand_embedding_configs(model_config)
        self.batches = []
        for _ in range(num_batches):
            cats = []
            for inp, t in enumerate(table_map):
                rows = tables[t][0]
                h = hotness[inp]
                if alpha == 0.0:
                    ids = rng.randint(0, rows, size=(global_batch_size, h))
                else:
                    ids = gen_power_law_data(global_batch_size, h, rows, alpha,
                                             rng)
                cats.append(torch.from_numpy(ids.astype(np.int32)))
            numerical = torch.from_numpy(
                rng.rand(global_batch_size,
                         model_config.num_numerical_features).astype(np.float32)
                * 100.0)
            labels = torch.from_numpy(
                rng.randint(0, 2, size=(global_batch_size, 1)).astype(
                    np.float32))
            self.batches.append((numerical, cats, labels))

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, idx):
        return self.batches[idx]


class ClickGenerator:
    """Learnable synthetic click stream (the JAX package's, in numpy):
    each table t has a hidden per-row score s_t ~ N(0,1), the numerical
    features a hidden weight vector, and

        logit* = scale * (sum_t s_t[id_t] + w . x) / sqrt(T + 1)
        label  ~ Bernoulli(sigmoid(logit*))

    With the default scale the Bayes AUC is about 0.85, so a model past
    AUC 0.70 has learned embedding structure (random embeddings give 0.5).
    Ids are power-law distributed (alpha > 0) or uniform. Deterministic
    per (seed, step), and bit-equal to the JAX package's generator:
    ``batch(step)`` draws from ``np.random.RandomState`` in the same order.
    A batch is ``(x [B, n] f32, [ids [B] int32 per table], labels [B]
    f32)``, numpy on the host; the object is a `fit` data callable."""

    def __init__(self, table_sizes, num_numerical: int, batch_size: int,
                 alpha: float = 1.05, scale: float = 3.0, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.table_sizes = list(table_sizes)
        self.num_numerical = num_numerical
        self.batch_size = batch_size
        self.alpha = alpha
        self.scale = scale
        self.seed = seed
        self.scores = [rng.randn(v).astype(np.float32)
                       for v in self.table_sizes]
        self.w_num = rng.randn(num_numerical).astype(np.float32)

    def batch(self, step: int):
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2 ** 31))
        cats, total = [], 0.0
        for t, rows in enumerate(self.table_sizes):
            if self.alpha > 0:
                ids = gen_power_law_data(self.batch_size, 1, rows,
                                         self.alpha, rng)[:, 0]
            else:
                ids = rng.randint(0, rows, size=self.batch_size)
            cats.append(ids.astype(np.int32))
            total = total + self.scores[t][ids]
        x = rng.rand(self.batch_size, self.num_numerical).astype(np.float32)
        total = total + x @ self.w_num
        logit = self.scale * total / np.sqrt(len(self.table_sizes) + 1)
        labels = (rng.rand(self.batch_size)
                  < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
        return x, cats, labels

    def __call__(self, step: int):
        return self.batch(step)


def _avg_pool_1d(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Strided 'same' average pooling along the feature axis; padding
    positions are excluded from each window's average. In `x`'s dtype, as
    the JAX package computes it: each window summed in float32 (jnp.sum's
    upcast) and rounded once, then divided by its count."""
    b, c = x.shape
    pad = (-c) % stride
    xp = torch.nn.functional.pad(x, (0, pad))
    win = xp.reshape(b, -1, stride)
    counts = torch.nn.functional.pad(
        torch.ones((c,), dtype=x.dtype, device=x.device),
        (0, pad)).reshape(-1, stride)
    return (win.sum(dim=-1, dtype=torch.float32).to(x.dtype)
            / counts.sum(dim=-1)[None, :])


class SyntheticModel(nn.Module):
    """Synthetic recommender: embeddings -> interact -> MLP -> logit.

    The tables are fused through `DistributedEmbedding` (hotness hints
    always passed; ``mesh``, ``column_slice_threshold``, ``strategy``,
    ``dp_input`` and `dist_kwargs` go to it, ``lookup_path`` among them:
    the JAX package's ``DET_LOOKUP_PATH``). ``distributed=False`` is the
    JAX package's per-table comparison model (the reference's 'native'
    model): one `Embedding` a table, ``embedding_layers[t]``, holding its
    own table, looked up per input, no exchange; it trains through the
    dense step (`training.make_train_step`). ``compute_dtype`` (None,
    float32, bfloat16 or float16): the embedding outputs, the pooling and
    the numerical input in that dtype, the MLP promoted to its float32
    weights, as in the JAX package. ``device`` (None = cuda) and
    ``generator`` (default: seed 0 on `device`) place and draw every
    parameter, embedding tables included, on the device itself. In a
    process group of more than one rank the layer spans its ranks, each
    holding its share of the tables, and every rank takes rank 0's MLP.
    """

    def __init__(self, model_config: ModelConfig, mesh=None,
                 column_slice_threshold=None, distributed: bool = True,
                 strategy: str = "auto", dp_input: bool = True,
                 compute_dtype=None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, **dist_kwargs):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        dist_kwargs.update(mesh=mesh, strategy=strategy,
                           column_slice_threshold=column_slice_threshold,
                           dp_input=dp_input,
                           compute_dtype=self.compute_dtype)
        device = resolve_device(device)
        gen = default_generator(device, generator)
        self.config = model_config
        tables, table_map, self.hotness = expand_embedding_configs(model_config)
        self.table_map = table_map
        self.num_numerical_features = model_config.num_numerical_features
        self.distributed = distributed
        if distributed:
            # table configs only: the fused buckets hold the weights
            self.embedding_layers = [
                Embedding(rows, width, combiner="sum", device="meta")
                for rows, width in tables]
            dist_kwargs.setdefault("input_max_hotness", list(self.hotness))
            self.embedding = DistributedEmbedding(
                self.embedding_layers, input_table_map=table_map,
                device=device, generator=gen, **dist_kwargs)
        else:
            self.embedding_layers = nn.ModuleList([
                Embedding(rows, width, combiner="sum", device=device,
                          generator=gen) for rows, width in tables])
        self.interact_stride = model_config.interact_stride

        emb_out_width = sum(tables[t][1] for t in table_map)
        if self.interact_stride is not None:
            emb_out_width = -(-emb_out_width // self.interact_stride)
        self.mlp_in = emb_out_width + model_config.num_numerical_features
        self.mlp_sizes = list(model_config.mlp_sizes) + [1]
        self.mlp = MLP(self.mlp_sizes, self.mlp_in, device, gen)
        self.device = device
        # every rank starts from rank 0's dense parameters (each drew them
        # after its own share of the tables)
        broadcast_variables(self)

    def forward(self, numerical, cat_features, taps=None,
                return_residuals: bool = False):
        """[B, n] numerical + categorical ids -> [B, 1] logits; with
        `return_residuals`, ``(logits, TapResiduals)`` (see
        `DistributedEmbedding.forward` for `taps`)."""
        if self.distributed:
            embs = self.embedding(list(cat_features), taps=taps,
                                  return_residuals=return_residuals)
            embs, res = embs if return_residuals else (embs, None)
        else:
            if taps is not None or return_residuals:
                raise ValueError("the per-table model (distributed=False) "
                                 "has no taps: train it with the dense step")
            res = None
            embs = [self.embedding_layers[t](ids)
                    for t, ids in zip(self.table_map, cat_features)]
        dtype = self.compute_dtype or torch.float32
        x = torch.cat([e.to(dtype) for e in embs], dim=1)
        if self.interact_stride is not None:
            x = _avg_pool_1d(x, self.interact_stride)
        numerical = torch.as_tensor(numerical, dtype=torch.float32,
                                    device=self.device).to(dtype)
        out = self.mlp(torch.cat([x, numerical], dim=1))
        return (out, res) if return_residuals else out

    def loss_fn(self, numerical, cat_features, labels, taps=None,
                return_residuals: bool = False):
        """Sigmoid binary cross-entropy, mean over the batch."""
        return bce_loss(self, numerical, cat_features, labels, taps,
                        return_residuals)
