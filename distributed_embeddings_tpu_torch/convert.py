"""Weights carried across between the JAX package and the port.

The JAX package's parameter tree at world size 1 maps onto the port's
state dict one leaf to one tensor:

  * ``embedding['tp'][b]`` ``[world, rows_max, w]`` -> ``embedding.tp.{b}``
    (rank 0; the port's plan reproduces the bucket order and row offsets);
  * ``mlp[i]['w']`` / ``['b']`` -> ``mlp.{i}.w`` / ``.b`` (likewise
    ``bottom_mlp`` / ``top_mlp`` for DLRM), in the same [in, out] layout.

The data-parallel and row-sliced groups are empty at world size 1; a tree
that fills them (or carries hot shards or quantization scales) is refused.
"""

from typing import Dict

import numpy as np
import torch

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.models.dlrm import MLP

__all__ = ["params_from_jax", "params_to_numpy"]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _embedding_state(tree: dict, emb: DistributedEmbedding,
                     prefix: str) -> Dict[str, torch.Tensor]:
    extra = set(tree) - {"dp", "tp", "row"}
    if extra:
        raise ValueError(f"embedding params carry {sorted(extra)}, which the "
                         "port does not hold at world size 1")
    for group in ("dp", "row"):
        if len(tree.get(group, [])):
            raise ValueError(f"embedding params['{group}'] is not empty; the "
                             "port runs world size 1, where every table is "
                             "table-parallel")
    if len(tree["tp"]) != len(emb.tp):
        raise ValueError(f"{len(tree['tp'])} tp buckets, the port's plan has "
                         f"{len(emb.tp)}")
    state = {}
    for b, arr in enumerate(tree["tp"]):
        arr = np.asarray(arr)
        if arr.ndim != 3 or tuple(arr.shape[1:]) != tuple(emb.tp[b].shape):
            raise ValueError(f"tp bucket {b}: shape {arr.shape}, the port "
                             f"expects [world, {tuple(emb.tp[b].shape)}]")
        state[f"{prefix}tp.{b}"] = _tensor(arr[0])
    return state


def params_from_jax(np_params: dict, model) -> Dict[str, torch.Tensor]:
    """A state dict for `model` (a `DistributedEmbedding`, `SyntheticModel`
    or `DLRM` of the port) from the JAX package's parameter tree of the same
    configuration, every leaf already ``np.asarray``-ed. Load it with
    ``model.load_state_dict`` or `InferenceEngine.set_params`."""
    if isinstance(model, DistributedEmbedding):
        return _embedding_state(np_params, model, "")
    state = _embedding_state(np_params["embedding"], model.embedding,
                             "embedding.")
    for name, child in model.named_children():
        if isinstance(child, MLP):
            layers = np_params[name]
            if len(layers) != len(child):
                raise ValueError(f"{name}: {len(layers)} layers, the port "
                                 f"has {len(child)}")
            for i, layer in enumerate(layers):
                state[f"{name}.{i}.w"] = _tensor(layer["w"])
                state[f"{name}.{i}.b"] = _tensor(layer["b"])
    return state


def params_to_numpy(model) -> dict:
    """The JAX package's parameter tree (numpy leaves) of `model`."""
    def emb_tree(emb: DistributedEmbedding) -> dict:
        return {"dp": [], "row": [],
                "tp": [t.detach().cpu().numpy()[None] for t in emb.tp]}

    if isinstance(model, DistributedEmbedding):
        return emb_tree(model)
    tree = {"embedding": emb_tree(model.embedding)}
    for name, child in model.named_children():
        if isinstance(child, MLP):
            tree[name] = [{"w": layer.w.detach().cpu().numpy(),
                           "b": layer.b.detach().cpu().numpy()}
                          for layer in child]
    return tree
