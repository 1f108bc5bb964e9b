"""Weights carried across between the JAX package and the port.

The JAX package's parameter tree at world size 1 maps onto the port's
state dict one leaf to one tensor:

  * ``embedding['tp'][b]`` ``[world, rows_max, w]`` -> ``embedding.tp.{b}``
    (rank 0; the port's plan reproduces the bucket order and row offsets);
  * ``mlp[i]['w']`` / ``['b']`` -> ``mlp.{i}.w`` / ``.b`` (likewise
    ``bottom_mlp`` / ``top_mlp`` for DLRM), in the same [in, out] layout.

The data-parallel and row-sliced groups are empty at world size 1; a tree
that fills them (or carries hot shards or quantization scales) is refused.

The sparse train step's optimizer state maps the same way
(`opt_state_from_jax`, `opt_state_to_numpy`): ``emb['tp'][b]`` is a tuple
of ``[1, rows_max, w]`` state arrays (adam adds its step count), and the
dense part's optax state becomes the port's `training.DenseOptimizer`
state, keyed by parameter name.
"""

from typing import Dict

import numpy as np
import torch

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.models.dlrm import MLP

__all__ = ["params_from_jax", "params_to_numpy", "opt_state_from_jax",
           "opt_state_to_numpy"]


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


def _mlp_children(model):
    return [(name, child) for name, child in model.named_children()
            if isinstance(child, MLP)]


def _named_from_tree(tree: dict, model) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} from a dense-part tree ({mlp name: [{'w',
    'b'}, ...], 'embedding': {'dp': []}})."""
    out = {}
    for name, child in _mlp_children(model):
        for i, layer in enumerate(tree[name]):
            out[f"{name}.{i}.w"] = _tensor(layer["w"])
            out[f"{name}.{i}.b"] = _tensor(layer["b"])
    return out


def _tree_from_named(named: Dict[str, torch.Tensor], model) -> dict:
    tree = {"embedding": {"dp": []}}
    for name, child in _mlp_children(model):
        tree[name] = [{"w": named[f"{name}.{i}.w"].detach().cpu().numpy(),
                       "b": named[f"{name}.{i}.b"].detach().cpu().numpy()}
                      for i in range(len(child))]
    return tree


def _device(model) -> torch.device:
    return model.embedding.tp[0].device


def opt_state_from_jax(np_state: dict, model) -> dict:
    """The port's opt state (`training.make_sparse_train_step`) from the
    JAX package's, every leaf already ``np.asarray``-ed: ``{"emb": {"tp":
    [(acc[1, rows, w],)], "row": []}, "dense": optax chain state}`` (plus
    ``"count"`` under a schedule). Tensors land on `model`'s device."""
    dev = _device(model)
    emb = np_state["emb"]
    if len(emb.get("row", [])):
        raise ValueError("opt state for row-sliced tables: the port runs "
                         "world size 1, where every table is table-parallel")
    tp = []
    for entry in emb["tp"]:
        tp.append(tuple(
            _tensor(np.asarray(x)[0]).to(dev) if np.ndim(x) == 3
            else int(np.asarray(x)) for x in entry))
    dense: dict = {}
    for part in np_state["dense"]:
        # optax states are NamedTuples: read their fields (`count` is also
        # a tuple method)
        fields = getattr(part, "_fields", ())
        if "sum_of_squares" in fields:
            dense["sum_of_squares"] = {
                n: t.to(dev) for n, t in
                _named_from_tree(part.sum_of_squares, model).items()}
        elif "mu" in fields and "nu" in fields:
            dense["count"] = int(np.asarray(part.count))
            dense["mu"] = {n: t.to(dev) for n, t in
                           _named_from_tree(part.mu, model).items()}
            dense["nu"] = {n: t.to(dev) for n, t in
                           _named_from_tree(part.nu, model).items()}
        elif "count" in fields:
            dense["schedule_count"] = int(np.asarray(part.count))
    state = {"emb": {"tp": tp, "row": []}, "dense": dense}
    if "count" in np_state:
        state["count"] = int(np.asarray(np_state["count"]))
    return state


def opt_state_to_numpy(opt_state: dict, model) -> dict:
    """The port's opt state in the JAX package's layout with numpy leaves:
    ``emb['tp'][b]`` a tuple of ``[1, rows_max, w]`` arrays (and adam's
    int count); the dense part a dict of optax's field names
    (``sum_of_squares`` / ``count``, ``mu``, ``nu`` / ``schedule_count``)
    over dense-part trees."""
    tp = [tuple(x.detach().cpu().numpy()[None] if torch.is_tensor(x)
                else int(x) for x in entry)
          for entry in opt_state["emb"]["tp"]]
    dense = {}
    for key, val in opt_state["dense"].items():
        dense[key] = (_tree_from_named(val, model) if isinstance(val, dict)
                      else int(val))
    out = {"emb": {"tp": tp, "row": []}, "dense": dense}
    if "count" in opt_state:
        out["count"] = int(opt_state["count"])
    return out
