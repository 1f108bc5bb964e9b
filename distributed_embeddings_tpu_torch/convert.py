"""Weights carried across between the JAX package and the port.

The JAX package's parameter tree maps onto the port's state dict one leaf
to one tensor, on every rank of a world of the same size:

  * ``embedding['dp'][j]`` ``[V, w]`` -> ``embedding.dp.{j}`` (replicated:
    every rank takes it whole);
  * ``embedding['tp'][b]`` ``[world, rows_max, w]`` -> ``embedding.tp.{b}``
    (rank r takes ``[r]``; the port's plan reproduces the bucket order,
    the placement and the row offsets);
  * ``embedding['row'][t]`` ``[world, rows_max, w]`` -> ``embedding.row.{t}``
    (rank r takes its shard ``[r]``);
  * a quantized layer's ``embedding['tp_scale'][b]`` ``[world, rows_max,
    1]`` -> ``embedding.tp_scale.{b}``, and its 1-byte ``tp`` payloads
    whole: int8 as int8, fp8 by its bytes (the JAX package's
    ``ml_dtypes.float8_e4m3fn`` array, or the raw 1-byte void a ``.npz``
    gives back) viewed as ``torch.float8_e4m3fn``; towards the JAX layout
    an fp8 payload is its bytes, ``uint8``, which the JAX package views
    back as float8;
  * ``mlp[i]['w']`` / ``['b']`` -> ``mlp.{i}.w`` / ``.b`` (likewise
    ``bottom_mlp`` / ``top_mlp`` for DLRM), in the same [in, out] layout;
  * the per-table model's (``SyntheticModel(distributed=False)``)
    ``embedding[t]['embeddings']`` -> ``embedding_layers.{t}.embeddings``;
  * a `ConcatOneHotEmbedding`'s ``{'params': [sum(sizes), w]}`` ->
    ``params``.

  * a hot-sharded layer's ``embedding['hot'][b]`` (None, or ``{'ids':
    [H] int32, 'rows': [H, w]}`` for a hot bucket) -> the buffers
    ``embedding.hot_ids_{b}`` and ``embedding.hot_rows_{b}``, the same on
    every rank (replicated, not stacked).

The sparse train step's optimizer state maps the same way
(`opt_state_from_jax`, `opt_state_to_numpy`): ``emb['tp'][b]`` and
``emb['row'][t]`` are tuples of ``[world, rows_max, w]`` state arrays
(adam adds its step count), ``emb['hot'][i]`` (one per hot bucket, in
bucket order) tuples of ``[H, w]`` arrays, every rank taking them whole,
and the dense part's optax state (over the
MLPs and ``embedding['dp']``) becomes the port's
`training.DenseOptimizer` state, keyed by parameter name. Towards the JAX
layout, at world size > 1, each rank-local array is gathered from every
rank (a collective: every rank calls `params_to_numpy` and
`opt_state_to_numpy`).
"""

from typing import Dict

import numpy as np
import torch

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import (
    ConcatOneHotEmbedding)
from distributed_embeddings_tpu_torch.models.dlrm import MLP
from distributed_embeddings_tpu_torch.ops import wire
from distributed_embeddings_tpu_torch.parallel.mesh import gather_stack

__all__ = ["params_from_jax", "params_to_numpy", "opt_state_from_jax",
           "opt_state_to_numpy"]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _payload(a, store_dtype: str) -> torch.Tensor:
    """A bucket's payload from the JAX package's array: float32 as such,
    a 1-byte payload by its bytes, viewed as the storage dtype (numpy
    holds fp8 only as bytes; ``ml_dtypes`` is not imported)."""
    if store_dtype == "f32":
        return _tensor(a)
    raw = np.ascontiguousarray(a)
    if raw.dtype.itemsize != 1:
        raise ValueError(f"a {store_dtype} payload has 1-byte elements, got "
                         f"{raw.dtype}")
    return torch.from_numpy(raw.view(np.uint8).copy()).view(
        wire.payload_dtype(store_dtype))


def _array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of `t` (on the CPU, `.numpy()` alone would share the
    live parameter's storage, which later steps update in place)."""
    return t.detach().cpu().numpy().copy()


def _stacked(t: torch.Tensor) -> np.ndarray:
    """A rank-local ``[rows_max, w]`` array as the JAX package's ``[world,
    rows_max, w]`` stack (gathered from every rank at world size > 1)."""
    return _array(gather_stack(t.detach()))


def _stacked_payload(t: torch.Tensor) -> np.ndarray:
    """A bucket's ``[world, rows_max, w]`` payload stack: float32, int8, or
    an fp8 payload's bytes as uint8."""
    if t.dtype == torch.float32:
        return _stacked(t)
    stack = _stacked(t.view(torch.uint8))
    return stack.view(np.int8) if t.dtype == torch.int8 else stack


def _embedding_state(tree: dict, emb: DistributedEmbedding,
                     prefix: str) -> Dict[str, torch.Tensor]:
    extra = set(tree) - {"dp", "tp", "row", "tp_scale", "hot"}
    if extra:
        raise ValueError(f"embedding params carry {sorted(extra)}, which the "
                         "port does not hold yet")
    hot = tree.get("hot")
    if bool(emb._hot_buckets) != (hot is not None):
        raise ValueError(
            "the tree's hot shards do not match the layer's: hot buckets "
            f"{emb._hot_buckets}, hot {'present' if hot else 'absent'}")
    quantized = emb.quantized_buckets
    if bool(quantized) != (tree.get("tp_scale") is not None):
        raise ValueError(
            "the tree's tp_scale does not match the layer's storage: "
            f"quantized buckets {quantized}, tp_scale "
            f"{'present' if tree.get('tp_scale') is not None else 'absent'}")
    state = {}
    for b, entry in enumerate(hot or []):
        if (entry is None) != (b not in emb._hot_buckets):
            raise ValueError(f"hot {b}: the tree and the layer disagree on "
                             "whether the bucket is hot-sharded")
        if entry is None:
            continue
        ids, rows = emb._hot_entry(b)
        for name, arr, want in (("ids", entry["ids"], ids),
                                ("rows", entry["rows"], rows)):
            arr = np.asarray(arr)
            if arr.shape != tuple(want.shape):
                raise ValueError(f"hot {b} {name}: shape {arr.shape}, the "
                                 f"port expects {tuple(want.shape)}")
            state[f"{prefix}hot_{name}_{b}"] = torch.from_numpy(
                np.array(arr, dtype=np.int32 if name == "ids"
                         else np.float32, order="C"))
    for b, scale in enumerate(tree.get("tp_scale") or []):
        if b not in quantized:
            state[f"{prefix}tp_scale.{b}"] = torch.empty((0, 1))
            continue
        scale = np.asarray(scale)
        if scale.shape != (emb.world_size,) + tuple(emb.tp[b].shape[:1]) \
                + (1,):
            raise ValueError(f"tp_scale {b}: shape {scale.shape}")
        state[f"{prefix}tp_scale.{b}"] = _tensor(scale[emb.rank])
    for group, stacked in (("dp", False), ("tp", True), ("row", True)):
        arrays, tables = tree.get(group, []), getattr(emb, group)
        if len(arrays) != len(tables):
            raise ValueError(f"{len(arrays)} {group} tables, the port's plan "
                             f"has {len(tables)}")
        for i, arr in enumerate(arrays):
            arr = np.asarray(arr)
            want = (((emb.world_size,) if stacked else ())
                    + tuple(tables[i].shape))
            if tuple(arr.shape) != want:
                raise ValueError(f"{group} table {i}: shape {arr.shape}, the "
                                 f"port expects {want}")
            if group == "tp":
                state[f"{prefix}tp.{i}"] = _payload(
                    arr[emb.rank], emb.plan.tp_buckets[i].storage_dtype)
                continue
            state[f"{prefix}{group}.{i}"] = _tensor(
                arr[emb.rank] if stacked else arr)
    return state


def params_from_jax(np_params: dict, model) -> Dict[str, torch.Tensor]:
    """A state dict for `model` (a `DistributedEmbedding`, `SyntheticModel`
    or `DLRM` of the port) from the JAX package's parameter tree of the same
    configuration and world size, every leaf already ``np.asarray``-ed:
    the dp tables whole, this rank's shard of each bucket and row-sliced
    table. Load it with ``model.load_state_dict``
    or `InferenceEngine.set_params`. A `ConcatOneHotEmbedding` takes its
    tree's ``params`` table."""
    if isinstance(model, ConcatOneHotEmbedding):
        arr = np.asarray(np_params["params"])
        if arr.shape != tuple(model.params.shape):
            raise ValueError(f"params: shape {arr.shape}, the port expects "
                             f"{tuple(model.params.shape)}")
        return {"params": _tensor(arr)}
    if isinstance(model, DistributedEmbedding):
        return _embedding_state(np_params, model, "")
    if getattr(model, "distributed", True):
        state = _embedding_state(np_params["embedding"], model.embedding,
                                 "embedding.")
    else:
        state = {f"embedding_layers.{t}.embeddings": _tensor(p["embeddings"])
                 for t, p in enumerate(np_params["embedding"])}
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
    """The JAX package's parameter tree (numpy leaves) of `model`;
    collective at world size > 1."""
    def emb_tree(emb: DistributedEmbedding) -> dict:
        tree = {"dp": [_array(t) for t in emb.dp],
                "tp": [_stacked_payload(t) for t in emb.tp],
                "row": [_stacked(t) for t in emb.row]}
        if emb.quantized_buckets:
            tree["tp_scale"] = [
                _stacked(s) if b in emb.quantized_buckets else None
                for b, s in enumerate(emb.tp_scale)]
        if emb._hot_buckets:
            tree["hot"] = [
                {"ids": _array(emb._hot_entry(b)[0]),
                 "rows": _array(emb._hot_entry(b)[1])}
                if b in emb._hot_buckets else None
                for b in range(len(emb.tp))]
        return tree

    if isinstance(model, ConcatOneHotEmbedding):
        return {"params": _array(model.params)}
    if isinstance(model, DistributedEmbedding):
        return emb_tree(model)
    tree = {"embedding": (
        emb_tree(model.embedding) if getattr(model, "distributed", True)
        else [{"embeddings": _array(layer.embeddings)}
              for layer in model.embedding_layers])}
    for name, child in model.named_children():
        if isinstance(child, MLP):
            tree[name] = [{"w": _array(layer.w), "b": _array(layer.b)}
                          for layer in child]
    return tree


def _mlp_children(model):
    return [(name, child) for name, child in model.named_children()
            if isinstance(child, MLP)]


def _named_from_tree(tree: dict, model) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} from a dense-part tree ({mlp name: [{'w',
    'b'}, ...], 'embedding': {'dp': [V, w] per dp table}})."""
    out = {f"embedding.dp.{j}": _tensor(a)
           for j, a in enumerate(tree.get("embedding", {}).get("dp", []))}
    for name, child in _mlp_children(model):
        for i, layer in enumerate(tree[name]):
            out[f"{name}.{i}.w"] = _tensor(layer["w"])
            out[f"{name}.{i}.b"] = _tensor(layer["b"])
    return out


def _tree_from_named(named: Dict[str, torch.Tensor], model) -> dict:
    emb = (model if isinstance(model, DistributedEmbedding)
           else model.embedding)
    tree = {"embedding": {"dp": [_array(named[f"embedding.dp.{j}"])
                                 for j in range(len(emb.dp))]}}
    for name, child in _mlp_children(model):
        tree[name] = [{"w": _array(named[f"{name}.{i}.w"]),
                       "b": _array(named[f"{name}.{i}.b"])}
                      for i in range(len(child))]
    return tree




def opt_state_from_jax(np_state: dict, model) -> dict:
    """The port's opt state (`training.make_sparse_train_step`) from the
    JAX package's, every leaf already ``np.asarray``-ed: ``{"emb": {"tp":
    [(acc[world, rows, w],)], "row": [...], "hot": [(acc[H, w],)]},
    "dense": optax chain state}`` (plus ``"count"`` under a schedule);
    this rank takes its ``[rank]`` shard of each stacked state array and
    the hot shards' state whole. Tensors land on `model`'s device, an
    offloaded bucket's in host memory."""
    layer = model.embedding
    dev = layer.device
    emb = np_state["emb"]

    def shards(entries, place=lambda i, t: t.to(dev)):
        return [tuple(place(i, _tensor(np.asarray(x)[layer.rank]))
                      if np.ndim(x) == 3 else int(np.asarray(x))
                      for x in entry) for i, entry in enumerate(entries)]
    # an offloaded bucket's state lives where its table does, on the host
    tp = shards(emb["tp"], layer._bucket_tensor)
    row = shards(emb.get("row", []))
    if len(row) != len(layer.row):
        raise ValueError(f"opt state for {len(row)} row-sliced tables, the "
                         f"port's plan has {len(layer.row)}")
    hot = [tuple(_tensor(x).to(dev) if np.ndim(x) == 2
                 else int(np.asarray(x)) for x in entry)
           for entry in emb.get("hot", [])]
    if len(hot) != (len(layer._hot_buckets) if "hot" in emb else 0):
        raise ValueError(f"opt state for {len(hot)} hot shards, the layer "
                         f"has {len(layer._hot_buckets)}")
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
    state = {"emb": {"tp": tp, "row": row}, "dense": dense}
    if "hot" in emb:
        state["emb"]["hot"] = hot
    if "count" in np_state:
        state["count"] = int(np.asarray(np_state["count"]))
    return state


def opt_state_to_numpy(opt_state: dict, model) -> dict:
    """The port's opt state in the JAX package's layout with numpy leaves:
    ``emb['tp'][b]`` and ``emb['row'][t]`` tuples of ``[world, rows_max,
    w]`` arrays (and adam's int count; collective at world size > 1); the
    dense part a dict of optax's field names (``sum_of_squares`` /
    ``count``, ``mu``, ``nu`` / ``schedule_count``) over dense-part trees
    (the MLPs and ``embedding['dp']``)."""
    def stacks(entries):
        return [tuple(_stacked(x) if torch.is_tensor(x) else int(x)
                      for x in entry) for entry in entries]
    dense = {}
    for key, val in opt_state["dense"].items():
        dense[key] = (_tree_from_named(val, model) if isinstance(val, dict)
                      else int(val))
    out = {"emb": {"tp": stacks(opt_state["emb"]["tp"]),
                   "row": stacks(opt_state["emb"].get("row", []))},
           "dense": dense}
    if "hot" in opt_state["emb"]:
        # replicated: every rank holds the whole [H, w] arrays
        out["emb"]["hot"] = [tuple(_array(x) if torch.is_tensor(x)
                                   else int(x) for x in entry)
                             for entry in opt_state["emb"]["hot"]]
    if "count" in opt_state:
        out["count"] = int(opt_state["count"])
    return out
