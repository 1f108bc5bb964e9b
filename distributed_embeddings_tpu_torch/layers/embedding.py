"""Single-device embedding layers and the on-the-fly vocabulary.

Counterpart of ``distributed_embeddings_tpu/layers/embedding.py``:
  * `Embedding`, an ``nn.Module`` that owns its table. A layer built on
    the ``meta`` device holds no memory and serves only as a table config,
    which is how `DistributedEmbedding` and the models use it;
  * `ConcatOneHotEmbedding`, many one-hot tables in one tall table, looked
    up by one gather at offset ids;
  * `IntegerLookup`, raw int64 keys to contiguous indices with the
    vocabulary built on the fly, on the host: the C++ map of
    ``native/hashmap.cpp`` (`native.hashmap.NativeIntegerLookup`) or its
    numpy twin `_NumpyIntegerLookup`, which give the same indices.
"""

import threading
from typing import Optional, Sequence

import numpy as np
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


class ConcatOneHotEmbedding(nn.Module):
    """Many one-hot tables fused into one tall table; one offset gather.

    The JAX package's `ConcatOneHotEmbedding` (reference embedding.py:
    173-198): `params` is the ``[sum(feature_sizes), embedding_width]``
    table (the JAX tree's ``{"params": ...}``), and ids ``[B,
    len(feature_sizes)]``, each column within its feature's size, give
    ``[B, len(feature_sizes), embedding_width]``: feature f's id i reads
    row ``sum(feature_sizes[:f]) + i``.

    Args:
      feature_sizes: vocabulary size per feature.
      embedding_width: embedding width.
      embeddings_initializer: initializer spec (see utils.initializers).
      dtype: parameter dtype.
      device: where the table lives (None = cuda).
      generator: draws the initial table (default: seed 0 on `device`).
    """

    # a gather: `DistributedEmbedding` may fuse it into a bucket lookup
    det_gather_semantics = True

    def __init__(self, feature_sizes: Sequence[int], embedding_width: int,
                 embeddings_initializer="uniform",
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_sizes = [int(v) for v in feature_sizes]
        self.embedding_width = int(embedding_width)
        self.embeddings_initializer = embeddings_initializer
        self.dtype = dtype
        offsets = np.concatenate([[0], np.cumsum(self.feature_sizes)])
        device = resolve_device(device)
        self.register_buffer("offsets", torch.as_tensor(
            offsets[:-1], dtype=torch.int64, device=device), persistent=False)
        self.params = nn.Parameter(
            torch.empty((int(offsets[-1]), self.embedding_width),
                        dtype=dtype, device=device), requires_grad=False)
        if device.type != "meta":
            get_initializer(embeddings_initializer)(
                self.params.data, default_generator(device, generator))

    def forward(self, inputs):
        ids = torch.as_tensor(inputs, device=self.params.device)
        return self.params[ids.to(torch.int64) + self.offsets]


class IntegerLookup:
    """Maps raw int64 keys to contiguous indices, building the vocabulary
    on the fly.

    The JAX package's `IntegerLookup` (reference embedding.py:202-281). The
    reference kept the map on the GPU (cuCollections,
    embedding_lookup_kernels.cu:383-516); here, as in the JAX package, the
    hash runs on the host, in the C++ open-addressing map of
    ``native/hashmap.cpp``, and the device side is a plain gather. Index 0
    is OOV, and the capacity is ``max_tokens + 1``: once `max_tokens` keys
    are bound, new keys translate to 0. Keys get indices in order of first
    appearance, duplicates within a batch included, and every occurrence
    counts (`counts`). This is stateful host-side preprocessing: call it
    on a batch before the step, as the ingest pipeline's lookup stage does.

    ``use_native`` None or True takes the C++ map, whose build raises on
    failure; False takes the numpy twin `_NumpyIntegerLookup`, which gives
    the same indices, vocabulary, counts and free slots. A numpy (or list)
    input gives a numpy int64 array; a ``torch.Tensor`` gives an int64
    tensor on the input's device.

    Reserved keys: the two most negative int64 values (INT64_MIN and
    INT64_MIN + 1, the native map's empty and tombstone slots) are never
    bound; they translate to OOV (0) on every path, on both backends.
    """

    def __init__(self, max_tokens: int, use_native: Optional[bool] = None):
        max_tokens = int(max_tokens)
        self.max_tokens = max_tokens
        self.capacity = max_tokens + 1
        if use_native is None or use_native:
            from distributed_embeddings_tpu_torch.native.hashmap import (
                NativeIntegerLookup)
            self._backend = NativeIntegerLookup(self.capacity)
        else:
            self._backend = _NumpyIntegerLookup(self.capacity)

    @property
    def native(self) -> bool:
        """True when the C++ map is the backend."""
        return not isinstance(self._backend, _NumpyIntegerLookup)

    def __call__(self, inputs):
        arr = _keys_array(inputs)
        flat = arr.reshape(-1)
        if self.native:
            # the C++ map probes in parallel and inserts its misses in batch
            # order, so it takes the raw stream: a numpy unique first would
            # put an O(n log n) sort in front of it
            out = self._backend.lookup_or_insert(flat)
        else:
            # the numpy twin hashes each distinct key once, in order of
            # first appearance (np.unique sorts; the stable argsort of the
            # first positions restores that order), then counts the whole
            # stream, as the C++ map counts in its probe
            uniq, first_idx, inv = np.unique(flat, return_index=True,
                                             return_inverse=True)
            if len(uniq) < len(flat):
                order = np.argsort(first_idx, kind="stable")
                out_u = self._backend.lookup_or_insert(uniq[order])
                rank = np.empty_like(order)
                rank[order] = np.arange(len(order))
                out = out_u[rank][inv.reshape(-1)]
            else:
                out = self._backend.lookup_or_insert(flat)
            self._backend.add_counts(out)
        res = out.reshape(arr.shape)
        if isinstance(inputs, torch.Tensor):
            return torch.from_numpy(res).to(inputs.device)
        return res

    def lookup(self, inputs) -> np.ndarray:
        """Query-only lookup (no vocabulary growth); unknown keys -> 0."""
        arr = _keys_array(inputs)
        return self._backend.lookup(arr.reshape(-1)).reshape(arr.shape)

    def counts(self) -> np.ndarray:
        """Per-index frequencies: [capacity] int64, index 0 = OOV, the
        occurrences `__call__` translated to each index (the frequency
        source of `DistributedEmbedding.hot_keys_from_counts`)."""
        return self._backend.counts()

    def erase(self, keys) -> np.ndarray:
        """Unbind keys: each key's index is released and REUSED by a later
        insertion (LIFO) before new indices are minted. Returns the freed
        index per key (0 = the key was not bound). An erased key looks up
        as OOV again, and its index's count resets."""
        arr = _keys_array(keys)
        return self._backend.erase(arr.reshape(-1)).reshape(arr.shape)

    def free_slots(self) -> np.ndarray:
        """Erased (reusable) indices in reuse order."""
        return np.asarray(self._backend.free_slots(), np.int64)

    def get_vocabulary(self):
        """Keys in index order, with -1 in the OOV slot (reference
        embedding.py:255-281 returns [-1] + keys). Erased indices appear as
        None holes (later keys stay index-aligned) until reused."""
        hole = np.iinfo(np.int64).min
        return [-1] + [None if k == hole else k
                       for k in self._backend.keys_in_index_order()]

    @property
    def size(self) -> int:
        """Live vocabulary size including the OOV slot (erases shrink)."""
        return self._backend.size + 1


def _keys_array(keys) -> np.ndarray:
    """`keys` (numpy, a list or a tensor on any device) as an int64
    numpy array."""
    if isinstance(keys, torch.Tensor):
        keys = keys.detach().cpu().numpy()
    return np.asarray(keys, dtype=np.int64)


class _NumpyIntegerLookup:
    """The numpy twin of the C++ map: dict-based, OOV (full table) -> 0,
    freed indices reused LIFO before new ones are minted past the
    high-water mark, and the two reserved keys (INT64_MIN and
    INT64_MIN + 1) mapped to OOV without being stored. Each call holds a
    lock, as the C++ map's wrapper does: ingest workers may call one
    layer from several threads."""

    _HOLE = np.iinfo(np.int64).min
    _RESERVED = (np.iinfo(np.int64).min, np.iinfo(np.int64).min + 1)

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._map = {}
        self._counts = np.zeros((capacity,), np.int64)
        self._free = []           # erased indices, reuse order (LIFO)
        self._high = 0            # highest index ever assigned
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._map)

    def lookup_or_insert(self, keys: np.ndarray) -> np.ndarray:
        with self._lock:
            return self._lookup_or_insert(keys)

    def _lookup_or_insert(self, keys: np.ndarray) -> np.ndarray:
        out = np.zeros(keys.shape, dtype=np.int64)
        m = self._map
        cap = self.capacity - 1  # index 0 reserved for OOV
        for i, k in enumerate(keys.tolist()):
            if k in self._RESERVED:
                continue
            idx = m.get(k)
            if idx is None:
                if len(m) < cap:
                    if self._free:
                        idx = self._free.pop()
                    else:
                        self._high += 1
                        idx = self._high
                    m[k] = idx
                else:
                    idx = 0
            out[i] = idx
        return out

    def erase(self, keys: np.ndarray) -> np.ndarray:
        out = np.zeros(keys.shape, dtype=np.int64)
        with self._lock:
            for i, k in enumerate(keys.tolist()):
                idx = self._map.pop(k, None)
                if idx is not None:
                    out[i] = idx
                    self._free.append(idx)
                    self._counts[idx] = 0
        return out

    def free_slots(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._free, np.int64)

    def add_counts(self, indices: np.ndarray) -> None:
        """Per-occurrence counts of a translated stream."""
        with self._lock:
            np.add.at(self._counts, indices.reshape(-1), 1)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        out = np.zeros(keys.shape, dtype=np.int64)
        with self._lock:
            m = self._map
            for i, k in enumerate(keys.tolist()):
                out[i] = m.get(k, 0)
        return out

    def keys_in_index_order(self):
        with self._lock:
            out = [self._HOLE] * self._high
            for k, idx in self._map.items():
                out[idx - 1] = k
        return out

    def counts(self) -> np.ndarray:
        with self._lock:
            return self._counts.copy()
