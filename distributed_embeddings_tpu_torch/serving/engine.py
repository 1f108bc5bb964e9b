"""Apply-only inference engine over a DistributedEmbedding (+ dense model).

Counterpart of ``distributed_embeddings_tpu/serving/engine.py``
`InferenceEngine`: it holds only parameters (a checkpoint's
``{"params": ..., "opt_state": ...}`` is stripped to its params), pads every
request to the nearest warmed batch shape and slices the true rows back
out. PyTorch runs eagerly, so `warmup` fixes the padded shapes and runs one
forward per shape; there is nothing to compile. The hot-row cache, the
versioned table store and the vocabulary manager of the JAX engine are not
ported yet (ROADMAP Queue A13 / A12).
"""

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
from distributed_embeddings_tpu_torch.parallel.staging import DeviceStager
from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           resolve_device)

__all__ = ["InferenceEngine"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue {item})")


class InferenceEngine:
    """Serve ``predict(batch)`` from a model at inference cost.

    Args:
      model: a `DistributedEmbedding` (embedding-only serving: `predict`
        takes the per-feature id batch and returns the per-input outputs)
        or a module with an ``.embedding`` `DistributedEmbedding` whose
        forward takes ``(numerical, cats)`` (e.g. `SyntheticModel`, `DLRM`):
        `predict` then takes ``(numerical, cats)`` and returns the logits.
      params: optional state dict to load into `model` (see `set_params`);
        by default the model's own parameters are served.
      device: where the model runs (None = cuda); the model must live there.
      registry: optional `MetricRegistry` for the serving counters
        (``serve/predicts``, ``serve/rows_served``, ``serve/rows_padded``).
      donate_batch: accepted, with no effect: nothing is donated in
        PyTorch, and the engine's staged copies are its own.
      cache_capacity (0), promote_threshold (2), replica (None) and
        vocab_manager (None): the JAX package's hot-row cache, fleet label
        and vocabulary; only these defaults are taken, any other value
        raises NotImplementedError (ROADMAP Queue A13, serving remainder,
        and A12, store and vocab).

    Requests are staged to the device through a
    `parallel.staging.DeviceStager`: one pinned copy a request on a side
    stream, which the serving stream waits on; the host does not block.
    """

    def __init__(self, model, params=None, *, device: DeviceLike = None,
                 cache_capacity=0, promote_threshold: int = 2,
                 donate_batch: bool = False, vocab_manager=None,
                 registry: Optional[MetricRegistry] = None,
                 replica: Optional[str] = None):
        del donate_batch
        if cache_capacity:
            raise _not_ported("the HotRowCache (cache_capacity)",
                              "A13 (serving remainder)")
        if promote_threshold != 2:
            raise _not_ported("the HotRowCache (promote_threshold)",
                              "A13 (serving remainder)")
        if replica is not None:
            raise _not_ported("fleet replicas (replica)",
                              "A13 (serving remainder)")
        if vocab_manager is not None:
            raise _not_ported("vocab_manager", "A12 (store and vocab)")
        self.device = resolve_device(device)
        if isinstance(model, DistributedEmbedding):
            self._model = None
            self.embedding = model
        else:
            self._model = model
            self.embedding = model.embedding
        if self.embedding.world_size > 1:
            raise _not_ported("an InferenceEngine at world size > 1",
                              "A3 (multi-GPU exchange)")
        if self.embedding.device != self.device:
            raise ValueError(
                f"the model lives on {self.embedding.device}, the engine "
                f"was asked for {self.device}")
        self._module = model
        self._stager = DeviceStager(self.device)
        if params is not None:
            self.set_params(params)
        self._metrics = registry if registry is not None \
            else MetricRegistry()
        self._warmed: List[int] = []
        self.n_predicts = 0
        self.rows_served = 0
        self.rows_padded = 0

    # ------------------------------------------------------------ internals
    def _normalize(self, cats: Sequence) -> List:
        """Validate one request's per-feature inputs and return them as
        numpy arrays: [B] / [B, k] integer ids, or (ids, weights) tuples."""
        emb = self.embedding
        if len(cats) != emb._n_inputs:
            raise ValueError(
                f"expected {emb._n_inputs} categorical inputs, "
                f"got {len(cats)}")
        out = []
        for i, x in enumerate(cats):
            weights = None
            if isinstance(x, tuple) and len(x) == 2:
                x, weights = x
                weights = np.asarray(weights, np.float32)
            ids = np.asarray(x)
            if not np.issubdtype(ids.dtype, np.integer):
                raise TypeError(
                    f"input {i}: serving takes integer id arrays "
                    f"(or (ids, weights) tuples), got dtype {ids.dtype}")
            if ids.ndim not in (1, 2):
                raise ValueError(
                    f"input {i}: expected [B] or [B, k] ids, "
                    f"got shape {ids.shape}")
            out.append(ids if weights is None else (ids, weights))
        return out

    def _pad_rows(self, arr: np.ndarray, target: int) -> np.ndarray:
        b = arr.shape[0]
        if b == target:
            return arr
        pad = np.zeros((target - b,) + arr.shape[1:], arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def _target_batch(self, b: int) -> int:
        for size in self._warmed:
            if size >= b:
                return size
        world = max(self.embedding.world_size, 1)
        return int(math.ceil(b / world) * world)

    def _to_device(self, tree):
        """A request's padded host arrays on the device, through the
        engine's `DeviceStager` (one pinned copy, not blocking the
        host)."""
        return self._stager(tree)

    def _predict_padded(self, numerical, prepped: List, target: int):
        cats = [tuple(self._pad_rows(a, target) for a in x)
                if isinstance(x, tuple) else self._pad_rows(x, target)
                for x in prepped]
        if self._model is not None:
            numerical = self._pad_rows(np.asarray(numerical, np.float32),
                                       target)
        num, cats = self._to_device((numerical, cats))
        with torch.inference_mode():
            if self._model is None:
                return self.embedding(cats)
            return self._model(num, cats)

    # --------------------------------------------------------------- API
    def predict(self, batch):
        """Serve one request batch: the per-feature id arrays ([B] / [B, k]
        ints, or (ids, weights) tuples) in embedding-only mode, a
        ``(numerical, cats)`` tuple in model mode. Returns the output(s)
        sliced to the request's true batch size, on the engine's device
        (the launch is asynchronous on a card)."""
        if self._model is None:
            numerical, cats = None, list(batch)
        else:
            numerical, cats = batch
            cats = list(cats)
        prepped = self._normalize(cats)
        first = prepped[0]
        b = (first[0] if isinstance(first, tuple) else first).shape[0]
        target = self._target_batch(b)
        out = self._predict_padded(numerical, prepped, target)
        self.n_predicts += 1
        self.rows_served += b
        self.rows_padded += target - b
        self._metrics.counter("serve/predicts").inc()
        self._metrics.counter("serve/rows_served").inc(b)
        self._metrics.counter("serve/rows_padded").inc(target - b)
        if isinstance(out, torch.Tensor):
            return out[:b]
        return [a[:b] for a in out]

    def warmup(self, batch_sizes: Sequence[int], example=None) -> List[int]:
        """Fix the padded batch shapes `predict` pads to (the smallest
        warmed shape that fits) and run one forward at each.

        example: a `predict` batch whose per-input structure (hotness,
        weights, dtypes) matches real traffic; required when the layer has
        no `input_max_hotness` hints and inputs are multi-hot. Default:
        zero ids at the hinted hotness and zero numerical features."""
        emb = self.embedding
        world = max(emb.world_size, 1)
        sizes = sorted({int(math.ceil(b / world) * world)
                        for b in batch_sizes})
        for size in sizes:
            if example is not None:
                if self._model is None:
                    numerical, cats = None, list(example)
                else:
                    numerical, cats = example
                # an example larger than this size is cut down to it (only
                # its per-input structure matters); smaller ones pad up
                cut = lambda a: np.asarray(a)[:size]
                cats = [(cut(x[0]), cut(x[1])) if isinstance(x, tuple)
                        else cut(x) for x in cats]
                prepped = self._normalize(list(cats))
                num = None if numerical is None else cut(numerical)
            else:
                mh = emb.input_max_hotness or [None] * emb._n_inputs
                cats = [np.zeros((size,), np.int32) if (h or 1) == 1
                        else np.zeros((size, h), np.int32) for h in mh]
                prepped = self._normalize(cats)
                num = (None if self._model is None
                       else np.zeros((size, getattr(
                           self._model, "num_numerical_features", 1)),
                           np.float32))
            self._predict_padded(num, prepped, size)
        self._warmed = sorted(set(self._warmed) | set(sizes))
        return self._warmed

    def set_params(self, params) -> None:
        """Load a state dict (the model's keys; `convert.params_from_jax`
        builds one from a JAX parameter tree) into the served model, in
        place. A ``{"params": ..., "opt_state": ...}`` checkpoint dict is
        stripped to its params."""
        if isinstance(params, dict) and "params" in params \
                and "opt_state" in params:
            params = params["params"]
        self._module.load_state_dict(params)

    def apply_delta(self, path: str):
        raise _not_ported("row-delta streaming", "A13 (serving remainder)")

    def poll_updates(self, publish_dir: str, upto: Optional[int] = None):
        raise _not_ported("row-delta streaming", "A13 (serving remainder)")

    def refresh(self):
        raise _not_ported("the HotRowCache", "A13 (serving remainder)")
