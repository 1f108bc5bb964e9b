"""Apply-only inference engine over a DistributedEmbedding (+ dense model).

Counterpart of ``distributed_embeddings_tpu/serving/engine.py``
`InferenceEngine` (:66-654): it holds only parameters (a checkpoint's
``{"params": ..., "opt_state": ...}`` is stripped to its params), pads every
request to the nearest warmed batch shape and slices the true rows back
out. PyTorch runs eagerly, so `warmup` fixes the padded shapes and runs one
forward per shape; there is nothing to compile. A model with quantized
buckets (``storage_dtype``) is served through the same forward, whose
lookup decodes the gathered rows. With a `vocab.VocabManager`, each
request's raw keys are translated to rows, query-only, before they are
staged.

The engine is the JAX engine's whole serving tier:

  * **Hot-row caches.** ``cache_capacity`` puts a `serving.cache.
    HotRowCache` over each offloaded bucket (an int for every one, a
    ``{bucket: rows}`` dict for some); each request first admits the rows
    whose counts crossed ``promote_threshold`` (once a cache, see
    `_cache_slots`), then maps its keys to slots
    (`_group_keys`: the host mirror of every shard's exchanged ids,
    padding rows masked so they never count), then runs the forward
    inside the layer's
    `offload_lookup_scope`, where `cached_group_lookup` serves the group.
    The cached outputs equal the host path's bit for bit. `warmup`
    observes nothing.
  * **Its own table store.** The engine owns a `store.TableStore` over its
    layer's tensors, and every table write goes through it:
    `set_params` (a chain-breaking swap; the cached rows are stale until
    `refresh`), `apply_delta` and `poll_updates` (a training job's
    published row deltas applied in place, the resident slots patched from
    each delta's payload, refreshed after a snapshot) and
    `reanchor_published` (the fleet's rollback and late-join primitive).
    `poll_updates` never raises: a failure is counted
    (``serve/poll_errors_total``, `last_poll_error`) and the engine keeps
    serving its last good version, with the reasons in
    `degraded_reasons()` and the ``serve/degraded{reason=}`` gauges.
    Engines that share one layer own separate stores over the same
    tensors: only one of them may apply the stream.
  * **Fleet labels.** With ``replica=``, every ``serve/*`` family carries a
    ``replica=`` label, so one registry hosts a fleet (`fleet`).

At world size > 1 serving is collective: every rank calls `predict` with
the same request, which is padded to a multiple of the world; each rank
forwards its slice and the outputs are all-gathered, so every rank returns
the whole request's, as the JAX engine returns a global array. So is
every table write: `apply_delta`, `poll_updates`, `reanchor_published`,
`set_params` and `refresh` are called by every rank alike. The caches
need no collective (every rank's tracker sees the same keys and decides
alike; each rank fills and refreshes the slots of its own keys,
`serving.cache`); the stream's apply agrees across ranks before it
writes (`store.table_store`), so a read that fails on one rank leaves
every rank at the same version, with the same `degraded_reasons()`,
`last_poll_error` type and ``serve/poll_errors_total``. A rank's slot
patch that fails refreshes the caches on every rank.

Telemetry: each `predict` runs under ``span("serve/predict")`` (a
``span_seconds`` histogram, a profiler range, the flight recorder's
edges), and its first answer at or above a store version closes that
version's lineage track. Each newly active degradation reason lands on
the flight recorder as a ``serve/degraded_entry`` instant and, with
``postmortem_dir``, dumps a postmortem artifact (`obs.trace.
dump_postmortem`) once per entry. Not ported: the fault points (ROADMAP
A15b).
"""

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
from distributed_embeddings_tpu_torch.obs.spans import span as obs_span
from distributed_embeddings_tpu_torch.parallel.mesh import (gather_objects,
                                                            gather_stack)
from distributed_embeddings_tpu_torch.parallel.staging import (DeviceStager,
                                                               dp_slice)
from distributed_embeddings_tpu_torch.serving.cache import (
    HotRowCache, cached_group_lookup)
from distributed_embeddings_tpu_torch.store import (
    DeltaConsumer, TableStore, restore_from_published)
from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           resolve_device)
from distributed_embeddings_tpu_torch.vocab import latest_vocab_state

__all__ = ["InferenceEngine"]


def _gathered(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``[B_l, ...]`` block concatenated in rank order."""
    stack = gather_stack(t)
    return stack.reshape((-1,) + tuple(stack.shape[2:]))


def _wants_cache(cache_capacity) -> bool:
    if isinstance(cache_capacity, dict):
        return any(int(c) > 0 for c in cache_capacity.values())
    return int(cache_capacity or 0) > 0


def _ids_of(x) -> np.ndarray:
    return x[0] if isinstance(x, tuple) else x


class InferenceEngine:
    """Serve ``predict(batch)`` from a model at inference cost.

    Args:
      model: a `DistributedEmbedding` (embedding-only serving: `predict`
        takes the per-feature id batch and returns the per-input outputs)
        or a module with an ``.embedding`` `DistributedEmbedding` whose
        forward takes ``(numerical, cats)`` (e.g. `SyntheticModel`, `DLRM`):
        `predict` then takes ``(numerical, cats)`` and returns the logits.
      params: optional state dict to load into `model`; by default the
        model's own parameters are served.
      device: where the model runs (None = cuda); the model must live there.
      cache_capacity: rows of device cache per offloaded bucket (0: none,
        the host path); a ``{bucket: rows}`` dict caches some buckets.
      promote_threshold: access count before a row can be promoted.
      donate_batch: accepted, with no effect: nothing is donated in
        PyTorch, and the engine's staged copies are its own.
      vocab_manager: optional `vocab.VocabManager` over this model's
        layer: `predict` takes raw keys and translates them query-only
        (misses serve the fallback row; nothing is admitted or counted);
        `poll_updates` loads the publisher's binding sidecars. A manager
        built over another layer raises ValueError.
      registry: optional `MetricRegistry` for the serving metrics
        (``serve/predicts``, ``serve/rows_served``, ``serve/rows_padded``,
        ``serve/poll_errors_total``, ``serve/degraded{reason=}``,
        ``serve/cache_bypassed_buckets``), which the owned `TableStore`
        reports through too (``store/*``).
      replica: optional replica name: every ``serve/*`` family then
        carries a ``replica=`` label (``store/*`` stays unlabeled).
      postmortem_dir: where `poll_updates` writes a postmortem artifact
        (`obs.trace.dump_postmortem`: the flight recorder, the registry
        snapshot, the poll's context) on each newly active degradation
        reason; None (default) writes none. The JAX package's
        ``DET_OBS_POSTMORTEM_DIR``. `postmortems` lists the paths.

    Requests are staged to the device through a
    `parallel.staging.DeviceStager`: one pinned copy a request on a side
    stream, which the serving stream waits on; the host does not block.
    """

    def __init__(self, model, params=None, *, device: DeviceLike = None,
                 cache_capacity=0, promote_threshold: int = 2,
                 donate_batch: bool = False, vocab_manager=None,
                 registry: Optional[MetricRegistry] = None,
                 replica: Optional[str] = None,
                 postmortem_dir: Optional[str] = None):
        del donate_batch
        self.device = resolve_device(device)
        if isinstance(model, DistributedEmbedding):
            self._model = None
            self.embedding = model
        else:
            self._model = model
            self.embedding = model.embedding
        emb = self.embedding
        if vocab_manager is not None and getattr(
                vocab_manager, "emb", None) is not emb:
            raise ValueError(
                "vocab_manager was built over a different layer; the "
                "binding's physical rows are plan-specific")
        self.vocab = vocab_manager
        if emb.world_size > 1 and not emb.dp_input:
            raise ValueError("an InferenceEngine at world size > 1 serves "
                             "data-parallel input: build the model with "
                             "dp_input=True")
        if _wants_cache(cache_capacity) and not emb.dp_input:
            raise ValueError("the hot-row cache serves data-parallel input: "
                             "build the model with dp_input=True")
        if emb.device != self.device:
            raise ValueError(
                f"the model lives on {emb.device}, the engine "
                f"was asked for {self.device}")
        self._module = model
        self._stager = DeviceStager(self.device)
        if params is not None:
            self._load(params)
        self._metrics = registry if registry is not None \
            else MetricRegistry()
        self.replica = replica
        self._labels = {} if replica is None else {"replica": str(replica)}
        # the engine's tables are owned by a versioned store: refreshes and
        # the stream's applies read and write through it
        self.store = TableStore(emb, registry=self._metrics)
        self._consumers: Dict[str, DeltaConsumer] = {}
        self._vocab_loaded_path: Optional[str] = None
        # degradation reasons currently active, mirrored into the
        # serve/degraded{reason=} gauges
        self._degraded_active: frozenset = frozenset()
        self.last_poll_error: Optional[str] = None
        self.postmortem_dir = postmortem_dir
        self.postmortems: List[str] = []
        # the newest version a predict answered at (the lineage's serve)
        self._lineage_served_version = 0
        self.caches: Dict[int, HotRowCache] = {}
        off = emb.offloaded_buckets
        if isinstance(cache_capacity, dict):
            caps = {b: int(cache_capacity.get(b, 0)) for b in off}
        else:
            caps = {b: int(cache_capacity or 0) for b in off}
        for b, cap in caps.items():
            if cap > 0:
                self.caches[b] = HotRowCache(
                    emb, b, cap, promote_threshold=promote_threshold)
        # every bucket, quantized ones too, is cached (the decode seam):
        # constant 0, kept for the dashboards that read it
        self._metrics.gauge("serve/cache_bypassed_buckets",
                            **self._labels).set(0)
        self._warmed: List[int] = []
        self.n_predicts = 0
        self.rows_served = 0
        self.rows_padded = 0

    # ------------------------------------------------------------ internals
    def _load(self, params) -> None:
        if isinstance(params, dict) and "params" in params \
                and "opt_state" in params:
            params = params["params"]       # checkpoint dict: strip opt state
        self._module.load_state_dict(params)

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

    def _group_keys(self, grp, tp_prepped, batch: int, true_rows: int):
        """Host mirror of one group's exchanged ids (JAX `_group_keys`
        :245): the flat row keys ``[world, B * f * k]`` each destination
        shard r's lookup reads, ``r * rows_max + row`` in its exchanged
        block's order, and their validity, False on the batch's padding
        rows and on the f padding lanes of a shard with fewer slots, which
        never count. Every rank serves the same request, so every rank
        builds the whole mirror from it alone."""
        world = self.embedding.world_size
        rows_max = max(self.embedding.plan.tp_buckets[grp.bucket].rows_max,
                       1)
        ids = np.zeros((world, batch, grp.f_max, grp.k), np.int64)
        valid = np.zeros((world, batch, grp.f_max, grp.k), bool)
        for r in range(world):
            for j in range(grp.counts[r]):
                member = _ids_of(
                    tp_prepped[grp.class_inputs[int(grp.sel[r, j])]])
                member = np.asarray(member, np.int64).reshape(
                    member.shape[0], -1)                 # [b, k], b <= batch
                ids[r, :member.shape[0], j, :] = member + int(grp.offs[r, j])
                valid[r, :true_rows, j, :] = True
        np.clip(ids, 0, rows_max - 1, out=ids)
        keys = ids + (np.arange(world, dtype=np.int64)[:, None, None, None]
                      * rows_max)
        return keys.reshape(world, -1), valid.reshape(world, -1)

    def _cache_slots(self, prepped: List, target: int, true_rows: int,
                     observe: bool) -> Dict[int, torch.Tensor]:
        """Per cached exchange group g, this rank's row of the request's
        slot indices (host int32; every shard's keys are looked up, so
        every rank's tracker observes the same stream): each cache's
        admission first (a batch already hits the rows that just crossed
        the threshold), then each group's lookup, which observes. A cache admits once a request, before any of its
        groups' lookups: the JAX engine admits before each group's
        lookup, so a bucket with groups of two hotnesses can evict, at its
        second group's admission, a row its first group's lanes were
        mapped to, and serve that lane another row."""
        emb = self.embedding
        tp = [prepped[i] for i in emb.strategy.input_groups[1]]
        key = tuple((1 if _ids_of(p).ndim == 1 else _ids_of(p).shape[1],
                     isinstance(p, tuple)) for p in tp)
        groups, _ = emb._exchange_groups_for_key(key)
        cached = [(g, grp) for g, grp in enumerate(groups)
                  if grp.bucket in self.caches]
        if observe:
            for b in sorted({grp.bucket for _, grp in cached}):
                self.caches[b].admit()
        out = {}
        for g, grp in cached:
            cache = self.caches[grp.bucket]
            keys, valid = self._group_keys(grp, tp, target, true_rows)
            out[g] = torch.from_numpy(
                cache.lookup_slots(keys, valid, observe=observe)[emb.rank])
        return out

    def _predict_padded(self, numerical, prepped: List, target: int,
                        true_rows: int, observe: bool = True):
        emb = self.embedding
        slot_map = (self._cache_slots(prepped, target, true_rows, observe)
                    if self.caches else {})
        cats = [tuple(self._pad_rows(a, target) for a in x)
                if isinstance(x, tuple) else self._pad_rows(x, target)
                for x in prepped]
        if self._model is not None:
            numerical = self._pad_rows(np.asarray(numerical, np.float32),
                                       target)
        batch = (numerical, cats)
        if emb.world_size > 1:
            batch = dp_slice(batch)
        num, cats = self._to_device(batch)

        def hook(g, grp, table, ids_x, eff_w):
            slot = slot_map.get(g)
            if slot is None:
                return None
            return cached_group_lookup(emb, grp, table,
                                       self.caches[grp.bucket].slots, ids_x,
                                       slot, eff_w)
        scope = (emb.offload_lookup_scope(hook) if slot_map
                 else contextlib.nullcontext())
        with torch.inference_mode(), scope:
            if self._model is None:
                out = self.embedding(cats)
            else:
                out = self._model(num, cats)
            if emb.world_size == 1:
                return out
            # every rank's slice, in rank order: the whole padded batch
            if isinstance(out, torch.Tensor):
                return _gathered(out)
            return [_gathered(a) for a in out]

    # --------------------------------------------------------------- API
    def predict(self, batch):
        """Serve one request batch: the per-feature id arrays ([B] / [B, k]
        ints, or (ids, weights) tuples) in embedding-only mode, a
        ``(numerical, cats)`` tuple in model mode. Returns the output(s)
        sliced to the request's true batch size, on the engine's device
        (the launch is asynchronous on a card). Collective at world size
        > 1: every rank passes the same request and gets every row's
        outputs. Runs under ``span("serve/predict")``."""
        if self._model is None:
            numerical, cats = None, list(batch)
        else:
            numerical, cats = batch
            cats = list(cats)
        with obs_span("serve/predict", self._metrics):
            if self.vocab is not None:
                # raw keys -> rows, query-only
                cats = self.vocab.translate(cats)
            prepped = self._normalize(cats)
            b = _ids_of(prepped[0]).shape[0]
            target = self._target_batch(b)
            out = self._predict_padded(numerical, prepped, target, b)
        self.n_predicts += 1
        self.rows_served += b
        self.rows_padded += target - b
        m, lb = self._metrics, self._labels
        m.counter("serve/predicts", **lb).inc()
        m.counter("serve/rows_served", **lb).inc(b)
        m.counter("serve/rows_padded", **lb).inc(target - b)
        if self.store.version > self._lineage_served_version:
            # the first predict at >= V closes V's lineage track, and every
            # still-open version below it (applied in one burst)
            v = self.store.version
            self._lineage_served_version = v
            rec = obs_trace.default_recorder()
            for ov in rec.lineage_open_versions():
                if ov <= v:
                    rec.lineage(ov, "serve", served_at_version=v)
        if isinstance(out, torch.Tensor):
            return out[:b]
        return [a[:b] for a in out]

    def warmup(self, batch_sizes: Sequence[int], example=None) -> List[int]:
        """Fix the padded batch shapes `predict` pads to (the smallest
        warmed shape that fits) and run one forward at each; the caches
        observe nothing.

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
            self._predict_padded(num, prepped, size, size, observe=False)
        self._warmed = sorted(set(self._warmed) | set(sizes))
        return self._warmed

    def set_params(self, params, refresh: bool = False) -> None:
        """Load a state dict (the model's keys; `convert.params_from_jax`
        builds one from a JAX parameter tree) into the served model, in
        place; a ``{"params": ..., "opt_state": ...}`` checkpoint dict is
        stripped to its params. The swap goes through the table store
        (`TableStore.replace`: a version bump, the delta chain broken, so
        the next stream file consumed must be a snapshot). The cached rows
        hold the old values until `refresh` (``refresh=True`` runs it).
        At world size > 1 every rank passes its own model's state dict."""
        self._load(params)
        self.store.replace()
        if refresh:
            self.refresh()

    def refresh(self) -> int:
        """Re-copy every cached row from the tables through the store's
        versioned read (the consistency step after a table write); at
        world size > 1 each rank its own keys' rows. Returns the rows
        this rank refreshed over all buckets."""
        return sum(cache.refresh_from(self.store)
                   for cache in self.caches.values())

    def reanchor_published(self, publish_dir: str,
                           upto: Optional[int] = None) -> int:
        """Rebuild the tables from the publish stream (the newest snapshot
        at or below `upto` and every chained delta after it) and refresh
        the caches: the fleet's rollback and re-anchor primitive. The
        store adopts the publisher's version space (its version, its
        per-table versions, the chain unbroken), so the next poll chains
        deltas from the restored version. Returns that version; raises
        when the stream holds no snapshot at or below `upto`. Collective
        at world size > 1."""
        restored = restore_from_published(self.embedding, publish_dir,
                                          upto=upto)
        self.store.replace()
        self.store.version = restored.version
        self.store.table_versions = list(restored.table_versions)
        self.store._chain_broken = False
        self.refresh()
        return restored.version

    def apply_delta(self, path: str) -> dict:
        """Consume one published stream file (row delta or snapshot) in
        place through the store, then patch the resident cache slots from
        the delta's payload (refresh them after a snapshot), so cached
        serving stays bit-equal at the new version. Returns the store's
        apply info. Collective at world size > 1 (every rank the same
        file)."""
        info = self.store.apply_published(path)
        self._absorb_apply(info)
        return info

    def poll_updates(self, publish_dir: str,
                     upto: Optional[int] = None) -> List[dict]:
        """Apply every new stream file in `publish_dir` (chain order,
        snapshot fallback), patching the caches file by file, and load the
        newest binding sidecar at or below the consumed version into the
        vocabulary manager. Returns the applied infos; `update_stats`
        gives the consumer's staleness accounting. `upto` caps the poll at
        a version: newer files stay invisible, and a replica held there
        reads as caught up.

        Never raises on a consumer-side fault: the engine keeps serving
        its last good version, ``serve/poll_errors_total`` counts the
        failure, `last_poll_error` holds it, and the reasons active after
        the poll are mirrored into the ``serve/degraded{reason=}`` gauges
        (1 while active, 0 when cleared) and `degraded_reasons()`:
        ``poll_error`` (the poll failed), ``corrupt_stream`` /
        ``io_transient`` (from the consumer), ``vocab_sidecar`` (the
        binding sidecar unreadable: the previous binding keeps
        translating), ``cache_patch`` (a slot patch failed: the caches
        were refreshed from the store instead). Collective at world size >
        1: every rank polls the same directory and ends with the same
        version and the same reasons and counts (see the module
        docstring)."""
        consumer = self._consumers.get(publish_dir)
        if consumer is None:
            consumer = DeltaConsumer(self.store, publish_dir)
            self._consumers[publish_dir] = consumer
        reasons = set()
        infos: List[dict] = []
        try:
            infos = consumer.poll(upto=upto)
            patch_error = None
            for info in infos:
                try:
                    self._absorb_apply(info)
                except Exception as e:  # noqa: BLE001 - degrade, never crash
                    patch_error = f"{type(e).__name__}: {e}"
                    break            # the refresh below covers the rest
            if self.embedding.world_size > 1:
                # one rank's failed patch refreshes every rank's caches
                patch_error = next((p for p in gather_objects(patch_error)
                                    if p is not None), None)
            if patch_error is not None:
                self._note_poll_error(patch_error)
                reasons.add("cache_patch")
                # the tables moved with every file; re-read the residents
                # once, so cached serving holds no pre-apply rows
                for cache in self.caches.values():
                    cache.refresh_from(self.store)
        except Exception as e:  # noqa: BLE001 - serve last-good instead
            self._note_poll_error(e)
            reasons.add("poll_error")
        if self.vocab is not None:
            # not gated on new row files: a consumer that raced a publish
            # picks the matching binding up on its next poll
            try:
                path = latest_vocab_state(publish_dir,
                                          upto=self.store.version)
                if path is not None and path != self._vocab_loaded_path:
                    self.vocab.load_state(path)
                    self._vocab_loaded_path = path
            except Exception as e:  # noqa: BLE001 - keep previous binding
                self._note_poll_error(e)
                reasons.add("vocab_sidecar")
        reasons |= consumer.degraded_reasons()
        for r in reasons:
            self._metrics.gauge("serve/degraded", reason=r,
                                **self._labels).set(1)
        for r in self._degraded_active - reasons:
            self._metrics.gauge("serve/degraded", reason=r,
                                **self._labels).set(0)
        entered = frozenset(reasons) - self._degraded_active
        self._degraded_active = frozenset(reasons)
        if entered:
            # a degraded entry is the incident: an instant on the flight
            # recorder, and a postmortem a newly active reason
            rec = obs_trace.default_recorder()
            for r in sorted(entered):
                rec.instant("serve/degraded_entry", reason=r,
                            error=self.last_poll_error)
            if self.postmortem_dir is not None:
                for r in sorted(entered):
                    try:
                        self.postmortems.append(obs_trace.dump_postmortem(
                            self.postmortem_dir, f"degraded:{r}",
                            registry=self._metrics,
                            extra={"publish_dir": publish_dir,
                                   "store_version": self.store.version,
                                   "last_poll_error": self.last_poll_error,
                                   "active_reasons": sorted(reasons)}))
                    except Exception as e:  # noqa: BLE001 - counted, as
                        # every poll failure is: poll_updates never raises
                        self._note_poll_error(e)
        return infos

    def _note_poll_error(self, e) -> None:
        self.last_poll_error = (e if isinstance(e, str)
                                else f"{type(e).__name__}: {e}")[:300]
        self._metrics.counter("serve/poll_errors_total",
                              **self._labels).inc()

    def degraded_reasons(self) -> frozenset:
        """The reasons holding this engine degraded (empty: healthy; the
        ``serve/degraded{reason=}`` gauges mirror them)."""
        return self._degraded_active

    def update_stats(self, publish_dir: str) -> dict:
        consumer = self._consumers.get(publish_dir)
        return consumer.stats() if consumer is not None else {}

    def _absorb_apply(self, info: dict) -> None:
        if info["kind"] == "snapshot":
            # whole tables were rewritten: every resident row re-reads
            for cache in self.caches.values():
                cache.refresh_from(self.store)
            return
        for b, cache in self.caches.items():
            hit = info["payload"].get(("tp", b))
            if hit is not None:
                cache.apply_rows(*hit)
                cache.refreshed_version = self.store.version

    def cache_stats(self) -> dict:
        """Aggregate and per-bucket cache statistics."""
        per = {b: c.stats() for b, c in self.caches.items()}
        hits = sum(c.hits for c in self.caches.values())
        misses = sum(c.misses for c in self.caches.values())
        return {"hit_rate": round(hits / (hits + misses), 4)
                if hits + misses else 0.0,
                "hits": hits, "misses": misses,
                "n_predicts": self.n_predicts,
                "rows_served": self.rows_served,
                "rows_padded": self.rows_padded,
                "store_version": self.store.version,
                "buckets": per}
