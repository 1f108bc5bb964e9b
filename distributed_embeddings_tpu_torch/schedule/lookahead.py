"""Lookahead training: batch N+1's embedding lookups beside batch N's
dense compute.

Counterpart of ``distributed_embeddings_tpu/schedule/lookahead.py``
(`LookaheadEngine`). The sparse step is sequential on the card:

    lookups -> dense forward and backward -> sparse update

The engine splits it into three stages with a two-batch carry, in place on
the module:

  prefetch  batch N+1's tapped forward (`DistributedEmbedding.forward`
            with taps and residuals, inside the step's sort scope): the
            group outputs, made autograd leaves, and the residuals (the
            ids, the effective weights, the sorts) are the carry. It runs
            on a CUDA stream of the engine's own, beside the dense stage.
  dense     batch N's forward and backward over the carried blocks
            (`staged_exchange_scope`): the MLPs see the current
            parameters; the blocks' gradients are the tap gradients.
  drain     `exchange_transpose` and the row-sparse update of the sparse
            step (`training._drain`: `ops.sparse_update.drain_sparse_apply`
            through the port's kernels, then the dense optimizer).

The one coupling: batch N's update rewrites rows that batch N+1's prefetch
read before it. Both sides are known on the host from the ids alone
(`touched_row_keys` of N against the ids of N+1, per sample:
`prefetch_stale_mask`), so at the start of step N+1 the engine recomputes
the stale samples' blocks against the updated tables
(`patch_staged_carry`: `lookup_combine` on their ids). A row-sparse update
writes only touched rows (sgd and adagrad; adam is lazy), so a patched
carry equals a fresh prefetch, and the step equals the sequential one bit
for bit. More stale samples than `patch_capacity` fall back to a fresh
prefetch of the whole batch on the current tables (``patch_overflows``),
as does a carry that is not the batch's (``cold_fills``). ``stale_ok=True``
skips the patch: the prefetched blocks may be one update stale.

Streams. On the card the prefetch of N+1 runs on the engine's side
stream, which first waits for everything the step's stream has queued
(the previous drain and this step's patch: the tables it reads are the
current ones). The step's stream waits on the prefetch's event before the
drain (the drain writes rows the prefetch reads), and, at the next step,
before it takes the carry; every carried tensor is then
``record_stream``'d onto it, as `parallel.staging.DeviceStager` does, so
the caching allocator does not hand out their memory while the step's
stream uses them. The side stream's next work is queued only after it
waits on the step's stream again, so no kernel of a prefetch runs while
the drain's kernels do: the segment walk's long pass, whose mbarrier
waits trap after 1 s, never shares the card with work queued behind the
side stream.

Refused, as the JAX engine refuses them: hot-row buckets, host-offloaded
buckets, quantized buckets, custom dp layer classes, a plan with nothing
to prefetch, ragged and sparse inputs, and more than one rank (the ranks
are processes; lookahead across ranks waits for NCCL, ROADMAP A3).
``lookahead=0`` is the sparse step itself (`make_sparse_train_step`).
`stats` is mirrored into the `registry`: the ``lookahead/steps``,
``lookahead/cold_fills``, ``lookahead/patch_overflows``,
``lookahead/patched_steps`` and ``lookahead/patched_samples`` counters and
the ``lookahead/patched_samples_max`` gauge (eager PyTorch compiles
nothing, so the JAX engine's ``lookahead/compiles`` gauges have no
counterpart). The port reads no environment, so there is no
``DET_LOOKAHEAD``.
"""

from typing import Optional

import numpy as np
import torch

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    TapResiduals)
from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
from distributed_embeddings_tpu_torch.ops.embedding_ops import (RaggedIds,
                                                                SparseIds)
from distributed_embeddings_tpu_torch.parallel.staging import (
    DeviceStager, DoubleBufferSlots)
from distributed_embeddings_tpu_torch.training import (
    _drain, _gradients, _sparse_optimizer_setup, make_sparse_train_step)

__all__ = ["LookaheadEngine"]


def _tensors(tree, out: list) -> list:
    """Every tensor of a carry (nested lists, tuples, dicts, named tuples
    and `TapResiduals`), appended to `out`."""
    if torch.is_tensor(tree):
        out.append(tree)
    elif isinstance(tree, TapResiduals):
        for name in TapResiduals.__slots__:
            _tensors(getattr(tree, name), out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def _host(x):
    if isinstance(x, (RaggedIds, SparseIds)):
        raise NotImplementedError(
            "lookahead>0 supports dense id inputs (and (ids, weights) "
            "tuples) only: the per-sample patch selection of a ragged or "
            "sparse input is not defined")
    if isinstance(x, tuple):
        return tuple(_host(a) for a in x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class LookaheadEngine:
    """The sparse train step as a three-stage pipeline with a two-batch
    carry (see the module docstring).

    Args:
      model: as `training.make_sparse_train_step`'s: exposes
        ``.embedding`` and ``loss_fn(numerical, cats, labels, taps=,
        return_residuals=)``; updated in place.
      optimizer / lr / dense_optimizer / strategy / fold_sort / donate:
        as `make_sparse_train_step` (``lookahead=0`` is that step; the
        pipeline shares its optimizers' construction).
      lookahead: 0 (the sequential step) or 1 (one batch ahead).
      stale_ok: skip the patch; the prefetched blocks may be one update
        stale.
      patch_capacity: the most stale samples a step patches (default
        batch // 8); more fall back to a fresh prefetch.
      registry: the `obs.MetricRegistry` the ``lookahead/*`` metrics land
        in (`fit` passes its run's); default a private one.

    Use::

      engine = LookaheadEngine(model, "adagrad", lr=0.05)
      engine.init()
      for i in range(steps):
          loss = engine.step(batches[i],
                             batches[i + 1] if i + 1 < steps else None)

    Batches are global ``(numerical, cats, labels)`` on the host (numpy
    arrays or CPU tensors; the engine stages them to the model's device
    and reads their ids on the host); `opt_state` is the step's state
    (`make_sparse_train_step`'s layout, so states pass between depths).
    """

    def __init__(self, model, optimizer: str = "adagrad", lr=0.01,
                 dense_optimizer=None, strategy: str = "auto",
                 lookahead: int = 1, stale_ok: bool = False,
                 patch_capacity: Optional[int] = None,
                 donate: Optional[bool] = None, fold_sort: bool = True,
                 registry: Optional[MetricRegistry] = None):
        if lookahead not in (0, 1):
            raise ValueError(
                f"lookahead={lookahead}: only depths 0 and 1 are "
                "supported (a deeper pipeline would need k-step patch "
                "composition)")
        self.model = model
        self.emb = emb = model.embedding
        self.lookahead = int(lookahead)
        self.stale_ok = bool(stale_ok)
        self.patch_capacity = patch_capacity
        self.stats = {"steps": 0, "cold_fills": 0, "patch_overflows": 0,
                      "patched_steps": 0, "patched_samples": 0,
                      "patched_samples_max": 0}
        # the registry mirror of `stats`, updated from this host body only
        self._metrics = (registry if registry is not None
                         else MetricRegistry())
        self._init_fn, self._base_step = make_sparse_train_step(
            model, optimizer, lr=lr, dense_optimizer=dense_optimizer,
            strategy=strategy, donate=donate, fold_sort=fold_sort)
        self._stager = DeviceStager(emb.device)
        self.opt_state = None
        self._slots = DoubleBufferSlots()
        self._prev_touched = None
        if self.lookahead == 0:
            return
        if (not emb.strategy.input_groups[1]
                and not emb.strategy.input_groups[2]):
            raise ValueError(
                "lookahead>0 has nothing to prefetch: every table in this "
                "plan is data-parallel (no exchange on the critical path: "
                "run with lookahead=0)")
        if emb._dp_custom_layers:
            raise NotImplementedError(
                "lookahead>0 does not support custom embedding layer "
                "classes on dp tables (staged forwards run them outside "
                "the exchange)")
        if emb._hot_buckets:
            raise NotImplementedError(
                "lookahead>0 does not support hot-row replicated buckets "
                "(the replicated hot shard updates densely every step, so "
                "the touched-row patch cannot make prefetched activations "
                "exact)")
        if emb._offload_enabled:
            raise NotImplementedError(
                "lookahead>0 does not support host-offloaded buckets: "
                "their lookups run on the host and cannot be carried or "
                "patched")
        if emb.quantized_buckets:
            raise NotImplementedError(
                "lookahead>0 does not support quantized (int8/fp8) bucket "
                "storage: the drain applies float32 row rules and the "
                "touched-row patch carries float32 activations")
        # last, so that the refusals above show at any world size
        emb._lookahead_world("lookahead>0")
        self._sort = (fold_sort, optimizer, strategy)
        self._scheduled, self._sopt_for, self._dense_opt = \
            _sparse_optimizer_setup(optimizer, lr, strategy, dense_optimizer)
        self._side = (torch.cuda.Stream(emb.device)
                      if emb.device.type == "cuda" else None)

    # ------------------------------------------------------------ state
    def init(self) -> dict:
        """The sparse and dense optimizer state
        (`make_sparse_train_step`'s init), held as `opt_state`."""
        self.opt_state = self._init_fn(self.model)
        return self.opt_state

    def reset(self) -> None:
        """Flush the pipeline: drop the carry and the touched rows. Call
        after writing the tables outside the engine (a checkpoint
        restore, a stream apply); the next step prefetches afresh."""
        self._slots.clear()
        self._prev_touched = None

    def _capacity(self, batch: int) -> int:
        cap = (self.patch_capacity if self.patch_capacity is not None
               else batch // 8)
        return max(cap, 1)

    # ------------------------------------------------------------ stages
    def _prefetch(self, staged) -> dict:
        """The tapped forward of a staged batch on the current stream: the
        carry {"ex": tap leaves per exchange group, "row": per row-sliced
        input, "res": the residuals, "batch": the staged batch}."""
        _, cats, _ = staged
        cats = list(cats)
        emb = self.emb
        taps = emb.make_taps(cats)
        fold, optimizer, strategy = self._sort
        with torch.no_grad(), emb.residual_sort_scope(fold, optimizer,
                                                      strategy):
            _, res = emb(cats, taps=taps, return_residuals=True)
        return {"ex": taps["tp"], "row": taps["row"], "res": res,
                "batch": staged, "event": None}

    def _prefetch_ahead(self, batch) -> dict:
        """`_prefetch` of a host batch on the side stream, after the work
        the step's stream has queued; the carry records its event."""
        if self._side is None:
            return self._prefetch(self._stager(batch))
        self._side.wait_stream(torch.cuda.current_stream(self.emb.device))
        with torch.cuda.stream(self._side):
            carry = self._prefetch(self._stager(batch))
            carry["event"] = torch.cuda.Event()
            carry["event"].record(self._side)
        return carry

    def _take(self, carry: dict) -> dict:
        """The carry on the step's stream: it waits for the prefetch, and
        every carried tensor is tied to it."""
        if carry["event"] is not None:
            stream = torch.cuda.current_stream(self.emb.device)
            stream.wait_event(carry["event"])
            for t in _tensors([carry["ex"], carry["row"], carry["res"],
                               carry["batch"]], []):
                t.record_stream(stream)
            carry["event"] = None
        return carry

    # -------------------------------------------------------------- step
    def step(self, batch, next_batch=None) -> torch.Tensor:
        """One optimizer step over `batch`, prefetching `next_batch` (None
        at the tail). The object passed as `next_batch` must be the one
        passed as `batch` at the next call: the carry is tagged with it,
        and a mismatch (or a cold start) prefetches afresh on the current
        tables. Returns the loss, a 0-d tensor on the model's device."""
        num, cats, labels = batch
        if self.lookahead == 0:
            num, cats, labels = self._stager((num, list(cats), labels))
            _, self.opt_state, loss = self._base_step(
                self.model, self.opt_state, num, cats, labels)
            return loss
        if self.opt_state is None:
            raise ValueError("LookaheadEngine.step before init()")
        emb = self.emb
        host = [_host(c) for c in cats]
        batch_n = len(host[0][0] if isinstance(host[0], tuple) else host[0])
        idx = np.zeros((0,), np.int64)
        cold = None
        carry = None
        if self._side is not None:
            # whatever the side stream did so far (a carry this step may
            # drop) is done before the step's stream goes on
            torch.cuda.current_stream(emb.device).wait_stream(self._side)
        if self._slots.current is None or self._slots.tag is not batch:
            cold = "cold_fills"
        else:
            carry = self._take(self._slots.take())
            if not self.stale_ok and self._prev_touched is not None:
                idx = np.flatnonzero(emb.prefetch_stale_mask(
                    host, self._prev_touched))
                if len(idx) > self._capacity(batch_n):
                    cold = "patch_overflows"
        if cold is not None:
            # a fresh prefetch on the current tables: the sequential
            # computation itself
            self._slots.clear()
            carry = self._prefetch(
                carry["batch"] if carry is not None
                else self._stager((num, list(cats), labels)))
            idx = np.zeros((0,), np.int64)
            self.stats[cold] += 1
            self._metrics.counter(f"lookahead/{cold}").inc()
        elif len(idx):
            emb.patch_staged_carry(carry["ex"], carry["res"], idx)
        nxt = (self._prefetch_ahead(next_batch) if next_batch is not None
               else None)

        numerical, cats_d, labels_d = carry["batch"]
        with emb.staged_exchange_scope(carry["ex"], carry["row"]):
            loss = self.model.loss_fn(numerical, list(cats_d), labels_d)
        n_ex = len(carry["ex"])
        loss, dense, g_dense, g_leaves = _gradients(
            self.model, loss, carry["ex"] + carry["row"])
        g_taps = emb.exchange_transpose(g_leaves[:n_ex], g_leaves[n_ex:],
                                        carry["res"].key)
        if nxt is not None and nxt["event"] is not None:
            # the drain writes rows the prefetch reads
            torch.cuda.current_stream(emb.device).wait_event(nxt["event"])
        self.opt_state = _drain(emb, self.opt_state, g_taps, carry["res"],
                                self._sopt_for(self.opt_state),
                                self._dense_opt, dense, g_dense,
                                self._scheduled)
        if nxt is None:
            self._slots.clear()
        else:
            self._slots.stage(nxt, tag=next_batch)
        if not self.stale_ok:
            # the next step's patch: this batch's rows, from the host ids
            # while the card runs the step
            self._prev_touched = emb.touched_row_keys(host)
        self.stats["steps"] += 1
        m = self._metrics
        m.counter("lookahead/steps").inc()
        if len(idx):
            self.stats["patched_steps"] += 1
            self.stats["patched_samples"] += int(len(idx))
            self.stats["patched_samples_max"] = max(
                self.stats["patched_samples_max"], int(len(idx)))
            m.counter("lookahead/patched_steps").inc()
            m.counter("lookahead/patched_samples").inc(int(len(idx)))
            m.gauge("lookahead/patched_samples_max").set(
                self.stats["patched_samples_max"])
        return loss
