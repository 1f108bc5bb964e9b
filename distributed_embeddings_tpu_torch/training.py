"""Training: the sparse and the dense train step, `fit`, `evaluate` and
the reference's training shims.

Counterpart of ``distributed_embeddings_tpu/training.py``
(`make_sparse_train_step`, `make_train_step`, `apply_updates`, `fit`,
`evaluate`, `DistributedGradientTape`, `DistributedOptimizer`,
`BroadcastGlobalVariablesCallback`). One sparse step, on every rank of the
process group with its slice of the global batch:

1. `DistributedEmbedding.make_taps` gives the tap container; the model's
   ``loss_fn(..., taps=, return_residuals=True)`` runs the forward, whose
   mp-side exchange-group outputs and row-sliced partial outputs become
   autograd leaves (the bucket tables and row shards need no grad),
   inside the layer's `residual_sort_scope` when ``fold_sort`` is on, so
   each exchange group's ids are sorted once for lookup and update; the
   loss is the mean over the rank's slice;
2. ``torch.autograd.grad`` over (dense parameters, tap leaves) gives the
   dense gradients (the MLPs' and the dp tables') and the tap gradients
   (the activation exchange's and the reduce-scatter's backwards carry
   the latter to the ranks that own the rows);
3. at world size W > 1 the step takes the gradient of the global-batch
   mean, as the JAX package's SPMD step does: the backward starts from
   1/W (each rank's loss is the mean over its slice), so the tap
   gradients, and the wire's gradient encodes, are the JAX package's, and
   the dense gradients are summed and the loss averaged over the ranks in
   one all-reduce (`parallel.mesh.sum_across_ranks`);
4. `ops.sparse_update.drain_sparse_apply` turns the tap gradients into
   row updates of the rank's tables and their optimizer state, in place,
   through the CUDA kernels on the card (deduplicated rows, or the raw
   sorted stream under ``strategy="tiled"``);
5. the dense twin of optax's sgd / adagrad / adam updates the MLPs and
   the dp tables in place, the same on every rank.

The dense step (`make_train_step`, ``fit(sparse=False)``) differentiates
the loss in every parameter, the tables included: the tables take
``requires_grad`` for the step only, and the lookups' own backwards
(`cuda_lookup.fused_embedding_lookup`, `cuda_tiled`'s sorted lookups, the
activation exchange's transpose at world size > 1) give their dense
gradients; the dense optimizer then updates every parameter.

`fit` pulls iterable data through the ingest pipeline
(`utils.pipeline.staged_batches`: read, preprocess and the staging to the
card each in a worker thread, the copies pinned and on a side stream,
`parallel.staging.DeviceStager`; the step's stream waits for a batch's
copy when it takes the batch, `parallel.staging.ready`), and runs
`evaluate` every `eval_every` steps: the streaming AUC (`utils.metrics.StreamingAUC`) of the model's
logits, its histograms summed over the ranks.

A model built with a 16-bit ``compute_dtype`` trains through the same
steps: its tap gradients come back in that dtype and are upcast to
float32 where the update reads them (`DistributedEmbedding.sparse_update`),
the tables' dense gradients are float32 (the lookups' backwards upcast),
and the loss and the logits for the AUC are float32.

The dense twins are written to optax's expressions (``scale_by_rss``,
``scale_by_adam``, ``scale_by_learning_rate``), not taken from
``torch.optim``: its Adagrad adds eps outside the square root and starts
the accumulator at 0, and its Adam groups the bias correction differently.
"""

import itertools
from typing import Any, Callable, Dict, Optional

import torch

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding, _local_tables, broadcast_variables)
from distributed_embeddings_tpu_torch.ops.sparse_update import (
    SparseOptimizer, bias_corrections, check_strategy, dedup_sum,
    drain_sparse_apply, make_sparse_optimizer)
from distributed_embeddings_tpu_torch.parallel.mesh import (
    average_across_ranks, sum_across_ranks)
from distributed_embeddings_tpu_torch.parallel.staging import (
    DeviceStager, dp_slice, ready, stage_dp_batch)
from distributed_embeddings_tpu_torch.utils.device import device_scalar
from distributed_embeddings_tpu_torch.utils.metrics import StreamingAUC
from distributed_embeddings_tpu_torch.utils.pipeline import (
    DEFAULT_DEPTH, staged_batches)

__all__ = ["DenseOptimizer", "sgd", "adagrad", "adam",
           "make_sparse_train_step", "make_train_step", "apply_updates",
           "fit", "evaluate", "gradient_scale", "mlp_magnitudes",
           "DistributedGradientTape",
           "DistributedOptimizer", "BroadcastGlobalVariablesCallback",
           "broadcast_variables"]

# the sparse rule's hyperparameters per optimizer: adagrad's eps matches
# optax's, so the tables and the MLPs see the same rule
SPARSE_HP = {"adagrad": {"eps": 1e-7}, "adam": {}, "sgd": {}}


class DenseOptimizer:
    """A plain-torch twin of one optax optimizer over named parameters.

    ``init(params)`` -> state; ``update(params, grads, state)`` updates the
    parameters in place and returns the new state. `params` and `grads` are
    ``{name: tensor}``. `lr` is a float or a schedule ``step -> float``
    whose step count (optax's ``ScaleByScheduleState.count``) rides the
    state as ``"schedule_count"``."""

    def __init__(self, kind: str, lr, **hp):
        if kind not in ("sgd", "adagrad", "adam"):
            raise ValueError(f"Unknown dense optimizer {kind!r}")
        self.kind = kind
        self.lr = lr
        self.hp = hp

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        state: dict = {}
        if self.kind == "adagrad":
            init = self.hp.get("initial_accumulator_value", 0.1)
            state["sum_of_squares"] = {
                n: torch.full_like(p, init) for n, p in params.items()}
        elif self.kind == "adam":
            state["count"] = 0
            state["mu"] = {n: torch.zeros_like(p) for n, p in params.items()}
            state["nu"] = {n: torch.zeros_like(p) for n, p in params.items()}
        if callable(self.lr):
            state["schedule_count"] = 0
        return state

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: dict) -> dict:
        state = dict(state)
        if callable(self.lr):
            lr = float(self.lr(state["schedule_count"]))
            state["schedule_count"] += 1
        else:
            lr = float(self.lr)
        if self.kind == "adam":
            state["count"] += 1
            b1, b2 = self.hp.get("b1", 0.9), self.hp.get("b2", 0.999)
            c1, c2 = bias_corrections(state["count"], b1, b2)
        for name, p in params.items():
            g = grads[name]
            if self.kind == "sgd":
                u = g
            elif self.kind == "adagrad":
                # optax scale_by_rss
                eps = self.hp.get("eps", 1e-7)
                ss = state["sum_of_squares"][name]
                ss.copy_(g * g + ss)
                u = torch.where(ss > 0, torch.rsqrt(ss + eps),
                                torch.zeros_like(ss)) * g
            else:
                # optax scale_by_adam (eps_root 0)
                mu, nu = state["mu"][name], state["nu"][name]
                mu.copy_(g * (1 - b1) + mu * b1)
                nu.copy_((g * g) * (1 - b2) + nu * b2)
                u = (mu / device_scalar(c1, mu)) / (
                    torch.sqrt(nu / device_scalar(c2, nu))
                    + self.hp.get("eps", 1e-8))
            # optax scale_by_learning_rate, then apply_updates
            p.add_(u * (-lr))
        return state


def sgd(lr) -> DenseOptimizer:
    """Twin of ``optax.sgd(lr)``: ``p += (-lr) * g``."""
    return DenseOptimizer("sgd", lr)


def adagrad(lr, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> DenseOptimizer:
    """Twin of ``optax.adagrad``: ``ss += g*g``; ``p += (-lr) *
    (where(ss > 0, rsqrt(ss + eps), 0) * g)``."""
    return DenseOptimizer("adagrad", lr,
                          initial_accumulator_value=initial_accumulator_value,
                          eps=eps)


def adam(lr, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> DenseOptimizer:
    """Twin of ``optax.adam``: moments ``(1-b)*g + b*m``, bias-corrected
    by float32 ``1 - b**count``, ``u = m_hat / (sqrt(v_hat) + eps)``."""
    return DenseOptimizer("adam", lr, b1=b1, b2=b2, eps=eps)


def _dense_params(model) -> Dict[str, torch.Tensor]:
    """Every parameter that trains densely: all but the bucket tables and
    the row shards (which carry no grad); the dp tables among them, as in
    the JAX package's `_dense_part`."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def make_sparse_train_step(model, optimizer: str = "adagrad", lr=0.01,
                           dense_optimizer: Optional[DenseOptimizer] = None,
                           strategy: str = "auto",
                           donate: Optional[bool] = None,
                           fold_sort: bool = True):
    """Build a train step whose table updates are row-wise sparse.

    Args mirror the JAX package's: `model` exposes ``.embedding`` (a
    `DistributedEmbedding`) and ``loss_fn(numerical, cats, labels, taps=,
    return_residuals=)`` (`SyntheticModel`, `DLRM`); `optimizer` is 'sgd',
    'adagrad' or 'adam', applied sparsely to the tables and densely (its
    optax twin, or `dense_optimizer`) to the rest; `lr` is a float or a
    schedule ``step -> lr`` (the sparse optimizer is rebuilt per step at
    ``lr(opt_state["count"])``); `strategy` 'auto', 'sort', 'pallas' (the
    deduplicated-row route) or 'tiled' (the raw-stream route, see
    `ops.sparse_update`), or 'dense' (the dense aggregation; 'auto'
    takes it for adagrad and adam on a table of at most
    `sparse_update.DENSE_ELEMS_MAX` elements, as the JAX package does).
    The lookup path is the layer's own
    (`DistributedEmbedding(lookup_path=...)`). `fold_sort` (default on):
    the tapped forward sorts each exchange group's ids once and the sorted
    lookups and the update of a one-group bucket reuse that sort (a dense
    bucket's update wants none); off, each sorts afresh. The two give
    bit-identical results. `donate` is accepted and has no effect: the
    step updates the tables, their state and the MLPs in place, which is
    what the JAX package's donation buys.

    Returns (init_fn, step_fn):
      init_fn(model) -> opt_state ``{"emb": {"tp": [...], "row": [...]},
        "dense": ...}`` (+ ``"count"`` under a schedule; the dp tables'
        state is in "dense");
      step_fn(model, opt_state, numerical, cats, labels)
        -> (model, opt_state, loss): tables, state and MLPs are updated in
        place; loss is a 0-d tensor on the model's device (no host sync),
        the mean over the global batch. At world size > 1 every rank
        calls it with its slice of the global batch
        (`parallel.staging.stage_dp_batch`), or, with model-parallel input,
        its own features at global batch size beside its slice of the
        numerical features and labels.
    """
    del donate
    check_strategy(strategy)
    if optimizer not in SPARSE_HP:
        raise ValueError(f"Unknown optimizer {optimizer!r}")
    sparse_hp = SPARSE_HP[optimizer]
    scheduled = callable(lr)
    sopt = make_sparse_optimizer(optimizer, 0.0 if scheduled else lr,
                                 strategy=strategy, **sparse_hp)
    if dense_optimizer is None:
        dense_optimizer = {"sgd": sgd, "adagrad": adagrad,
                           "adam": adam}[optimizer](lr)

    def sopt_for(opt_state):
        if not scheduled:
            return sopt
        return make_sparse_optimizer(optimizer, lr(opt_state["count"]),
                                     strategy=strategy, **sparse_hp)

    def init_fn(params) -> dict:
        state = {"emb": params.embedding.init_sparse_state(sopt),
                 "dense": dense_optimizer.init(_dense_params(params))}
        if scheduled:
            state["count"] = 0
        return state

    def step_fn(params, opt_state, numerical, cats, labels):
        cats = list(cats)
        layer = params.embedding
        taps = layer.make_taps(cats)
        with layer.residual_sort_scope(fold_sort, optimizer, strategy):
            loss, res = params.loss_fn(numerical, cats, labels, taps=taps,
                                       return_residuals=True)
        dense = _dense_params(params)
        n_tp, n_row = len(taps["tp"]), len(taps["row"])
        # the hot split's leaves (one per hot exchange group, None at the
        # others)
        hot = [t for t in taps.get("hot", ()) if t is not None]
        world = layer.world_size
        # the gradient of the global-batch mean: each rank's loss is the
        # mean over its slice, its share 1/W of it, so the backward (the
        # wire's gradient encodes among it) sees the JAX package's
        # numbers
        seed = (None if world == 1 else torch.full(
            (), 1.0 / world, dtype=loss.dtype, device=loss.device))
        grads = torch.autograd.grad(
            loss, list(dense.values()) + taps["tp"] + taps["row"] + hot,
            grad_outputs=seed)
        g_taps = list(grads[len(dense):])
        if world > 1:
            *grads, loss = sum_across_ranks(
                list(grads[:len(dense)]) + [loss.detach()])
            loss = loss / device_scalar(world, loss)
        g_dense = dict(zip(dense, grads[:len(dense)]))
        g_hot = iter(g_taps[n_tp + n_row:])
        g_taps = {"tp": g_taps[:n_tp], "row": g_taps[n_tp:n_tp + n_row]}
        if "hot" in taps:
            g_taps["hot"] = [None if t is None else next(g_hot)
                             for t in taps["hot"]]
        new_state = {"emb": drain_sparse_apply(layer, opt_state["emb"],
                                               g_taps, res,
                                               sopt_for(opt_state)),
                     "dense": dense_optimizer.update(dense, g_dense,
                                                     opt_state["dense"])}
        if scheduled:
            new_state["count"] = opt_state["count"] + 1
        return params, new_state, loss.detach()

    return init_fn, step_fn


def _row_totals(emb, residuals, tap_grads) -> list:
    """Per bucket, a table-shaped tensor holding each row's total of the
    tap gradients' contributions (the rows `sparse_update` would update)."""
    ptrs = [t.data_ptr() for t in emb.tp]
    totals: list = [torch.zeros_like(t.detach()) for t in emb.tp]

    def record(table, state, grad):
        rep, sums = dedup_sum(grad.ids, grad.contribs, table.shape[0])
        valid = (rep >= 0) & (rep < table.shape[0])
        totals[ptrs.index(table.data_ptr())][rep[valid].long()] = sums[valid]
        return table, state
    emb.sparse_update({"tp": [()] * len(emb.tp), "row": []},
                      {"tp": list(tap_grads), "row": []}, residuals,
                      SparseOptimizer("record", lambda table: (), record))
    return totals


def gradient_scale(model, numerical, cats, labels) -> dict:
    """One step's gradient of every trained element, beside the scale of
    the float32 sum that computes it; updates nothing.

    Returns ``{name: (g, t)}`` for the MLP parameters (by parameter name)
    and the bucket tables (``"embedding.tp.<b>"``, table-shaped, zero on
    rows the batch does not touch), and a hot-sharded layer's hot shards
    (``"embedding.hot.<b>"``, ``[H, w]``): ``g`` the gradient, ``t`` the
    sum of the magnitudes of the terms that add up to it, i.e. the
    backward with every weight, activation and upstream gradient taken by
    absolute value and the ReLU masks kept. Where ``|g|`` is far below
    ``t`` the sum cancels, and its low digits are set by the summation
    order: another BLAS library or another device gives other digits.
    Comparisons of two trainers use it to tell such elements apart. For a model whose dense
    part is one `mlp` over the concatenated embedding outputs and numerical
    features (`SyntheticModel`), with unweighted inputs."""
    mlp = getattr(model, "mlp", None)
    if mlp is None or mlp.final_activation:
        raise TypeError("gradient_scale takes a model with one `mlp` "
                        "ending in its logit (SyntheticModel)")
    cats = list(cats)
    acts = []
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out: acts.append((mod, inp[0], out)))
        for layer in mlp]
    try:
        taps = model.embedding.make_taps(cats)
        loss, res = model.loss_fn(numerical, cats, labels, taps=taps,
                                  return_residuals=True)
    finally:
        for hook in hooks:
            hook.remove()
    dense = _dense_params(model)
    logits = acts[-1][2]
    hot = [t for t in taps.get("hot", ()) if t is not None]
    grads = torch.autograd.grad(
        loss, [*dense.values(), *taps["tp"], *hot, logits],
        retain_graph=True)
    by_name = dict(zip(dense, grads))
    # d loss / d logit: one term per row
    out, scale = mlp_magnitudes(model, acts, grads[-1].abs(), by_name)
    # the MLP input takes the tap leaves' values by selection (and
    # averaging), so its cotangent carries the scale to the taps
    n_tp = len(taps["tp"])
    tap_scale = torch.autograd.grad(acts[0][1], taps["tp"] + hot,
                                    grad_outputs=scale)
    tap_grads = grads[len(dense):-1]
    for b, pair in enumerate(zip(
            _row_totals(model.embedding, res, tap_grads[:n_tp]),
            _row_totals(model.embedding, res, tap_scale[:n_tp]))):
        out[f"embedding.tp.{b}"] = pair
    if hot:
        for b, pair in zip(model.embedding._hot_buckets, zip(
                _hot_totals(model.embedding, res, taps["hot"],
                            tap_grads[n_tp:]),
                _hot_totals(model.embedding, res, taps["hot"],
                            tap_scale[n_tp:]))):
            out[f"embedding.hot.{b}"] = pair
    return out


def mlp_magnitudes(model, acts, scale, grads, inputs=None):
    """The backward of one MLP by absolute values, the ReLU masks kept:
    from `scale` (the magnitude of d loss / d logit, ``[B, 1]``) through
    the layers `acts` recorded (``(layer, input, output)`` in forward
    order, each a `model` submodule ending in `.w` and `.b`), the sum t of
    the magnitudes of the terms of each weight's and bias's gradient.
    `inputs` are the magnitudes taken for the layers' inputs (default: each
    input by absolute value). Returns ``({"<layer>.w" / ".b": (g, t)}``
    with g from `grads` (by parameter name), the magnitude carried to the
    MLP's input)``."""
    names = {id(mod): name for name, mod in model.named_modules()}
    out = {}
    for i in reversed(range(len(acts))):
        layer, a, z = acts[i]
        if i < len(acts) - 1:
            scale = scale * (z > 0)
        name = names[id(layer)]
        m = a.detach().abs() if inputs is None else inputs[i]
        out[f"{name}.w"] = (grads[f"{name}.w"], m.t() @ scale)
        out[f"{name}.b"] = (grads[f"{name}.b"], scale.sum(0))
        scale = scale @ layer.w.detach().abs().t()
    return out, scale


def _hot_totals(emb, residuals, hot_taps, grads) -> list:
    """Per hot bucket, its [H, w] shard's row totals of the hot taps'
    `grads` (one per hot tap leaf) times the hit weights, at the hit
    positions (the sums `sparse_update`'s hot update takes)."""
    from distributed_embeddings_tpu_torch.ops.sparse_update import _dense_sum
    groups, _ = emb._exchange_groups_for_key(residuals.key)
    by_group = dict(zip([g for g, t in enumerate(hot_taps)
                         if t is not None], grads))
    totals = []
    for b in emb._hot_buckets:
        bucket = emb.plan.tp_buckets[b]
        ids, con = [], []
        for g, grp in enumerate(groups):
            if grp.bucket != b or g not in by_group:
                continue
            w = residuals.hot_w[g][0]
            ids.append(residuals.hot_pos[g][0].reshape(-1))
            con.append((by_group[g][..., None, :].float() * w[..., None]
                        ).reshape(-1, bucket.width))
        totals.append(_dense_sum(torch.cat(ids), torch.cat(con),
                                 bucket.hot_rows)[0])
    return totals


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params + updates`` (optax's convention), in place: each update is
    cast to its parameter's dtype and added. None updates are skipped.
    Returns `params`."""
    with torch.no_grad():
        for name, u in updates.items():
            if u is not None:
                params[name].add_(u.to(params[name].dtype))
    return params


def _all_params(model) -> Dict[str, torch.Tensor]:
    """Every parameter, the bucket tables included: what the dense step
    differentiates and updates."""
    return dict(model.named_parameters())


def make_train_step(loss_fn: Callable, optimizer,
                    donate: Optional[bool] = None):
    """The dense train step: gradients of every parameter, tables included.

    Args:
      loss_fn: ``(model, *batch) -> loss``, the mean over this rank's
        slice of the global batch.
      optimizer: a `DenseOptimizer` (the optax twins) or a
        `DistributedOptimizer` over one; its state comes from
        ``optimizer.init(dict(model.named_parameters()))``.
      donate: accepted and has no effect (the step updates in place).

    Returns ``step(model, opt_state, *batch) -> (model, opt_state, loss)``.
    The bucket tables take ``requires_grad`` for the step only, so the
    lookups' backwards give their dense gradients (the gather-combine
    kernel's through `cuda_lookup.fused_embedding_lookup`, the sorted
    lookups' through their `sgd_stream` at lr -1). At world size W > 1 the
    gradient is the global-batch mean's: a rank's table gradients (its
    own rows, summed over the ranks' slices by the activation exchange's
    transpose) are scaled by 1/W, and the other gradients and the loss are
    averaged over the ranks in one all-reduce. The loss is a 0-d tensor
    on the model's device. A layer with quantized buckets trains through
    the sparse step only: its payloads take no gradient (nor do they in
    the JAX package), so the dense step refuses it; so it does a layer
    with offloaded buckets, as the JAX package's does."""
    del donate

    def update(params, grads, state):
        if isinstance(optimizer, DistributedOptimizer):
            return optimizer.update(grads, state, params)
        return optimizer.update(params, grads, state)

    def step(model, opt_state, *batch):
        if any(isinstance(m, DistributedEmbedding) and m.quantized_buckets
               for m in model.modules()):
            raise ValueError(
                "the dense step differentiates float tables; a layer with "
                "quantized buckets (storage_dtype int8 / fp8) trains "
                "through make_sparse_train_step")
        if any(isinstance(m, DistributedEmbedding) and m.offloaded_buckets
               for m in model.modules()):
            raise ValueError(
                "the dense step differentiates every table on the card; a "
                "layer with offloaded buckets (gpu_embedding_size) keeps "
                "them in host memory and trains through "
                "make_sparse_train_step (the JAX package's dense step "
                "refuses such a layer too: its host and device memory "
                "spaces do not mix in one gradient)")
        if any(isinstance(m, DistributedEmbedding) and m._hot_buckets
               for m in model.modules()):
            raise ValueError(
                "the dense step differentiates the parameters, and a hot "
                "shard's rows are buffers that would not train; a layer "
                "with hot_rows trains through make_sparse_train_step")
        params = _all_params(model)
        frozen = [p for p in params.values() if not p.requires_grad]
        for p in frozen:
            p.requires_grad_(True)
        try:
            loss = loss_fn(model, *batch)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
        finally:
            for p in frozen:
                p.requires_grad_(False)
        world = _world(model)
        if world > 1:
            local = _local_tables(model)
            scale = device_scalar(world, loss)
            shared = [n for n, p in params.items() if id(p) not in local]
            *avg, loss = average_across_ranks(
                [grads[n] for n in shared] + [loss.detach()])
            grads.update(zip(shared, avg))
            for n, p in params.items():
                if id(p) in local:
                    grads[n] = grads[n] / scale
        opt_state = update(params, grads, opt_state)
        return model, opt_state, loss.detach()

    return step


def _world(model) -> int:
    """The model's world size (its embedding layer's; 1 without one)."""
    emb = getattr(model, "embedding", None)
    return getattr(emb, "world_size", 1)


def _model_device(model) -> torch.device:
    emb = getattr(model, "embedding", None)
    if emb is not None:
        return emb.device
    return next(model.parameters()).device


def _default_stage(model) -> Callable:
    """`fit`'s and `evaluate`'s staging: the ``stage`` half of a
    `DeviceStager` on the model's device (the loop takes each batch with
    `ready`); at world size > 1 with data-parallel input,
    `stage_dp_batch` through it (each rank cuts its slice of the global
    batch). Model-parallel input arrives as the rank's batch already (its
    own features at global batch size, its slice of the dense features
    and labels: `models.data.RawBinaryDataset` with
    ``categorical_features=`` and ``offset=``)."""
    stage = DeviceStager(_model_device(model)).stage
    emb = getattr(model, "embedding", None)
    if _world(model) > 1 and getattr(emb, "dp_input", True):
        return lambda batch: stage_dp_batch(batch, stage)
    return stage


def evaluate(model, data, steps: int = 16, preprocess=None,
             pipelined: bool = True) -> float:
    """Streaming AUC over `steps` batches (the JAX package's `evaluate`,
    the reference's eval loop, examples/dlrm/main.py:223-243).

    `data`: an iterable of global ``(numerical, cats, labels)`` batches, or
    a callable ``step -> batch``. Iterable data is pulled through the
    ingest pipeline (``itertools.islice`` to `steps` items, so a shared
    source is never over-read), with `preprocess` and the staging each in
    a worker (`pipelined`; False runs them inline); a callable's batches
    are staged inline. Each rank's forward takes its slice of the batch
    (`stage_dp_batch`), its `StreamingAUC` histograms accumulate on the
    device, and at world size > 1 one all-reduce sums them over the ranks
    (the reference's ``hvd.allgather``) before the host integrates them.
    Collective at world size > 1: every rank calls it."""
    device = _model_device(model)
    auc = StreamingAUC()
    state = auc.init(device)
    stage = _default_stage(model)
    get_batch = data if callable(data) else None
    pipeline = None
    if get_batch is None:
        pipeline = staged_batches(itertools.islice(iter(data), steps), stage,
                                  preprocess, pipelined=pipelined)
    try:
        with torch.no_grad():
            for s in range(steps):
                numerical, cats, labels = ready(
                    stage(get_batch(s)) if pipeline is None
                    else next(pipeline))
                logits = model(numerical, list(cats))
                auc.update(state, labels, logits)
    finally:
        if pipeline is not None:
            pipeline.close()
    auc.all_reduce(state)
    return auc.result(state)


# fit arguments of the JAX package that the port does not cover yet, with
# the value that means "unused" and the ROADMAP item that ports them
_FIT_UNPORTED = {
    "store": (None, "A12 (store and vocab)"),
    "publish_every": (None, "A12 (store and vocab)"),
    "publish_dir": (None, "A12 (store and vocab)"),
    "vocab": (None, "A12 (store and vocab)"),
    "vocab_every": (16, "A12 (store and vocab)"),
    "lookahead": (None, "A14 (lookahead)"),
    "stale_ok": (False, "A14 (lookahead)"),
    "registry": (None, "A15 (obs)"),
}


def fit(model, data, steps: int, optimizer: str = "adagrad", lr=0.01,
        sparse: bool = True, opt_state=None,
        dense_optimizer: Optional[DenseOptimizer] = None, callbacks=(),
        eval_data=None, eval_every: int = 0, eval_steps: int = 16,
        log_every: int = 100, log_fn: Callable = print, stage=None,
        sync_every: Optional[int] = None, preprocess=None,
        pipelined: bool = True, pipeline_depth: Optional[int] = None,
        hot_sync_every: int = 0, **unported):
    """The training loop (the JAX package's `fit`, which has ``params``
    where the port's model holds its own).

    Args:
      model: exposes ``.embedding`` and ``loss_fn(numerical, cats,
        labels, taps=, return_residuals=)`` (`SyntheticModel`, `DLRM`),
        and its forward for `evaluate`.
      data: an iterable of global ``(numerical, cats, labels)`` batches
        (numpy arrays or tensors), or a callable ``step -> batch``.
      steps: optimizer steps.
      optimizer / lr / dense_optimizer: see `make_sparse_train_step`.
      sparse: the sparse tapped step (default), or the dense step over
        every parameter, tables included (`make_train_step` with the
        optimizer's optax twin, or `dense_optimizer`).
      callbacks: objects with optional ``on_train_begin(model)`` and
        ``on_step(step, model, loss)`` (loss a device scalar).
      eval_data / eval_every / eval_steps: `evaluate` over `eval_steps`
        batches of `eval_data` after every `eval_every` steps; history
        gains ``"eval_auc"``.
      stage: the per-batch staging function (default: a `DeviceStager`'s
        ``stage`` on the model's device, whose batch the step's stream
        waits for when the loop takes it; at world size > 1,
        `stage_dp_batch` through it, so each rank takes its slice of the
        global batch). What it returns is taken with
        `parallel.staging.ready`.
      preprocess: an optional host transform between the reader and the
        staging (e.g. `RawBinaryDataset.preprocess` over
        ``ds.raw_batches()``). Iterable data only.
      pipelined: True (default) runs read, preprocess and stage each in a
        worker thread (`utils.pipeline.IngestPipeline`), ahead of the
        step; False runs them inline (`SerialPipeline`), in the same
        order, with bit-identical results. Iterable data only; a
        callable's batches are staged inline.
      pipeline_depth: the bound of each inter-stage queue (None: 2, the
        JAX package's default; its ``DET_PIPELINE_DEPTH`` tune seam is
        ROADMAP Queue A15).
      log_every / log_fn: log the loss every `log_every` steps.
      sync_every: read the loss back every N steps (None: 1 in a process
        group of more than one rank, keeping the ranks in lockstep, else
        0, never); also at `log_every` boundaries and at the end.
      hot_sync_every: the hot-row cadence of a layer built with
        ``hot_rows=`` (sparse steps only; 0, the default, is off): every
        ``max(1, hot_sync_every // 8)`` steps the batch's ids feed
        `observe_hot_ids`, from the host arrays the staging was handed (at
        world size > 1 the rank's slice), so observing copies nothing from
        the card; every `hot_sync_every` steps, before that step, the
        pending losses are read and `sync_hot_rows(admit=True)` writes the
        hot rows back and admits the hottest keys; after the last step a
        sync without admission leaves the tables canonical, and history
        gains ``"hot_stats"`` (`hot_stats`).

    Iterable data is taken as ``islice(iter(data), steps)``, so a shared
    source is never read past this run's steps. Returns (model,
    opt_state, history): ``history["loss"]`` as floats, ``"eval_auc"``
    with `eval_every`, ``"ingest_stages"`` (per-stage wall-time summaries)
    for iterable data. Every other argument of the JAX package's `fit` is
    taken at its default only, and raises NotImplementedError naming its
    ROADMAP item otherwise."""
    for name, value in unported.items():
        if name not in _FIT_UNPORTED:
            raise TypeError(f"fit() got an unexpected argument {name!r}")
        unused, item = _FIT_UNPORTED[name]
        if value != unused:
            raise NotImplementedError(
                f"fit({name}=...) is not ported yet (ROADMAP Queue {item})")
    if sparse:
        init_fn, step_fn = make_sparse_train_step(
            model, optimizer, lr=lr, dense_optimizer=dense_optimizer)
        if opt_state is None:
            opt_state = init_fn(model)
    else:
        opt = dense_optimizer or {"sgd": sgd, "adagrad": adagrad,
                                  "adam": adam}[optimizer](lr)
        step_fn = make_train_step(
            lambda m, numerical, cats, labels: m.loss_fn(numerical, cats,
                                                         labels), opt)
        if opt_state is None:
            opt_state = opt.init(_all_params(model))
    if sync_every is None:
        sync_every = 1 if _world(model) > 1 else 0
    for cb in callbacks:
        if hasattr(cb, "on_train_begin"):
            cb.on_train_begin(model)
    if stage is None:
        stage = _default_stage(model)
    hot_emb = getattr(model, "embedding", None)
    hot_active = bool(sparse and hot_sync_every
                      and getattr(hot_emb, "_hot_buckets", None))
    hot_stride = max(1, hot_sync_every // 8) if hot_active else 0
    if hot_active:
        stage = _observed_stage(stage, _world(model) > 1
                                and getattr(hot_emb, "dp_input", True))
    pipeline = None
    if not callable(data):
        pipeline = staged_batches(
            itertools.islice(iter(data), steps), stage,
            preprocess=preprocess,
            depth=DEFAULT_DEPTH if pipeline_depth is None
            else pipeline_depth, pipelined=pipelined)
    history: dict = {"loss": []}
    pending = []

    def drain():
        if pending:
            history["loss"].extend(torch.stack(pending).tolist())
            pending.clear()

    try:
        for step in range(steps):
            item = stage(data(step)) if pipeline is None else next(pipeline)
            if hot_active:
                item, host_cats = item
                if step % hot_stride == 0:
                    hot_emb.observe_hot_ids(list(host_cats))
                if step and step % hot_sync_every == 0:
                    drain()
                    opt_state["emb"] = hot_emb.sync_hot_rows(
                        opt_state["emb"], admit=True)
            numerical, cats, labels = ready(item)
            model, opt_state, loss = step_fn(model, opt_state, numerical,
                                             list(cats), labels)
            pending.append(loss)
            if sync_every and (step + 1) % sync_every == 0:
                drain()
            if log_every and step % log_every == 0:
                drain()
                log_fn(f"step {step}/{steps}: "
                       f"loss={history['loss'][-1]:.5f}")
            for cb in callbacks:
                if hasattr(cb, "on_step"):
                    cb.on_step(step, model, loss)
            if eval_data is not None and eval_every and \
                    (step + 1) % eval_every == 0:
                auc = evaluate(model, eval_data, eval_steps,
                               pipelined=pipelined)
                history.setdefault("eval_auc", []).append(auc)
                log_fn(f"step {step}: eval AUC={auc:.5f}")
    finally:
        if pipeline is not None:
            history["ingest_stages"] = pipeline.stage_summaries()
            pipeline.close()
    drain()
    if hot_active:
        # the tables canonical again (the hot rows written back; the hot
        # sets stay resident)
        opt_state["emb"] = hot_emb.sync_hot_rows(opt_state["emb"])
        history["hot_stats"] = hot_emb.hot_stats()
    return model, opt_state, history


def _observed_stage(stage: Callable, sliced: bool) -> Callable:
    """`stage` for a run that observes hot ids: each batch staged, beside
    its categorical inputs as the host holds them (the rank's slice when
    `sliced`), for `observe_hot_ids`."""
    def observed(batch):
        cats = batch[1]
        return stage(batch), (dp_slice(cats) if sliced else cats)
    return observed


class DistributedGradientTape:
    """The reference's ``DistributedGradientTape``: ``tape.gradient(
    loss_fn, model, *args)`` -> (loss, {name: gradient}) over the model's
    trainable parameters, with ``loss = loss_fn(model, *args, **kwargs)``.
    The gradients are data-parallel (the bucket tables carry none), so
    they and the loss are averaged over the ranks, as the reference's
    allreduce does; a rank's `loss_fn` takes the mean over its slice.
    `sparse_as_dense` is accepted and has no effect, as in the JAX
    package."""

    def __init__(self, sparse_as_dense: bool = True):
        del sparse_as_dense

    def gradient(self, loss_fn: Callable, model, *args, **kwargs):
        params = _dense_params(model)
        loss = loss_fn(model, *args, **kwargs)
        grads = torch.autograd.grad(loss, list(params.values()))
        *grads, loss = average_across_ranks(list(grads) + [loss.detach()])
        return loss, dict(zip(params, grads))


class DistributedOptimizer:
    """The reference's ``DistributedOptimizer`` over a `DenseOptimizer`:
    ``init(params)``; ``update(grads, opt_state, params)`` runs the
    optional ``postprocess(grads)`` hook, then updates `params` in place
    and returns the new state. No gradient communication is added: the
    tape's gradients are averaged already."""

    def __init__(self, optimizer: DenseOptimizer,
                 postprocess: Optional[Callable[[Any], Any]] = None):
        self._opt = optimizer
        self._postprocess = postprocess

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return self._opt.init(params)

    def update(self, grads: Dict[str, torch.Tensor], opt_state: dict,
               params: Dict[str, torch.Tensor]) -> dict:
        if self._postprocess is not None:
            grads = self._postprocess(grads)
        return self._opt.update(params, grads, opt_state)

    def apply(self, params: Dict[str, torch.Tensor],
              updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``params + updates`` in place (`apply_updates`)."""
        return apply_updates(params, updates)


class BroadcastGlobalVariablesCallback:
    """The reference's Keras callback as a `fit` callback: at
    ``on_train_begin(model)``, once, every rank takes `root_rank`'s
    data-parallel parameters (`broadcast_variables`)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self._done = False

    def on_train_begin(self, model):
        if not self._done:
            self._done = True
            broadcast_variables(model, root_rank=self.root_rank)
        return model
