"""Training: the sparse train step and a minimal `fit`.

Counterpart of ``distributed_embeddings_tpu/training.py``
(`make_sparse_train_step`, `fit`) at world size 1. One step:

1. `DistributedEmbedding.make_taps` gives the tap container; the model's
   ``loss_fn(..., taps=, return_residuals=True)`` runs the forward, whose
   exchange-group outputs become autograd leaves (the tables need no grad);
2. ``torch.autograd.grad`` over (dense parameters, tap leaves) gives the
   MLP gradients and the tap gradients;
3. `ops.sparse_update.drain_sparse_apply` turns the tap gradients into
   deduplicated row updates of the tables and their optimizer state, in
   place, through the CUDA kernels on the card;
4. the dense twin of optax's sgd / adagrad / adam updates the MLPs in place.

The dense twins are written to optax's expressions (``scale_by_rss``,
``scale_by_adam``, ``scale_by_learning_rate``), not taken from
``torch.optim``: its Adagrad adds eps outside the square root and starts
the accumulator at 0, and its Adam groups the bias correction differently.
"""

from typing import Callable, Dict, Optional

import torch

from distributed_embeddings_tpu_torch.ops.sparse_update import (
    SparseOptimizer, bias_corrections, check_strategy, dedup_sum,
    drain_sparse_apply, make_sparse_optimizer)
from distributed_embeddings_tpu_torch.utils.device import device_scalar

__all__ = ["DenseOptimizer", "sgd", "adagrad", "adam",
           "make_sparse_train_step", "fit", "gradient_scale"]

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
    """Every parameter that trains densely: all but the bucket tables
    (which carry no grad)."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def make_sparse_train_step(model, optimizer: str = "adagrad", lr=0.01,
                           dense_optimizer: Optional[DenseOptimizer] = None,
                           strategy: str = "auto", fold_sort: bool = True):
    """Build a train step whose table updates are row-wise sparse.

    Args mirror the JAX package's: `model` exposes ``.embedding`` (a
    `DistributedEmbedding`) and ``loss_fn(numerical, cats, labels, taps=,
    return_residuals=)`` (`SyntheticModel`, `DLRM`); `optimizer` is 'sgd',
    'adagrad' or 'adam', applied sparsely to the tables and densely (its
    optax twin, or `dense_optimizer`) to the rest; `lr` is a float or a
    schedule ``step -> lr`` (the sparse optimizer is rebuilt per step at
    ``lr(opt_state["count"])``); `strategy` 'auto', 'sort' or 'pallas' (one
    route, see `ops.sparse_update`). `fold_sort` is accepted with the JAX
    default, and the step always sorts afresh: the JAX package pins the two
    bit-identical, and folding is not ported yet (ROADMAP Queue A2).

    Returns (init_fn, step_fn):
      init_fn(model) -> opt_state ``{"emb": {"tp": [...], "row": []},
        "dense": ...}`` (+ ``"count"`` under a schedule);
      step_fn(model, opt_state, numerical, cats, labels)
        -> (model, opt_state, loss): tables, state and MLPs are updated in
        place; loss is a 0-d tensor on the model's device (no host sync).
    """
    del fold_sort
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
        loss, res = params.loss_fn(numerical, cats, labels, taps=taps,
                                   return_residuals=True)
        dense = _dense_params(params)
        grads = torch.autograd.grad(loss, list(dense.values()) + taps["tp"])
        g_dense = dict(zip(dense, grads[:len(dense)]))
        g_taps = {"tp": list(grads[len(dense):]), "row": []}
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
    rows the batch does not touch): ``g`` the gradient, ``t`` the sum of
    the magnitudes of the terms that add up to it, i.e. the backward with
    every weight, activation and upstream gradient taken by absolute value
    and the ReLU masks kept. Where ``|g|`` is far below ``t`` the sum
    cancels, and its low digits are set by the summation order: another
    BLAS library or another device gives other digits. Comparisons of two
    trainers use it to tell such elements apart. For a model whose dense
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
    grads = torch.autograd.grad(
        loss, [*dense.values(), *taps["tp"], logits], retain_graph=True)
    by_name = dict(zip(dense, grads))
    names = {id(mod): name for name, mod in model.named_modules()}
    scale = grads[-1].abs()        # d loss / d logit: one term per row
    out = {}
    for i in reversed(range(len(acts))):
        layer, a, z = acts[i]
        if i < len(acts) - 1:
            scale = scale * (z > 0)
        name = names[id(layer)]
        out[f"{name}.w"] = (by_name[f"{name}.w"],
                            a.detach().abs().t() @ scale)
        out[f"{name}.b"] = (by_name[f"{name}.b"], scale.sum(0))
        scale = scale @ layer.w.detach().abs().t()
    # the MLP input takes the tap leaves' values by selection (and
    # averaging), so its cotangent carries the scale to the taps
    tap_scale = torch.autograd.grad(acts[0][1], taps["tp"],
                                    grad_outputs=scale)
    tap_grads = grads[len(dense):-1]
    for b, pair in enumerate(zip(_row_totals(model.embedding, res, tap_grads),
                                 _row_totals(model.embedding, res,
                                             tap_scale))):
        out[f"embedding.tp.{b}"] = pair
    return out


# fit arguments of the JAX package that this slice does not cover, with
# the value that means "unused" and the ROADMAP item that ports them
_FIT_UNPORTED = {
    "eval_data": (None, "A2, open: fit's eval"),
    "eval_every": (0, "A2, open: fit's eval"),
    "stage": (None, "A11 (ingest)"),
    "preprocess": (None, "A11 (ingest)"),
    "pipelined": (False, "A11 (ingest)"),
    "pipeline_depth": (None, "A11 (ingest)"),
    "hot_sync_every": (0, "A7 (hot-row replication)"),
    "store": (None, "A12 (store and vocab)"),
    "publish_every": (None, "A12 (store and vocab)"),
    "publish_dir": (None, "A12 (store and vocab)"),
    "vocab": (None, "A12 (store and vocab)"),
    "lookahead": (None, "A14 (lookahead)"),
    "stale_ok": (False, "A14 (lookahead)"),
    "registry": (None, "A15 (obs)"),
}


def fit(model, data, steps: int, optimizer: str = "adagrad", lr=0.01,
        sparse: bool = True, opt_state=None,
        dense_optimizer: Optional[DenseOptimizer] = None, callbacks=(),
        log_every: int = 100, log_fn: Callable = print, **unported):
    """Minimal training loop (the JAX package's `fit` at world size 1,
    sparse path): `data` is an iterable of (numerical, cats, labels)
    batches or a callable ``step -> batch``. Callbacks may define
    ``on_train_begin(model)`` and ``on_step(step, model, loss)`` (loss a
    device scalar). The loss is read back to the host only at `log_every`
    boundaries and at the end.

    Returns (model, opt_state, history) with ``history["loss"]`` as floats.
    Every other argument of the JAX package's `fit` raises
    NotImplementedError naming its ROADMAP item."""
    for name, value in unported.items():
        if name not in _FIT_UNPORTED:
            raise TypeError(f"fit() got an unexpected argument {name!r}")
        unused, item = _FIT_UNPORTED[name]
        if value != unused:
            raise NotImplementedError(
                f"fit({name}=...) is not ported yet (ROADMAP Queue {item})")
    if not sparse:
        raise NotImplementedError(
            "fit(sparse=False), dense table gradients, is not ported yet "
            "(ROADMAP Queue A2, open: the dense and tiled strategies)")
    init_fn, step_fn = make_sparse_train_step(
        model, optimizer, lr=lr, dense_optimizer=dense_optimizer)
    if opt_state is None:
        opt_state = init_fn(model)
    for cb in callbacks:
        if hasattr(cb, "on_train_begin"):
            cb.on_train_begin(model)
    batches = None if callable(data) else iter(data)
    history: dict = {"loss": []}
    pending = []

    def drain():
        if pending:
            history["loss"].extend(torch.stack(pending).tolist())
            pending.clear()

    for step in range(steps):
        numerical, cats, labels = (data(step) if batches is None
                                   else next(batches))
        model, opt_state, loss = step_fn(model, opt_state, numerical, cats,
                                         labels)
        pending.append(loss)
        if log_every and step % log_every == 0:
            drain()
            log_fn(f"step {step}/{steps}: loss={history['loss'][-1]:.5f}")
        for cb in callbacks:
            if hasattr(cb, "on_step"):
                cb.on_step(step, model, loss)
    drain()
    return model, opt_state, history
