"""Sparse embedding-table updates: aggregate duplicate rows, update each once.

Counterpart of ``distributed_embeddings_tpu/ops/sparse_update.py``. A
`SparseRowGrad` carries one gradient row per looked-up id (duplicates
allowed). The tables and optimizer state are updated IN PLACE, where the
JAX package returns new (donated) arrays; the functions still return them
so the call sites read like the JAX package's.

Strategies:
* ``"auto"``, ``"sort"`` and ``"pallas"``, the deduplicated-row route:
  `dedup_sum` sorts the ids and sums each id's rows
  (`cuda_sparse.segment_sum_sorted`), and a row-wise optimizer updates each
  unique row once (`cuda_sparse.sgd_rows` / `adagrad_rows` / `adam_rows`).
  The JAX package pins its fused ``pallas`` strategy bit-exact against
  ``sort``, so the route has one meaning.
* ``"tiled"``, the raw-stream route: the ids are sorted and one kernel per
  table sums each segment of the raw stream and applies the rule
  (`cuda_tiled.tiled_sgd` / `tiled_adagrad` / `tiled_adam`). It gives the
  same tables as the deduplicated-row route, bit for bit, with no [N, W]
  sums array between two kernels.
``"dense"`` is not ported yet.

Each optimizer takes ``presorted=``, the `embedding_ops.GroupSort` of its id
stream that a tapped forward produced (sort folding): the route then runs
no sort of its own, with bit-identical results.
"""

from typing import Callable, NamedTuple

import torch

from distributed_embeddings_tpu_torch.ops import cuda_sparse, cuda_tiled
from distributed_embeddings_tpu_torch.ops.cuda_sparse import bias_corrections
from distributed_embeddings_tpu_torch.ops.embedding_ops import (
    canonical_keys, segment_bounds, segment_keys, segment_starts)

__all__ = ["SparseRowGrad", "concat_grads", "dedup_sum", "sparse_sgd",
           "sparse_adagrad", "sparse_adam", "SparseOptimizer",
           "make_sparse_optimizer", "drain_sparse_apply",
           "bias_corrections", "STRATEGIES"]

# strategies of the port: the deduplicated-row route and the raw-stream one
STRATEGIES = ("auto", "sort", "pallas", "tiled")


def check_strategy(strategy: str) -> None:
    if strategy == "dense":
        raise NotImplementedError(
            "strategy='dense' is not ported yet (ROADMAP Queue A2, open: "
            "the dense strategy)")
    if strategy not in STRATEGIES:
        raise ValueError(f"Unknown sparse strategy {strategy!r}")


class SparseRowGrad(NamedTuple):
    """Per-contribution gradient for one table: row ``ids[n]`` received
    gradient row ``contribs[n]``. Duplicate ids allowed; padded slots carry
    zero contribs (any id) or an id outside [0, V) (dropped)."""
    ids: torch.Tensor       # [N] int32 / int64
    contribs: torch.Tensor  # [N, w] float32


def concat_grads(grads) -> SparseRowGrad:
    grads = list(grads)
    if len(grads) == 1:
        return grads[0]
    return SparseRowGrad(torch.cat([g.ids for g in grads]),
                         torch.cat([g.contribs for g in grads], dim=0))


def dedup_sum(ids: torch.Tensor, contribs: torch.Tensor, sentinel: int,
              presorted=None):
    """Aggregate duplicate row ids: returns (rep [N], sums [N, w]) where
    segment s's id sits at rep[s] with its total in sums[s].

    The JAX package's contract, kept whole: negative ids and ids >= V
    collapse onto `sentinel` (one dropped segment); rep is STRICTLY
    INCREASING (real segments carry the sorted unique ids, unused slot s
    carries ``sentinel + s``); sums is zero in unused slots; nothing is
    read back to the host. The sort is ``torch.sort(stable=True)`` of the
    canonical keys (`embedding_ops.canonical_keys`); the segment bounds
    come from the sorted keys (`embedding_ops.segment_bounds`), and the sum
    is the `segment_sum_sorted` kernel, which adds each segment's rows in
    sorted order. `presorted` (a `GroupSort` of this id stream with
    ``rows == sentinel``) replaces the sort, bit-identically."""
    if presorted is not None:
        sid, perm, is_start = (presorted.sid, presorted.perm,
                               presorted.seg_start)
    else:
        sid, perm = torch.sort(canonical_keys(ids, sentinel), stable=True)
        is_start = segment_starts(sid)
    starts, seg = segment_bounds(is_start)
    sums = cuda_sparse.segment_sum_sorted(contribs.contiguous(), perm,
                                          starts)
    return segment_keys(sid, seg, sentinel), sums


def _usable_presorted(presorted, grad: SparseRowGrad):
    """The given GroupSort, or None when it does not cover exactly this id
    stream (e.g. one group's sort offered for a multi-group concat): the
    update then sorts afresh rather than misreading the artifact."""
    if presorted is None or presorted.sid.shape[0] != grad.ids.shape[0]:
        return None
    return presorted


def _stream_sort(ps):
    return None if ps is None else (ps.sid, ps.perm)


# ------------------------------------------------------------------ SGD
def sparse_sgd(table: torch.Tensor, grad: SparseRowGrad, lr,
               strategy: str = "auto", presorted=None) -> torch.Tensor:
    """``table[r] -= lr * (sum of r's contribs)``, in place. Returns
    table."""
    check_strategy(strategy)
    ps = _usable_presorted(presorted, grad)
    if strategy == "tiled":
        return cuda_tiled.tiled_sgd(table, grad.ids, grad.contribs, lr,
                                    presorted=_stream_sort(ps))
    rep, sums = dedup_sum(grad.ids, grad.contribs, sentinel=table.shape[0],
                          presorted=ps)
    return cuda_sparse.sgd_rows(table, rep, sums, float(lr))


# -------------------------------------------------------------- Adagrad
def sparse_adagrad(table: torch.Tensor, accum: torch.Tensor,
                   grad: SparseRowGrad, lr, eps: float = 1e-10,
                   strategy: str = "auto", presorted=None):
    """Row-wise adagrad on the touched rows, in place:
        acc[r]   += (sum of contribs for r)^2
        table[r] -= lr * sum / sqrt(acc[r] + eps)
    Returns (table, accum)."""
    check_strategy(strategy)
    ps = _usable_presorted(presorted, grad)
    if strategy == "tiled":
        return cuda_tiled.tiled_adagrad(table, accum, grad.ids,
                                        grad.contribs, lr, eps=eps,
                                        presorted=_stream_sort(ps))
    rep, sums = dedup_sum(grad.ids, grad.contribs, sentinel=table.shape[0],
                          presorted=ps)
    return cuda_sparse.adagrad_rows(table, accum, rep, sums, float(lr), eps)


# ----------------------------------------------------------------- Adam
def sparse_adam(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                count: int, grad: SparseRowGrad, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                strategy: str = "auto", presorted=None):
    """Lazy row-wise Adam: moments decay only on touched rows, in place.
    `count` (a host int) is the step count before this step. Returns
    (table, mu, nu, count + 1)."""
    check_strategy(strategy)
    ps = _usable_presorted(presorted, grad)
    if strategy == "tiled":
        return cuda_tiled.tiled_adam(table, mu, nu, count, grad.ids,
                                     grad.contribs, lr, b1=b1, b2=b2,
                                     eps=eps, presorted=_stream_sort(ps))
    count = int(count) + 1
    c1, c2 = bias_corrections(count, b1, b2)
    rep, sums = dedup_sum(grad.ids, grad.contribs, sentinel=table.shape[0],
                          presorted=ps)
    cuda_sparse.adam_rows(table, mu, nu, rep, sums, float(lr), b1, b2, eps,
                          c1, c2)
    return table, mu, nu, count


# ------------------------------------------------- optimizer description
class SparseOptimizer(NamedTuple):
    """A (init, update) pair over one table; ``update(table, state, grad,
    presorted=None)`` updates table and state in place and returns (table,
    state); `presorted` is the `GroupSort` of the grad's id stream, when a
    tapped forward produced one. `kind` selects the rule; lr and the
    hyperparameters are closed over."""
    kind: str
    init: Callable       # table -> state tuple
    update: Callable     # (table, state, SparseRowGrad, presorted=None)
                         #   -> (table, state)


def make_sparse_optimizer(kind: str, lr, strategy: str = "auto",
                          **hp) -> SparseOptimizer:
    """kind in {'sgd', 'adagrad', 'adam'}, with the JAX package's defaults
    (adagrad: initial_accumulator_value 0.1, eps 1e-10; adam: b1 0.9, b2
    0.999, eps 1e-8). State tensors are allocated on the table's device."""
    check_strategy(strategy)
    if kind == "sgd":
        return SparseOptimizer(
            "sgd", lambda table: (),
            lambda table, state, g, presorted=None: (
                sparse_sgd(table, g, lr, strategy, presorted), ()))
    if kind == "adagrad":
        init_acc = hp.get("initial_accumulator_value", 0.1)
        eps = hp.get("eps", 1e-10)

        def init(table):
            return (torch.full(table.shape, init_acc, dtype=torch.float32,
                               device=table.device),)

        def update(table, state, g, presorted=None):
            t, acc = sparse_adagrad(table, state[0], g, lr, eps=eps,
                                    strategy=strategy, presorted=presorted)
            return t, (acc,)
        return SparseOptimizer("adagrad", init, update)
    if kind == "adam":
        b1, b2 = hp.get("b1", 0.9), hp.get("b2", 0.999)
        eps = hp.get("eps", 1e-8)

        def init(table):
            return (torch.zeros(table.shape, dtype=torch.float32,
                                device=table.device),
                    torch.zeros(table.shape, dtype=torch.float32,
                                device=table.device),
                    0)

        def update(table, state, g, presorted=None):
            t, mu, nu, c = sparse_adam(table, state[0], state[1], state[2],
                                       g, lr, b1=b1, b2=b2, eps=eps,
                                       strategy=strategy, presorted=presorted)
            return t, (mu, nu, c)
        return SparseOptimizer("adam", init, update)
    raise ValueError(f"Unknown sparse optimizer {kind!r}")


def drain_sparse_apply(emb, state_emb: dict, tap_grads: dict, residuals,
                       opt: SparseOptimizer) -> dict:
    """Apply one batch's tap gradients to the embedding tables (the tail of
    every train step): `DistributedEmbedding.sparse_update`, in place.
    Returns the new state pytree. Offloaded buckets are not ported (ROADMAP
    Queue A8)."""
    return emb.sparse_update(state_emb, tap_grads, residuals, opt)
