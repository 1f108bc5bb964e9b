"""Sparse embedding-table updates: aggregate duplicate rows, update each once.

Counterpart of ``distributed_embeddings_tpu/ops/sparse_update.py`` on its
deduplicated-row route. A `SparseRowGrad` carries one gradient row per
looked-up id (duplicates allowed); `dedup_sum` sorts the ids and sums each
id's rows (`cuda_sparse.segment_sum_sorted`), and a row-wise optimizer
updates each unique row once (`cuda_sparse.sgd_rows` / `adagrad_rows` /
`adam_rows`). The tables and optimizer state are updated IN PLACE, where
the JAX package returns new (donated) arrays; the functions still return
them so the call sites read like the JAX package's.

Strategies: ``"auto"``, ``"sort"`` and ``"pallas"`` all take this route.
The JAX package pins its fused ``pallas`` strategy bit-exact against
``sort`` (tests/test_pallas_fused.py), so the route has one meaning; its
``"dense"`` and ``"tiled"`` strategies are not ported yet.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.ops import cuda_sparse

__all__ = ["SparseRowGrad", "concat_grads", "dedup_sum", "sparse_sgd",
           "sparse_adagrad", "sparse_adam", "SparseOptimizer",
           "make_sparse_optimizer", "drain_sparse_apply", "STRATEGIES"]

# strategies served by the deduplicated-row route
STRATEGIES = ("auto", "sort", "pallas")


def check_strategy(strategy: str) -> None:
    if strategy in ("dense", "tiled"):
        raise NotImplementedError(
            f"strategy={strategy!r} is not ported yet (ROADMAP Queue A2, "
            "open: the dense and tiled strategies)")
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


def dedup_sum(ids: torch.Tensor, contribs: torch.Tensor, sentinel: int):
    """Aggregate duplicate row ids: returns (rep [N], sums [N, w]) where
    segment s's id sits at rep[s] with its total in sums[s].

    The JAX package's contract, kept whole: negative ids and ids >= V
    collapse onto `sentinel` (one dropped segment); rep is STRICTLY
    INCREASING (real segments carry the sorted unique ids, unused slot s
    carries ``sentinel + s``); sums is zero in unused slots; nothing is
    read back to the host. The sort is ``torch.sort(stable=True)``; the
    segment bounds come from the sorted keys (cumsum of segment starts and
    one scatter of their positions), and the sum is the
    `segment_sum_sorted` kernel, which adds each segment's rows in sorted
    order."""
    n = ids.shape[0]
    dev = ids.device
    key_dtype = torch.int32 if sentinel + n < 2**31 else torch.int64
    keys = torch.where((ids < 0) | (ids > sentinel),
                       torch.full((), sentinel, dtype=ids.dtype, device=dev),
                       ids).to(key_dtype)
    sid, perm = torch.sort(keys, stable=True)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        torch.ne(sid[1:], sid[:-1], out=is_start[1:])
    seg = torch.cumsum(is_start, 0) - 1                       # int64
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    # starts[s] = first sorted position of segment s; slots past the last
    # segment keep n (empty). Non-starts scatter into a dump slot n + 1.
    starts = torch.full((n + 2,), n, dtype=torch.int64, device=dev)
    starts.scatter_(0, torch.where(is_start, seg, n + 1), iota)
    sums = cuda_sparse.segment_sum_sorted(contribs.contiguous(), perm,
                                          starts[:n + 1])
    rep = (iota + sentinel).to(key_dtype)
    rep.scatter_(0, seg, sid)
    return rep, sums


# ------------------------------------------------------------------ SGD
def sparse_sgd(table: torch.Tensor, grad: SparseRowGrad, lr,
               strategy: str = "auto") -> torch.Tensor:
    """``table[r] -= lr * (sum of r's contribs)``, in place. Returns
    table."""
    check_strategy(strategy)
    rep, sums = dedup_sum(grad.ids, grad.contribs, sentinel=table.shape[0])
    return cuda_sparse.sgd_rows(table, rep, sums, float(lr))


# -------------------------------------------------------------- Adagrad
def sparse_adagrad(table: torch.Tensor, accum: torch.Tensor,
                   grad: SparseRowGrad, lr, eps: float = 1e-10,
                   strategy: str = "auto"):
    """Row-wise adagrad on the touched rows, in place:
        acc[r]   += (sum of contribs for r)^2
        table[r] -= lr * sum / sqrt(acc[r] + eps)
    Returns (table, accum)."""
    check_strategy(strategy)
    rep, sums = dedup_sum(grad.ids, grad.contribs, sentinel=table.shape[0])
    return cuda_sparse.adagrad_rows(table, accum, rep, sums, float(lr), eps)


# ----------------------------------------------------------------- Adam
def bias_corrections(count: int, b1: float, b2: float):
    """float32 ``1 - b1**count`` and ``1 - b2**count``, as the JAX package
    computes them (float32 power of the float32 decay)."""
    cf = np.float32(count)
    return (float(np.float32(1.0) - np.float32(b1) ** cf),
            float(np.float32(1.0) - np.float32(b2) ** cf))


def sparse_adam(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                count: int, grad: SparseRowGrad, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                strategy: str = "auto"):
    """Lazy row-wise Adam: moments decay only on touched rows, in place.
    `count` (a host int) is the step count before this step. Returns
    (table, mu, nu, count + 1)."""
    check_strategy(strategy)
    count = int(count) + 1
    c1, c2 = bias_corrections(count, b1, b2)
    rep, sums = dedup_sum(grad.ids, grad.contribs, sentinel=table.shape[0])
    cuda_sparse.adam_rows(table, mu, nu, rep, sums, float(lr), b1, b2, eps,
                          c1, c2)
    return table, mu, nu, count


# ------------------------------------------------- optimizer description
class SparseOptimizer(NamedTuple):
    """A (init, update) pair over one table; `update(table, state, grad)`
    updates table and state in place and returns (table, state). `kind`
    selects the rule; lr and the hyperparameters are closed over."""
    kind: str
    init: Callable       # table -> state tuple
    update: Callable     # (table, state, SparseRowGrad) -> (table, state)


def make_sparse_optimizer(kind: str, lr, strategy: str = "auto",
                          **hp) -> SparseOptimizer:
    """kind in {'sgd', 'adagrad', 'adam'}, with the JAX package's defaults
    (adagrad: initial_accumulator_value 0.1, eps 1e-10; adam: b1 0.9, b2
    0.999, eps 1e-8). State tensors are allocated on the table's device."""
    check_strategy(strategy)
    if kind == "sgd":
        return SparseOptimizer(
            "sgd", lambda table: (),
            lambda table, state, g: (sparse_sgd(table, g, lr, strategy), ()))
    if kind == "adagrad":
        init_acc = hp.get("initial_accumulator_value", 0.1)
        eps = hp.get("eps", 1e-10)

        def init(table):
            return (torch.full(table.shape, init_acc, dtype=torch.float32,
                               device=table.device),)

        def update(table, state, g):
            t, acc = sparse_adagrad(table, state[0], g, lr, eps=eps,
                                    strategy=strategy)
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

        def update(table, state, g):
            t, mu, nu, c = sparse_adam(table, state[0], state[1], state[2],
                                       g, lr, b1=b1, b2=b2, eps=eps,
                                       strategy=strategy)
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
