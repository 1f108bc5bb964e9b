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
* ``"dense"``, the dense aggregation: `_dense_sum` sums the stream into a
  table-shaped gradient with a count column (one widened ``index_add_``,
  the counterpart of the JAX package's XLA scatter, no Pallas kernel), and
  `apply_dense_rows` applies the masked rule to every touched row. Under
  ``"auto"`` adagrad and adam take it for a table of at most
  `DENSE_ELEMS_MAX` elements, as the JAX package does (`_pick`). For sgd,
  ``"dense"`` is the JAX package's plain scatter of the raw stream, and
  ``"auto"`` keeps the deduplicated-row route: its sums are made in a
  fixed order on the card, where the scatter's atomics are not (the JAX
  package's ``"auto"`` scatters; the two differ in the last ulps, within
  its stated tolerance). On a card, ``index_add_``'s float atomics make
  the dense sums' order vary from run to run.

Each optimizer takes ``presorted=``, the `embedding_ops.GroupSort` of its id
stream that a tapped forward produced (sort folding): the route then runs
no sort of its own, with bit-identical results.

A quantized table (int8 or fp8 payload and per-row float32 scales, the
layer's ``storage_dtype``) takes `quantized_row_update` under every
strategy: `dedup_sum`, then the touched rows decoded, the float32 sgd or
adagrad rule, and a stochastically rounded re-encode (`ops.wire`).

A table in host memory (a bucket offloaded past the layer's
``gpu_embedding_size``) is updated in two halves: `prepare_safe_grad`
deduplicates its stream on the card (`dedup_sum`), and
`host_apply_rows_inplace`, the C++ loops of ``native/host_apply.cpp`` (the
JAX package's), applies the rows to the host buffers in place
(`host_apply_rows_plain`, the JAX package's numpy rules, is their twin).
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from distributed_embeddings_tpu_torch.ops import cuda_sparse, cuda_tiled, wire
from distributed_embeddings_tpu_torch.ops.cuda_sparse import bias_corrections
from distributed_embeddings_tpu_torch.ops.embedding_ops import (
    canonical_keys, segment_bounds, segment_keys, segment_starts)
from distributed_embeddings_tpu_torch.utils.device import device_scalar

__all__ = ["SparseRowGrad", "concat_grads", "dedup_sum", "sparse_sgd",
           "sparse_adagrad", "sparse_adam", "SparseOptimizer",
           "make_sparse_optimizer", "drain_sparse_apply",
           "apply_dense_rows", "update_consumes_sort", "bias_corrections",
           "quantized_row_update", "fma_f32", "STRATEGIES", "DENSE_ELEMS_MAX",
           "QUANTIZED_ROW_KINDS", "QUANTIZED_UPDATE_RANGE",
           "prepare_safe_grad", "host_apply_rows_inplace",
           "host_apply_rows_plain",
           "HOST_APPLY_KINDS"]

# strategies of the port: the deduplicated-row route, the raw-stream one
# and the dense aggregation
STRATEGIES = ("auto", "sort", "pallas", "tiled", "dense")

# "auto" aggregates a table of at most this many elements densely (the
# JAX package's default; it reads DET_SPARSE_DENSE_MAX, the port takes no
# switches)
DENSE_ELEMS_MAX = 16 * 1024 * 1024


def check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"Unknown sparse strategy {strategy!r}")


def _pick(strategy: str, rows: int, width: int) -> str:
    """The strategy a [rows, width] table takes: "auto" is "dense" up to
    `DENSE_ELEMS_MAX` elements, else "sort"; any other is itself."""
    if strategy != "auto":
        return strategy
    return "dense" if rows * width <= DENSE_ELEMS_MAX else "sort"


def update_consumes_sort(kind: str, strategy: str, rows: int,
                         width: int) -> bool:
    """Would the update of a [rows, width] table use a presorted
    `GroupSort` of its stream? The tapped forward sorts a group only where
    the answer is yes (the JAX package's rule): the dense routes aggregate
    by scatter and want no sort."""
    if kind == "sgd":
        return strategy != "dense"
    return _pick(strategy, rows, width) != "dense"


def _dense_sum(ids: torch.Tensor, contribs: torch.Tensor, rows: int):
    """[rows, w] dense aggregation of the stream plus each row's
    contribution count, out of one widened ``index_add_`` (each
    contribution row carries a 1.0 count column). Ids < 0 or >= rows are
    dropped (they land on a spare row past the table). Returns (g [rows,
    w], counts [rows]) float32."""
    w = contribs.shape[-1]
    ext = torch.cat([contribs.float(),
                     torch.ones((contribs.shape[0], 1), dtype=torch.float32,
                                device=contribs.device)], dim=1)
    safe = torch.where((ids < 0) | (ids >= rows),
                       torch.full_like(ids, rows), ids).long()
    dense = torch.zeros((rows + 1, w + 1), dtype=torch.float32,
                        device=contribs.device).index_add_(0, safe, ext)
    return dense[:rows, :w], dense[:rows, w]


def apply_dense_rows(kind: str, table: torch.Tensor, state, g: torch.Tensor,
                     touched: torch.Tensor, lr, **hp):
    """Apply a dense aggregated gradient `g` [rows, w] to the rows where
    `touched` [rows] is true, in place: the masked rules of the JAX
    package's ``apply_dense_rows``, product for product (sgd moves every
    row by ``-lr * g``, zero where untouched; adagrad and lazy adam move
    only touched rows and their state). Returns (table, state)."""
    t = touched[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=table.device)
    if kind == "sgd":
        table.add_(g * (-lr))
        return table, tuple(state)
    if kind == "adagrad":
        (acc,) = state
        eps = hp.get("eps", 1e-10)
        acc.add_(torch.where(t, g * g, zero))
        table.add_(torch.where(t, (g * (-lr)) * torch.rsqrt(acc + eps),
                               zero))
        return table, (acc,)
    if kind == "adam":
        mu, nu, count = state
        b1, b2 = hp.get("b1", 0.9), hp.get("b2", 0.999)
        eps = hp.get("eps", 1e-8)
        count = int(count) + 1
        c1, c2 = bias_corrections(count, b1, b2)
        mu.copy_(torch.where(t, mu * b1 + g * (1 - b1), mu))
        nu.copy_(torch.where(t, nu * b2 + (g * (1 - b2)) * g, nu))
        upd = ((mu / device_scalar(c1, mu)) * (-lr)) / (
            torch.sqrt(nu / device_scalar(c2, nu)) + eps)
        table.add_(torch.where(t, upd, zero))
        return table, (mu, nu, count)
    raise ValueError(f"Unknown sparse optimizer {kind!r}")


def _dense_update(kind, table, state, grad, lr, **hp):
    g, counts = _dense_sum(grad.ids, grad.contribs, table.shape[0])
    return apply_dense_rows(kind, table, state, g, counts > 0, lr, **hp)


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
    table. ``"dense"``: the JAX package's plain scatter of the raw stream
    (``table[ids] += -lr * contribs``, invalid ids dropped: they add -0.0
    to row 0, which changes no value); every other strategy sums each
    row first."""
    check_strategy(strategy)
    if strategy == "dense":
        rows = table.shape[0]
        valid = (grad.ids >= 0) & (grad.ids < rows)
        upd = torch.where(valid[:, None], grad.contribs.float() * (-lr),
                          torch.full((), -0.0, device=table.device))
        return table.index_add_(0, torch.where(valid, grad.ids,
                                               torch.zeros_like(grad.ids))
                                .long(), upd)
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
    ``"dense"`` (and ``"auto"`` on a table of at most `DENSE_ELEMS_MAX`
    elements): `_dense_sum` and `apply_dense_rows`. Returns (table,
    accum)."""
    check_strategy(strategy)
    ps = _usable_presorted(presorted, grad)
    if strategy == "tiled":
        return cuda_tiled.tiled_adagrad(table, accum, grad.ids,
                                        grad.contribs, lr, eps=eps,
                                        presorted=_stream_sort(ps))
    if _pick(strategy, *table.shape) == "dense":
        table, (accum,) = _dense_update("adagrad", table, (accum,), grad, lr,
                                        eps=eps)
        return table, accum
    rep, sums = dedup_sum(grad.ids, grad.contribs, sentinel=table.shape[0],
                          presorted=ps)
    return cuda_sparse.adagrad_rows(table, accum, rep, sums, float(lr), eps)


# ----------------------------------------------------------------- Adam
def sparse_adam(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                count: int, grad: SparseRowGrad, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                strategy: str = "auto", presorted=None):
    """Lazy row-wise Adam: moments decay only on touched rows, in place.
    `count` (a host int) is the step count before this step; the dense
    route as in `sparse_adagrad`. Returns (table, mu, nu, count + 1)."""
    check_strategy(strategy)
    ps = _usable_presorted(presorted, grad)
    if strategy == "tiled":
        return cuda_tiled.tiled_adam(table, mu, nu, count, grad.ids,
                                     grad.contribs, lr, b1=b1, b2=b2,
                                     eps=eps, presorted=_stream_sort(ps))
    if _pick(strategy, *table.shape) == "dense":
        table, (mu, nu, count) = _dense_update(
            "adam", table, (mu, nu, count), grad, lr, b1=b1, b2=b2, eps=eps)
        return table, mu, nu, count
    count = int(count) + 1
    c1, c2 = bias_corrections(count, b1, b2)
    rep, sums = dedup_sum(grad.ids, grad.contribs, sentinel=table.shape[0],
                          presorted=ps)
    cuda_sparse.adam_rows(table, mu, nu, rep, sums, float(lr), b1, b2, eps,
                          c1, c2)
    return table, mu, nu, count


# -------------------------- quantized (master-weight-free) row updates
# the optimizers whose update of a quantized table needs no float32 copy of
# it (the JAX package's list; adam refuses, see `quantized_row_update`)
QUANTIZED_ROW_KINDS = ("sgd", "adagrad")
# the profiler range of every quantized update (a no-op unless a profiler
# is on), so a trace reads its device time
QUANTIZED_UPDATE_RANGE = "quantized:update"


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32 (a fused
    multiply-add), the same bits on the CPU and on the card. In float64,
    ``a * b`` is exact and ``s = a * b + c`` carries the rounding error
    ``e`` (Knuth's two-sum); ``s`` rounded to float32 is the answer unless
    ``s`` lies exactly halfway between two float32 values, where the sign
    of ``e`` picks the neighbour the exact sum is nearer."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    r = s.float()
    d = s - r.double()
    inf = torch.full((), float("inf"), dtype=torch.float32, device=r.device)
    other = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    tie = (d != 0) & (s == (r.double() + other.double()) * 0.5)
    return torch.where(tie & (e * d > 0), other, r)


def quantized_row_update(kind: str, payload: torch.Tensor,
                         scale: torch.Tensor, state, grad: SparseRowGrad,
                         store_dtype: str, lr, eps: float = 1e-10,
                         presorted=None):
    """The JAX package's master-weight-free update of a quantized table, in
    place: `dedup_sum` of the stream (its `segment_sum_sorted` kernel),
    the touched rows' payload and scales gathered, the sgd rule (``old -
    lr * sums``) or adagrad's (the accumulator's rows plus ``sums * sums``,
    then ``old - lr * sums * (1 / sqrt(acc + eps))``), re-encoded with
    stochastic rounding (`wire.encode_rows`, ``sr=True``, at the scale of
    `wire.writeback_scale`) and written back.
    adagrad's accumulator stays float32. As the JAX package's compiled step
    rounds it, the decode ``payload * scale`` fuses with the rule's
    subtraction into one rounding (`fma_f32`). adagrad takes the reciprocal
    of a correctly rounded square root, which the card computes as the CPU
    does (the JAX package's CPU ``rsqrt`` is an estimate, an ulp off for a
    third of its inputs).

    The rounding draws depend on each element's flat position in dedup's
    ``[N, w]`` sums, so the encode sees that array's rows in place. Its
    valid slots (ids in the table) are a prefix, real segments sorted
    first, the dropped segment and the fillers after: the update reads
    their count back once and encodes only that prefix, whose positions,
    and so draws, are the whole array's. Indices are int64 throughout.

    adam raises NotImplementedError, as in the JAX package: its
    moment-normalized steps fall below the rows' quantization grid.
    Runs inside the profiler range `QUANTIZED_UPDATE_RANGE`. Returns
    (payload, scale, state)."""
    if kind not in QUANTIZED_ROW_KINDS:
        raise NotImplementedError(
            f"sparse optimizer {kind!r} has no master-weight-free "
            f"quantized-table update (available: {QUANTIZED_ROW_KINDS}); "
            "adam's moment-normalized steps fall below the row "
            "quantization grid: store this bucket at f32 or switch to "
            "sgd/row-wise adagrad")
    with record_function(QUANTIZED_UPDATE_RANGE):
        return _quantized_row_update(kind, payload, scale, state, grad,
                                     store_dtype, lr, eps, presorted)


def _quantized_row_update(kind, payload, scale, state, grad, store_dtype,
                          lr, eps, presorted):
    rows = payload.shape[0]
    ps = _usable_presorted(presorted, grad)
    rep, sums = dedup_sum(grad.ids, grad.contribs, sentinel=rows,
                          presorted=ps)
    n = int((rep < rows).sum())
    rep, sums = rep[:n].long(), sums[:n]
    if kind == "sgd":
        step = lr * sums
    else:
        (acc,) = state
        acc_rows = acc.index_select(0, rep) + sums * sums
        acc.index_copy_(0, rep, acc_rows)
        step = lr * sums * (1.0 / torch.sqrt(acc_rows + eps))
    # the payload moves as bytes (the CPU's index ops take no float8)
    raw = payload.view(torch.uint8)
    new_rows = fma_f32(raw.index_select(0, rep).view(payload.dtype).to(
        torch.float32), scale.index_select(0, rep), -step)
    p_rows, s_rows = wire.encode_rows(
        new_rows, store_dtype, sr=True,
        scale=wire.writeback_scale(new_rows, store_dtype))
    raw.index_copy_(0, rep, p_rows.view(torch.uint8))
    scale.index_copy_(0, rep, s_rows)
    return payload, scale, tuple(state)


# ------------------------------------- host-memory (offloaded) row updates
# the optimizers with a host-memory rule (the JAX package's
# HOST_SPARSE_APPLY); `host_apply_rows_inplace` also takes "set"
HOST_APPLY_KINDS = ("sgd", "adagrad", "adam")


def prepare_safe_grad(ids: torch.Tensor, contribs: torch.Tensor, rows: int):
    """`dedup_sum` of the stream made safe for an in-bounds host scatter
    (the JAX package's `prepare_safe_grad`): the padded segments alias row
    0 with zero sums. Returns (rep [N] in [0, rows), sums [N, w], valid [N]
    float32 mask); a rule that is not additive (adam's moment decay) must
    mask with `valid`."""
    rep, sums = dedup_sum(ids, contribs, sentinel=rows)
    valid = rep < rows
    return (torch.where(valid, rep, torch.zeros_like(rep)),
            torch.where(valid[:, None], sums,
                        torch.zeros((), dtype=sums.dtype,
                                    device=sums.device)),
            valid.to(torch.float32))


def _host_apply_check(table: np.ndarray, state) -> None:
    """The refusals of the host apply: a buffer that is not float32
    (TypeError) or not C-contiguous (ValueError), as the JAX function
    refuses them (the C++ loops read raw pointers with a dense row-major
    stride)."""
    arrays = [("table", table)] + [(f"state[{i}]", s)
                                   for i, s in enumerate(state)
                                   if getattr(s, "ndim", 0) >= 1]
    bad = [a.dtype for _, a in arrays if a.dtype != np.float32]
    if bad:
        raise TypeError(
            f"host_apply_rows_inplace is float32-only, got {bad}; a "
            "quantized bucket decodes its touched rows first")
    noncontig = [name for name, a in arrays if not a.flags["C_CONTIGUOUS"]]
    if noncontig:
        raise ValueError(
            f"host_apply_rows_inplace requires C-contiguous buffers; "
            f"{noncontig} are not (pass np.ascontiguousarray copies and "
            "write them back)")


def _adam_corrections(count, b1, b2):
    """Adam's float32 bias corrections ``1 - b ** count`` for the
    already incremented count."""
    cf = np.float32(count)
    return (np.float32(1.0) - np.float32(b1) ** cf,
            np.float32(1.0) - np.float32(b2) ** cf)


def host_apply_rows_inplace(kind: str, table: np.ndarray, state, rep, sums,
                            valid, lr, **hp) -> None:
    """Apply one shard's deduplicated rows (`prepare_safe_grad`'s, as
    numpy) to host-resident numpy buffers IN PLACE, through the C++ loops
    of ``native/host_apply.cpp`` (``ha_sgd`` / ``ha_adagrad`` /
    ``ha_adam``): the JAX package's `host_apply_rows_inplace`. `table` and
    the array leaves of `state` are mutated; adam's count (``state[2]``)
    must already be the incremented one (the caller increments it).
    ``kind="set"`` writes `sums` as the rows' new values (a masked
    assignment, in numpy). Refuses a buffer that is not float32
    (TypeError) or not C-contiguous (ValueError), as the JAX function
    does; a native library that does not build raises. Each C++ call adds
    one to ``native.loader.calls["host_apply"]``. `host_apply_rows_plain`
    is its numpy twin."""
    import ctypes

    from distributed_embeddings_tpu_torch.native import loader
    _host_apply_check(table, state)
    if kind not in ("set", *HOST_APPLY_KINDS):
        raise NotImplementedError(
            f"no host-memory apply rule for optimizer {kind!r}")
    n, w = sums.shape
    rep = np.ascontiguousarray(rep, dtype=np.int32)
    sums = np.ascontiguousarray(sums, dtype=np.float32)
    valid = np.ascontiguousarray(valid, dtype=np.float32)
    if kind == "set":
        ok = valid > 0.0
        table[rep[ok]] = sums[ok]
        return
    lib = loader.load()

    def ptr(a):
        return ctypes.c_void_p(a.ctypes.data)
    lr = float(lr)
    loader.count("host_apply")
    if kind == "sgd":
        lib.ha_sgd(ptr(table), w, ptr(rep), ptr(sums), ptr(valid), n, lr)
    elif kind == "adagrad":
        (acc,) = state
        lib.ha_adagrad(ptr(table), ptr(acc), w, ptr(rep), ptr(sums),
                       ptr(valid), n, lr, float(hp.get("eps", 1e-10)))
    else:
        mu, nu, count = state
        b1 = float(hp.get("b1", 0.9))
        b2 = float(hp.get("b2", 0.999))
        c1, c2 = _adam_corrections(count, b1, b2)
        lib.ha_adam(ptr(table), ptr(mu), ptr(nu), w, ptr(rep), ptr(sums),
                    ptr(valid), n, lr, b1, b2, float(c1), float(c2),
                    float(hp.get("eps", 1e-8)))


def host_apply_rows_plain(kind: str, table: np.ndarray, state, rep, sums,
                          valid, lr, **hp) -> None:
    """The numpy twin of `host_apply_rows_inplace`: the JAX package's
    numpy rules, product for product, with the same refusals. The valid
    rows are unique, so each rule updates its rows with one gather and one
    scatter (equal, element for element, to the JAX function's
    ``np.add.at``)."""
    _host_apply_check(table, state)
    lr = float(lr)
    ok = np.asarray(valid, dtype=np.float32) > 0.0
    r = np.asarray(rep).astype(np.int64)[ok]
    s = np.ascontiguousarray(sums, dtype=np.float32)[ok]
    if kind == "set":
        table[r] = s
    elif kind == "sgd":
        table[r] += (-lr * s).astype(np.float32)
    elif kind == "adagrad":
        (acc,) = state
        eps = np.float32(hp.get("eps", 1e-10))
        acc_r = acc[r] + s * s
        acc[r] = acc_r
        table[r] += (-lr * s / np.sqrt(acc_r + eps)).astype(np.float32)
    elif kind == "adam":
        mu, nu, count = state
        b1 = np.float32(hp.get("b1", 0.9))
        b2 = np.float32(hp.get("b2", 0.999))
        eps = np.float32(hp.get("eps", 1e-8))
        c1, c2 = _adam_corrections(count, b1, b2)
        mu_new = b1 * mu[r] + (np.float32(1.0) - b1) * s
        nu_new = b2 * nu[r] + (np.float32(1.0) - b2) * s * s
        mu[r] = mu_new
        nu[r] = nu_new
        table[r] += (-lr * (mu_new / c1) / (np.sqrt(nu_new / c2) + eps)
                     ).astype(np.float32)
    else:
        raise NotImplementedError(
            f"no host-memory apply rule for optimizer {kind!r}")


# ------------------------------------------------- optimizer description
class SparseOptimizer(NamedTuple):
    """A (init, update) pair over one table; ``update(table, state, grad,
    presorted=None)`` updates table and state in place and returns (table,
    state); `presorted` is the `GroupSort` of the grad's id stream, when a
    tapped forward produced one. `kind` selects the rule; lr and the
    hyperparameters are closed over, in `quantized` too: ``quantized(
    payload, scale, state, grad, store_dtype, presorted=None)`` is the
    same rule on a quantized table (`quantized_row_update`, in place;
    returns the state), None for a kind that has none; ``dense_rows(
    table, state, grad, mask)`` the same rule from a dense [rows, w]
    gradient on the rows where `mask` is true (`apply_dense_rows`, in
    place; returns the state), the hot shards' update. `lr` (a float)
    and `hp` (sorted (name, value) pairs) are the rule's, which the host
    apply of an offloaded bucket reads (the JAX package's fields)."""
    kind: str
    init: Callable       # table -> state tuple
    update: Callable     # (table, state, SparseRowGrad, presorted=None)
                         #   -> (table, state)
    quantized: Optional[Callable] = None
    dense_rows: Optional[Callable] = None
    lr: float = 0.0
    hp: tuple = ()


def make_sparse_optimizer(kind: str, lr, strategy: str = "auto",
                          **hp) -> SparseOptimizer:
    """kind in {'sgd', 'adagrad', 'adam'}, with the JAX package's defaults
    (adagrad: initial_accumulator_value 0.1, eps 1e-10; adam: b1 0.9, b2
    0.999, eps 1e-8). State tensors are allocated on the table's device."""
    check_strategy(strategy)

    def quantized_rule(**kw):
        def quantized(payload, scale, state, g, store_dtype, presorted=None):
            return quantized_row_update(kind, payload, scale, state, g,
                                        store_dtype, lr, presorted=presorted,
                                        **kw)[2]
        return quantized

    def dense_rule(**kw):
        def dense_rows(table, state, g, mask):
            return apply_dense_rows(kind, table, state, g, mask, lr, **kw)[1]
        return dense_rows
    if kind == "sgd":
        return SparseOptimizer(
            "sgd", lambda table: (),
            lambda table, state, g, presorted=None: (
                sparse_sgd(table, g, lr, strategy, presorted), ()),
            quantized_rule(), dense_rule(), lr)
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
        return SparseOptimizer("adagrad", init, update,
                               quantized_rule(eps=eps), dense_rule(eps=eps),
                               lr, (("eps", eps),))
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
        return SparseOptimizer("adam", init, update, None,
                               dense_rule(b1=b1, b2=b2, eps=eps), lr,
                               (("b1", b1), ("b2", b2), ("eps", eps)))
    raise ValueError(f"Unknown sparse optimizer {kind!r}")


def drain_sparse_apply(emb, state_emb: dict, tap_grads: dict, residuals,
                       opt: SparseOptimizer) -> dict:
    """Apply one batch's tap gradients to the embedding tables (the tail of
    every train step): `DistributedEmbedding.sparse_update`, in place.
    Returns the new state pytree (an offloaded bucket's rows applied in
    host memory)."""
    return emb.sparse_update(state_emb, tap_grads, residuals, opt)
