"""Sorted-stream lookups and raw-stream row updates: the hand-written CUDA
kernels of ``csrc/sorted_stream.cu``.

Counterpart of ``distributed_embeddings_tpu/ops/pallas_tiled.py`` outside
its deduplicated-row appliers (those are `ops.cuda_sparse`):

* `gather_sorted`: ``rows[k] = (w[k] *) table[sid[k]]`` over an ascending
  key stream, zero rows for keys outside [0, V); given the sort order
  `perm`, it stores each row at its place in the unsorted stream instead,
  ``rows[perm[k]] = (w[perm[k]] *) table[sid[k]]``, weights in stream
  order. The sorted form serves `tiled_gather_sorted` and
  `tiled_gather_sorted_weighted`; the perm form serves `tiled_gather` and
  both lookups, `tiled_embedding_lookup` and `fused_lookup_combine`.
* `sgd_stream`, `adagrad_stream`, `adam_stream`: the row-wise optimizers
  on a raw gradient stream in its sorted order, each segment summed in
  registers and applied once (`tiled_sgd`, `tiled_adagrad`, `tiled_adam`;
  the lookups' backward is `sgd_stream` at lr -1 over a zero table). Their
  walk is `cuda_sparse.segment_sum_sorted`'s (``csrc/segment_walk.cuh``):
  one call is three CUDA launches (a memset of the worklist count, the
  short-segment pass, the long-segment pass) and counts 1.

The TPU kernels walk table tiles against id chunks with one-hot matmuls;
these compute the same functions row by row (see the source). Sorting is
``torch.sort(stable=True)``, as XLA's sort stays outside the Pallas kernels.
The JAX package permutes the weights into sorted order and unpermutes the
gathered rows (``rows[inv]``) in XLA around its kernel; here the perm form
of `gather_sorted` does both in its one pass, so no lookup reads an inverse
permutation. The hotness sum stays in PyTorch, as it stays in XLA there.

Each wrapper checks device, dtype, shape and contiguity, takes its plain
PyTorch version (``*_plain``, beside it) only for CPU tensors, and on CUDA
tensors launches the kernel on the current stream or raises. ``launches``
counts kernel launches per kernel name. The plain versions round each
operation on its own, as the kernels do, and the stream updates' plain
versions sum each segment on the CPU in sorted order: on the card they
are the kernels' bit-exact yardstick.
"""

import ctypes
from typing import Dict, Optional

import torch

from distributed_embeddings_tpu_torch.ops import kernel_build
from distributed_embeddings_tpu_torch.ops.cuda_sparse import (
    _check_same, _checked_launch, _on_cuda, _stream, _vec4, _walk_scratch,
    adagrad_rows_plain, adam_rows_plain, bias_corrections,
    segment_sum_sorted_plain, sgd_rows_plain)
from distributed_embeddings_tpu_torch.ops.embedding_ops import (
    canonical_keys, inverse_permutation, segment_bounds, segment_keys,
    segment_starts)

__all__ = ["gather_sorted", "sgd_stream", "adagrad_stream", "adam_stream",
           "gather_sorted_plain", "sgd_stream_plain", "adagrad_stream_plain",
           "adam_stream_plain", "tiled_gather_sorted",
           "tiled_gather_sorted_weighted", "tiled_gather",
           "tiled_embedding_lookup", "fused_lookup_combine", "tiled_sgd",
           "tiled_adagrad", "tiled_adam", "launches"]

_KERNEL = "sorted_stream"

# kernel launches made by each wrapper on CUDA tensors
launches: Dict[str, int] = {"gather_sorted": 0, "sgd_stream": 0,
                            "adagrad_stream": 0, "adam_stream": 0}

_P, _I64, _F, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
# argument types per C symbol stem (the stream pointer comes last)
_ARGTYPES = {
    "gather_sorted": [_P, _I64, _I64, _P, _P, _P, _I64, _P, _I, _P],
    "sgd_stream": [_P, _I64, _I64, _P, _P, _P, _P, _I64, _F, _I, _P, _I, _P],
    "adagrad_stream": [_P, _P, _I64, _I64, _P, _P, _P, _P, _I64, _F, _F, _I,
                       _P, _I, _P],
    "adam_stream": [_P, _P, _P, _I64, _I64, _P, _P, _P, _P, _I64, _F, _F, _F,
                    _F, _F, _F, _F, _F, _I, _P, _I, _P],
}
_KEY_SUFFIX = {torch.int32: "i32", torch.int64: "i64"}


def _kernel_fn(stem: str, key_dtype: torch.dtype):
    lib = kernel_build.load(_KERNEL)
    fn = getattr(lib, f"{stem}_f32_{_KEY_SUFFIX[key_dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[stem]
        fn.restype = ctypes.c_int
    return fn


def _check_table(what, table, states=()):
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"{what}: table must be float32 [V, W], got "
                        f"{table.dtype} {tuple(table.shape)}")
    for st in states:
        if st.shape != table.shape or st.dtype != torch.float32:
            raise ValueError(f"{what}: state must be float32 "
                             f"{tuple(table.shape)}, got {st.dtype} "
                             f"{tuple(st.shape)}")


def _check_keys(what, sid):
    if sid.dim() != 1 or sid.dtype not in _KEY_SUFFIX:
        raise TypeError(f"{what}: sid must be int32/int64 [N], got "
                        f"{sid.dtype} {tuple(sid.shape)}")


# ----------------------------------------------------------------- gather
def gather_sorted_plain(table: torch.Tensor, sid: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `gather_sorted`: ``index_select``, one multiply
    (by the weights taken at `perm`), zeros where the key is outside
    [0, V), then, with `perm`, ``index_copy_`` of each row to its place
    in the stream."""
    vocab = table.shape[0]
    valid = (sid >= 0) & (sid < vocab)
    rows = table.index_select(0, sid.clamp(0, vocab - 1))
    if weights is not None:
        if perm is not None:
            weights = weights.index_select(0, perm)
        rows = rows * weights[:, None]
    rows = torch.where(valid[:, None], rows,
                       torch.zeros((), device=rows.device))
    if perm is None:
        return rows
    return torch.empty_like(rows).index_copy_(0, perm, rows)


def gather_sorted(table: torch.Tensor, sid: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``rows[k] = w[k] * table[sid[k]]`` (weights None: ``table[sid[k]]``)
    for keys sid [N] int32/int64; keys outside [0, V) give zero rows,
    whatever the weight. table [V, W] float32, weights [N] float32 ->
    rows [N, W] float32. With `perm` ([N] int64, the stream position of
    each sorted key, as `torch.sort` returns it; it must be a permutation
    of 0..N-1, which is not checked), weights and rows are in stream
    order: ``rows[perm[k]] = w[perm[k]] * table[sid[k]]``. (The kernel
    reads any key order; the callers pass ascending keys, as the TPU kernel
    requires.)"""
    _check_table("gather_sorted", table)
    _check_keys("gather_sorted", sid)
    if table.shape[0] == 0:
        raise ValueError("gather_sorted: table has no rows")
    tensors = [sid]
    if weights is not None:
        if weights.dtype != torch.float32 or weights.shape != sid.shape:
            raise ValueError(f"gather_sorted: weights must be float32 "
                             f"{tuple(sid.shape)}, got {weights.dtype} "
                             f"{tuple(weights.shape)}")
        tensors.append(weights)
    if perm is not None:
        if perm.dtype != torch.int64 or perm.shape != sid.shape:
            raise ValueError(f"gather_sorted: perm must be int64 "
                             f"{tuple(sid.shape)}, got {perm.dtype} "
                             f"{tuple(perm.shape)}")
        tensors.append(perm)
    _check_same("gather_sorted", table, *tensors)
    if not _on_cuda("gather_sorted", table):
        return gather_sorted_plain(table, sid, weights, perm)
    fn = _kernel_fn("gather_sorted", sid.dtype)
    vocab, width = table.shape
    n = sid.shape[0]
    out = torch.empty((n, width), dtype=torch.float32, device=table.device)
    if n == 0 or width == 0:
        return out
    _checked_launch(launches, "gather_sorted", fn(
        table.data_ptr(), vocab, width, sid.data_ptr(),
        None if weights is None else weights.data_ptr(),
        None if perm is None else perm.data_ptr(), n, out.data_ptr(),
        int(_vec4(width, table, out)), _stream(table)))
    return out


# ------------------------------------------------------- stream updates
def _stream_rep(sid, vocab):
    """The `rep` the deduplicated-row kernels take for this sorted stream:
    each segment slot's key, fillers outside [0, V) past the last."""
    _, seg = segment_bounds(segment_starts(sid))
    return segment_keys(sid, seg, vocab)


def _ordered_segment_sums(contribs, perm, starts):
    """`segment_sum_sorted_plain`, computed on the CPU, where `index_add_`
    adds in ascending sorted position as the kernels do (on the card it
    adds with atomics, in no fixed order), returned on the inputs'
    device."""
    return segment_sum_sorted_plain(contribs.cpu(), perm.cpu(),
                                    starts.cpu()).to(contribs.device)


def sgd_stream_plain(table, contribs, sid, perm, starts, lr):
    """Plain version of `sgd_stream`: the segment sums in sorted order,
    then `sgd_rows`'s plain version."""
    sums = _ordered_segment_sums(contribs, perm, starts)
    return sgd_rows_plain(table, _stream_rep(sid, table.shape[0]),
                          sums, lr)


def adagrad_stream_plain(table, acc, contribs, sid, perm, starts, lr, eps):
    """Plain version of `adagrad_stream`."""
    sums = _ordered_segment_sums(contribs, perm, starts)
    return adagrad_rows_plain(table, acc,
                              _stream_rep(sid, table.shape[0]), sums,
                              lr, eps)


def adam_stream_plain(table, mu, nu, contribs, sid, perm, starts, lr, b1, b2,
                      eps, c1, c2):
    """Plain version of `adam_stream` (lazy adam: every valid row moves)."""
    sums = _ordered_segment_sums(contribs, perm, starts)
    return adam_rows_plain(table, mu, nu,
                           _stream_rep(sid, table.shape[0]), sums,
                           lr, b1, b2, eps, c1, c2)


def _check_stream(what, table, states, contribs, sid, perm, starts):
    _check_table(what, table, states)
    _check_keys(what, sid)
    n = sid.shape[0]
    if (contribs.dtype != torch.float32
            or tuple(contribs.shape) != (n, table.shape[1])):
        raise ValueError(f"{what}: contribs must be float32 "
                         f"[{n}, {table.shape[1]}], got {contribs.dtype} "
                         f"{tuple(contribs.shape)}")
    if (perm.dtype != torch.int64 or starts.dtype != torch.int64
            or tuple(perm.shape) != (n,)
            or tuple(starts.shape) != (n + 1,)):
        raise ValueError(f"{what}: perm must be int64 [{n}] and starts "
                         f"int64 [{n + 1}], got {perm.dtype} "
                         f"{tuple(perm.shape)} and {starts.dtype} "
                         f"{tuple(starts.shape)}")
    _check_same(what, table, *states, contribs, sid, perm, starts)


def sgd_stream(table: torch.Tensor, contribs: torch.Tensor,
               sid: torch.Tensor, perm: torch.Tensor, starts: torch.Tensor,
               lr: float) -> torch.Tensor:
    """``table[r] += (-lr) * s`` in place, per segment of the sorted stream
    (sid [N] ascending keys, perm [N] int64 its stable sort order, starts
    [N+1] int64 its segment starts from `segment_bounds`): s is the sum of
    the segment's ``contribs[perm[j]]`` rows, j ascending, r its key;
    keys outside [0, V) skipped. Returns table."""
    _check_stream("sgd_stream", table, (), contribs, sid, perm, starts)
    if not _on_cuda("sgd_stream", table):
        return sgd_stream_plain(table, contribs, sid, perm, starts, lr)
    fn = _kernel_fn("sgd_stream", sid.dtype)
    vocab, width = table.shape
    if sid.shape[0] and width:
        scratch, workers = _walk_scratch(_KERNEL, sid.shape[0],
                                         table.device)
        _checked_launch(launches, "sgd_stream", fn(
            table.data_ptr(), vocab, width, contribs.data_ptr(),
            sid.data_ptr(), perm.data_ptr(), starts.data_ptr(), sid.shape[0],
            -float(lr), int(_vec4(width, table, contribs)),
            scratch.data_ptr(), workers, _stream(table)))
    return table


def adagrad_stream(table: torch.Tensor, acc: torch.Tensor,
                   contribs: torch.Tensor, sid: torch.Tensor,
                   perm: torch.Tensor, starts: torch.Tensor, lr: float,
                   eps: float):
    """``acc[r] += s*s; table[r] += ((-lr)*s) * rsqrt(acc[r] + eps)`` in
    place per segment (see `sgd_stream`). Returns (table, acc)."""
    _check_stream("adagrad_stream", table, (acc,), contribs, sid, perm,
                  starts)
    if not _on_cuda("adagrad_stream", table):
        return adagrad_stream_plain(table, acc, contribs, sid, perm, starts,
                                    lr, eps)
    fn = _kernel_fn("adagrad_stream", sid.dtype)
    vocab, width = table.shape
    if sid.shape[0] and width:
        scratch, workers = _walk_scratch(_KERNEL, sid.shape[0],
                                         table.device)
        _checked_launch(launches, "adagrad_stream", fn(
            table.data_ptr(), acc.data_ptr(), vocab, width,
            contribs.data_ptr(), sid.data_ptr(), perm.data_ptr(),
            starts.data_ptr(), sid.shape[0], -float(lr), float(eps),
            int(_vec4(width, table, acc, contribs)), scratch.data_ptr(),
            workers, _stream(table)))
    return table, acc


def adam_stream(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                contribs: torch.Tensor, sid: torch.Tensor, perm: torch.Tensor,
                starts: torch.Tensor, lr: float, b1: float, b2: float,
                eps: float, c1: float, c2: float):
    """Lazy adam in place per segment (see `sgd_stream`): ``mu = b1*mu +
    (1-b1)*s``, ``nu = b2*nu + (1-b2)*(s*s)``, ``table += ((-lr)*(mu/c1)) /
    (sqrt(nu/c2) + eps)`` on every row with a valid key in the stream.
    Returns (table, mu, nu)."""
    _check_stream("adam_stream", table, (mu, nu), contribs, sid, perm,
                  starts)
    if not _on_cuda("adam_stream", table):
        return adam_stream_plain(table, mu, nu, contribs, sid, perm, starts,
                                 lr, b1, b2, eps, c1, c2)
    fn = _kernel_fn("adam_stream", sid.dtype)
    vocab, width = table.shape
    if sid.shape[0] and width:
        scratch, workers = _walk_scratch(_KERNEL, sid.shape[0],
                                         table.device)
        _checked_launch(launches, "adam_stream", fn(
            table.data_ptr(), mu.data_ptr(), nu.data_ptr(), vocab, width,
            contribs.data_ptr(), sid.data_ptr(), perm.data_ptr(),
            starts.data_ptr(), sid.shape[0], -float(lr), float(b1),
            1 - float(b1), float(b2), 1 - float(b2), float(c1), float(c2),
            float(eps), int(_vec4(width, table, mu, nu, contribs)),
            scratch.data_ptr(), workers, _stream(table)))
    return table, mu, nu


# --------------------------------------------------- sorting and gathers
def _sort_ids(ids: torch.Tensor, vocab: int):
    """Sort ids ascending under the canonical key (ids outside [0, V) key
    to V and land at the end); returns (sid, perm). Unlike the JAX
    package's, it permutes no contribution rows: the stream kernels read
    them through perm."""
    return torch.sort(canonical_keys(ids.reshape(-1), vocab), stable=True)


def _sort_with_inv(flat_ids: torch.Tensor, vocab: int, presorted):
    """(sid, perm, inv) of a flat id stream: the caller's triple as given,
    or one fresh sort plus its inverse permutation (the JAX package's
    `_sort_with_inv`; the port's lookups take `_sort_pair`)."""
    if presorted is not None:
        return presorted
    sid, perm = _sort_ids(flat_ids, vocab)
    return sid, perm, inverse_permutation(perm)


def _sort_pair(flat_ids: torch.Tensor, vocab: int, presorted):
    """(sid, perm) of a flat id stream: the first two of the caller's
    (sid, perm) or (sid, perm, inv), or one fresh sort."""
    if presorted is not None:
        return presorted[0], presorted[1]
    return _sort_ids(flat_ids, vocab)


def tiled_gather_sorted(table: torch.Tensor, sid: torch.Tensor
                        ) -> torch.Tensor:
    """rows[k] = table[sid[k]] for an ascending key stream; keys outside
    [0, V) give zero rows (unlike a clamping gather)."""
    return gather_sorted(table, sid)


def tiled_gather_sorted_weighted(table: torch.Tensor, sid: torch.Tensor,
                                 w_sorted: torch.Tensor) -> torch.Tensor:
    """rows[k] = w_sorted[k] * table[sid[k]] for an ascending key stream;
    keys outside [0, V) give zero rows whatever the weight."""
    return gather_sorted(table, sid, w_sorted.to(torch.float32).contiguous())


def tiled_gather(table: torch.Tensor, ids: torch.Tensor,
                 presorted=None) -> torch.Tensor:
    """rows[k] = table[ids[k]] for ids in any order (ids outside [0, V)
    give zero rows): one sort, then `gather_sorted` storing each row at
    its place in the stream. `presorted` reuses a prior (sid, perm) or
    (sid, perm, inv) of this id stream (inv is not read)."""
    if ids.shape[0] == 0:
        return torch.zeros((0, table.shape[1]), dtype=torch.float32,
                           device=table.device)
    sid, perm = _sort_pair(ids, table.shape[0], presorted)
    return gather_sorted(table, sid, perm=perm)


# ----------------------------------------------------------------- lookups
def _combine_prologue(params, ids, weights, combiner, presorted):
    """The lookups' shared prologue: check the combiner, default the
    weights to ones (mean divides them by their row sum, at least 1), clip
    ids into [0, V-1], and cap a presorted pair's or triple's keys at V-1
    (returning the pair). So positive out-of-range ids read row V-1 on
    both routes, while negative ids read row 0 when sorted here but row
    V-1 through a presorted stream (their canonical key is V), as in the
    JAX package."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"Unsupported combiner {combiner}")
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.float32,
                             device=ids.device)
    weights = weights.to(torch.float32)
    if combiner == "mean":
        weights = weights / weights.sum(dim=1, keepdim=True).clamp_min(1.0)
    vocab = params.shape[0]
    ids = ids.clamp(0, vocab - 1)
    if presorted is not None:
        presorted = (presorted[0].clamp(max=vocab - 1), presorted[1])
    return ids, weights, presorted


def _sorted_stream(ids: torch.Tensor, vocab: int, presorted):
    """(sid, perm, starts) of a raw update stream: a fresh sort, or the
    caller's (sid, perm) of this stream."""
    sid, perm = _sort_pair(ids, vocab, presorted)
    starts, _ = segment_bounds(segment_starts(sid))
    return sid, perm, starts


def _tiled_lookup_bwd(ctx, g):
    """The backward of both lookups (the JAX package's `_tiled_lookup_bwd`):
    the dense table gradient by `sgd_stream` at lr = -1 over a zero table
    on the forward's sort, and dweights from the unweighted gather."""
    params, ids, weights, sid, perm = ctx.saved_tensors
    flat_ids = ids.reshape(-1)
    dtable = dweights = None
    if ctx.needs_input_grad[0]:
        contrib = (weights[..., None] * g[:, None, :].to(torch.float32)
                   ).reshape(-1, g.shape[-1])
        dtable = tiled_sgd(torch.zeros(params.shape, dtype=torch.float32,
                                       device=params.device),
                           flat_ids, contrib.contiguous(), -1.0,
                           presorted=(sid, perm))
    if ctx.needs_input_grad[2]:
        rows = tiled_gather(params, flat_ids, presorted=(sid, perm))
        dweights = torch.einsum("bkw,bw->bk",
                                rows.reshape(ids.shape + (-1,)), g)
    return dtable, None, dweights, None


class _TiledLookup(torch.autograd.Function):
    """Unweighted gather in stream order, then ``einsum`` with the
    weights."""

    @staticmethod
    def forward(ctx, params, ids, weights, presorted):
        b, k = ids.shape
        sid, perm = _sort_pair(ids.reshape(-1), params.shape[0], presorted)
        ctx.save_for_backward(params, ids, weights, sid, perm)
        rows = tiled_gather(params, ids.reshape(-1),
                            presorted=(sid, perm)).reshape(b, k, -1)
        return torch.einsum("bk,bkw->bw", weights, rows)

    backward = staticmethod(_tiled_lookup_bwd)


class _FusedLookup(torch.autograd.Function):
    """Weighted gather in stream order (the weights applied inside
    `gather_sorted`), then a plain hotness sum."""

    @staticmethod
    def forward(ctx, params, ids, weights, presorted):
        b, k = ids.shape
        sid, perm = _sort_pair(ids.reshape(-1), params.shape[0], presorted)
        ctx.save_for_backward(params, ids, weights, sid, perm)
        rows = gather_sorted(params, sid, weights.reshape(-1), perm=perm)
        return rows.reshape(b, k, -1).sum(dim=1)

    backward = staticmethod(_tiled_lookup_bwd)


def tiled_embedding_lookup(params: torch.Tensor, ids: torch.Tensor,
                           weights: Optional[torch.Tensor] = None,
                           combiner: str = "sum",
                           presorted=None) -> torch.Tensor:
    """Padded multi-hot lookup over the sorted gather: [V, W] table, [B, K]
    ids -> [B, W]. Weights [B, K] carry 0.0 in padded slots (None = all
    ones); mean pre-normalizes them; ids clip into [0, V-1] (see
    `_combine_prologue`). `presorted`: the canonical (sid, perm) or
    (sid, perm, inv) of the flattened ids, e.g. from the tapped forward's
    `GroupSort`, which folds the lookup's own sort away. Differentiable in
    params and weights."""
    ids, weights, presorted = _combine_prologue(params, ids, weights,
                                                combiner, presorted)
    return _TiledLookup.apply(params.contiguous(), ids.contiguous(),
                              weights.contiguous(), presorted)


def fused_lookup_combine(params: torch.Tensor, ids: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         combiner: str = "sum",
                         presorted=None) -> torch.Tensor:
    """The same function as `tiled_embedding_lookup`, with the weights
    applied inside the gather (`gather_sorted` weighted, in stream
    order), then a plain hotness sum. Differentiable in params and
    weights; same backward."""
    ids, weights, presorted = _combine_prologue(params, ids, weights,
                                                combiner, presorted)
    return _FusedLookup.apply(params.contiguous(), ids.contiguous(),
                              weights.contiguous(), presorted)


# ------------------------------------------------- raw-stream optimizers
def tiled_sgd(table: torch.Tensor, ids: torch.Tensor, contribs: torch.Tensor,
              lr, presorted=None) -> torch.Tensor:
    """``table[ids] -= lr * contribs`` in place, duplicates summed first
    (in sorted order); ids outside [0, V) dropped. `presorted` may carry
    this stream's (sid, perm). Returns table."""
    if ids.shape[0] == 0:
        return table
    sid, perm, starts = _sorted_stream(ids, table.shape[0], presorted)
    return sgd_stream(table, contribs.contiguous(), sid, perm, starts,
                      float(lr))


def tiled_adagrad(table: torch.Tensor, accum: torch.Tensor,
                  ids: torch.Tensor, contribs: torch.Tensor, lr,
                  eps: float = 1e-10, presorted=None):
    """Row-wise adagrad on a raw stream, in place: per touched row,
    ``acc += total^2; table -= lr * total * rsqrt(acc + eps)``. Returns
    (table, accum)."""
    if ids.shape[0] == 0:
        return table, accum
    sid, perm, starts = _sorted_stream(ids, table.shape[0], presorted)
    return adagrad_stream(table, accum, contribs.contiguous(), sid, perm,
                          starts, float(lr), eps)


def tiled_adam(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
               count: int, ids: torch.Tensor, contribs: torch.Tensor, lr,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               presorted=None):
    """Lazy row-wise adam on a raw stream, in place (moments decay only on
    rows the stream touches, bias corrections by the global step count).
    `count` (a host int) is the step count before this step and rises by
    one even for an empty stream. Returns (table, mu, nu, count + 1)."""
    count = int(count) + 1
    if ids.shape[0] == 0:
        return table, mu, nu, count
    c1, c2 = bias_corrections(count, b1, b2)
    sid, perm, starts = _sorted_stream(ids, table.shape[0], presorted)
    adam_stream(table, mu, nu, contribs.contiguous(), sid, perm, starts,
                float(lr), b1, b2, eps, c1, c2)
    return table, mu, nu, count
