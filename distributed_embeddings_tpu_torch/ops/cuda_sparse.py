"""Sparse-update kernels: duplicate aggregation and row-wise optimizers.

Counterparts, in ``csrc/sparse_apply.cu``, of the JAX package's deduped-row
update path (``distributed_embeddings_tpu/ops/sparse_update.py``):

* `segment_sum_sorted`: the segment sum inside `dedup_sum`,
  ``sums[s] = sum_{j in [starts[s], starts[s+1])} contribs[perm[j]]`` with j
  ascending (XLA's ``segment_sum`` there; no TPU kernel). Hand-written so the
  sum order is fixed: CUDA ``index_add_`` adds with atomics.
* `sgd_rows`, `adagrad_rows`, `adam_rows`: one read-modify-write per unique
  row of ``rep``, in place; rows with ``rep < 0`` or ``rep >= V`` are skipped.
  They replace ``pallas_tiled._sgd_kernel`` / ``_adagrad_kernel`` /
  ``_adam_kernel`` (the ``tiled_*_rows`` entry points) and
  ``pallas_scatter._scatter_kernel`` (`sgd_rows` at lr -1) /
  ``_adagrad_kernel``.

Each wrapper checks device, dtype, shape and contiguity, takes its plain
PyTorch version (``*_plain``, beside it) only for CPU tensors, and on CUDA
tensors launches the kernel on the current stream or raises. ``launches``
counts kernel launches per kernel name. The plain versions round every
product and sum on its own, as the kernels do, so on the card they are the
kernels' bit-exact yardstick.
"""

import ctypes
from typing import Dict, Tuple

import torch

from distributed_embeddings_tpu_torch.ops import kernel_build
from distributed_embeddings_tpu_torch.utils.device import device_scalar

__all__ = ["segment_sum_sorted", "sgd_rows", "adagrad_rows", "adam_rows",
           "segment_sum_sorted_plain", "sgd_rows_plain", "adagrad_rows_plain",
           "adam_rows_plain", "launches"]

_KERNEL = "sparse_apply"

# kernel launches made by each wrapper on CUDA tensors
launches: Dict[str, int] = {"segment_sum_sorted": 0, "sgd_rows": 0,
                            "adagrad_rows": 0, "adam_rows": 0}

_P, _I64, _F, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
# argument types per C symbol stem (the stream pointer comes last)
_ARGTYPES = {
    "segment_sum_sorted": [_P, _I64, _P, _P, _I64, _P, _I, _P],
    "sgd_rows": [_P, _I64, _I64, _P, _P, _I64, _F, _I, _P],
    "adagrad_rows": [_P, _P, _I64, _I64, _P, _P, _I64, _F, _F, _I, _P],
    "adam_rows": [_P, _P, _P, _I64, _I64, _P, _P, _I64, _F, _F, _F, _F, _F,
                  _F, _F, _F, _I, _P],
}
_ID_SUFFIX = {torch.int32: "i32", torch.int64: "i64"}


def _kernel_fn(stem: str, symbol: str):
    fn = getattr(kernel_build.load(_KERNEL), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[stem]
        fn.restype = ctypes.c_int
    return fn


def _checked(stem: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{stem} kernel launch failed: CUDA error {err}")
    launches[stem] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _vec4(width: int, *tensors: torch.Tensor) -> bool:
    return width % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _on_cuda(what: str, ref: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA; else raise."""
    if ref.device.type == "cpu":
        return False
    if ref.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {ref.device}")
    return True


def _check_same(what: str, ref: torch.Tensor, *tensors: torch.Tensor):
    for t in (ref, *tensors):
        if t.device != ref.device:
            raise ValueError(f"{what}: tensors on {t.device} and {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")


# ------------------------------------------------------------ segment sum
def _segment_ids(starts: torch.Tensor, n: int) -> torch.Tensor:
    """Segment index of each sorted position j: the last s with
    starts[s] <= j (starts is non-decreasing; unused slots hold n)."""
    pos = torch.arange(n, device=starts.device, dtype=starts.dtype)
    return torch.searchsorted(starts, pos, right=True) - 1


def segment_sum_sorted_plain(contribs: torch.Tensor, perm: torch.Tensor,
                             starts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of ``contribs[perm]`` by
    segment index. On the CPU it adds in ascending position order, as the
    kernel does."""
    n, width = contribs.shape
    out = torch.zeros((n, width), dtype=torch.float32, device=contribs.device)
    if n:
        out.index_add_(0, _segment_ids(starts, n), contribs[perm])
    return out


def segment_sum_sorted(contribs: torch.Tensor, perm: torch.Tensor,
                       starts: torch.Tensor) -> torch.Tensor:
    """contribs [N, W] float32, perm [N] int64 (the stable sort order of
    the rows' keys), starts [N+1] int64 (segment s is sorted positions
    [starts[s], starts[s+1]); slots without a segment hold N) -> sums
    [N, W], zero in slots without a segment."""
    if contribs.dim() != 2 or contribs.dtype != torch.float32:
        raise TypeError(f"contribs must be float32 [N, W], got "
                        f"{contribs.dtype} {tuple(contribs.shape)}")
    n, width = contribs.shape
    if (perm.dtype != torch.int64 or starts.dtype != torch.int64
            or tuple(perm.shape) != (n,) or tuple(starts.shape) != (n + 1,)):
        raise ValueError(f"perm must be int64 [{n}] and starts int64 "
                         f"[{n + 1}], got {perm.dtype} {tuple(perm.shape)} "
                         f"and {starts.dtype} {tuple(starts.shape)}")
    _check_same("segment_sum_sorted", contribs, perm, starts)
    if not _on_cuda("segment_sum_sorted", contribs):
        return segment_sum_sorted_plain(contribs, perm, starts)
    fn = _kernel_fn("segment_sum_sorted", "segment_sum_sorted_f32")
    sums = torch.empty((n, width), dtype=torch.float32, device=contribs.device)
    if n == 0 or width == 0:
        return sums
    _checked("segment_sum_sorted", fn(
        contribs.data_ptr(), width, perm.data_ptr(), starts.data_ptr(), n,
        sums.data_ptr(), int(_vec4(width, contribs, sums)),
        _stream(contribs)))
    return sums


# ------------------------------------------------------------ row updates
def _valid_rows(rep: torch.Tensor, vocab: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(slot positions, table rows) of the rep entries inside [0, V)."""
    slots = ((rep >= 0) & (rep < vocab)).nonzero().squeeze(1)
    return slots, rep.index_select(0, slots).long()


def sgd_rows_plain(table, rep, sums, lr):
    """Plain version of `sgd_rows`: gather the valid rows,
    ``t + (-lr) * s``, ``index_copy_`` back."""
    slots, rows = _valid_rows(rep, table.shape[0])
    s = sums.index_select(0, slots)
    table.index_copy_(0, rows, table.index_select(0, rows) + s * (-lr))
    return table


def adagrad_rows_plain(table, acc, rep, sums, lr, eps):
    """Plain version of `adagrad_rows`, one torch op per product."""
    slots, rows = _valid_rows(rep, table.shape[0])
    s = sums.index_select(0, slots)
    a = acc.index_select(0, rows) + s * s
    d = (s * (-lr)) * torch.rsqrt(a + eps)
    acc.index_copy_(0, rows, a)
    table.index_copy_(0, rows, table.index_select(0, rows) + d)
    return table, acc


def adam_rows_plain(table, mu, nu, rep, sums, lr, b1, b2, eps, c1, c2):
    """Plain version of `adam_rows` (lazy adam: every valid row moves)."""
    slots, rows = _valid_rows(rep, table.shape[0])
    s = sums.index_select(0, slots)
    m = mu.index_select(0, rows) * b1 + s * (1 - b1)
    v = nu.index_select(0, rows) * b2 + (s * s) * (1 - b2)
    num = (m / device_scalar(c1, m)) * (-lr)
    den = torch.sqrt(v / device_scalar(c2, v)) + eps
    mu.index_copy_(0, rows, m)
    nu.index_copy_(0, rows, v)
    table.index_copy_(0, rows, table.index_select(0, rows) + num / den)
    return table, mu, nu


def _check_rows(what, table, states, rep, sums):
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"{what}: table must be float32 [V, W], got "
                        f"{table.dtype} {tuple(table.shape)}")
    for st in states:
        if st.shape != table.shape or st.dtype != torch.float32:
            raise ValueError(f"{what}: state must be float32 "
                             f"{tuple(table.shape)}, got {st.dtype} "
                             f"{tuple(st.shape)}")
    if rep.dim() != 1 or rep.dtype not in _ID_SUFFIX:
        raise TypeError(f"{what}: rep must be int32/int64 [N], got "
                        f"{rep.dtype} {tuple(rep.shape)}")
    if (sums.dtype != torch.float32
            or tuple(sums.shape) != (rep.shape[0], table.shape[1])):
        raise ValueError(f"{what}: sums must be float32 "
                         f"[{rep.shape[0]}, {table.shape[1]}], got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    _check_same(what, table, *states, rep, sums)


def sgd_rows(table: torch.Tensor, rep: torch.Tensor, sums: torch.Tensor,
             lr: float) -> torch.Tensor:
    """``table[rep[s]] += (-lr) * sums[s]`` in place over unique rep; ids
    outside [0, V) skipped. Returns table."""
    _check_rows("sgd_rows", table, (), rep, sums)
    if not _on_cuda("sgd_rows", table):
        return sgd_rows_plain(table, rep, sums, lr)
    fn = _kernel_fn("sgd_rows", f"sgd_rows_f32_{_ID_SUFFIX[rep.dtype]}")
    vocab, width = table.shape
    if rep.shape[0] and width:
        _checked("sgd_rows", fn(
            table.data_ptr(), vocab, width, rep.data_ptr(), sums.data_ptr(),
            rep.shape[0], -float(lr), int(_vec4(width, table, sums)),
            _stream(table)))
    return table


def adagrad_rows(table: torch.Tensor, acc: torch.Tensor, rep: torch.Tensor,
                 sums: torch.Tensor, lr: float, eps: float):
    """``acc[r] += s*s; table[r] += ((-lr)*s) * rsqrt(acc[r] + eps)`` in
    place over unique rep; ids outside [0, V) skipped. Returns
    (table, acc)."""
    _check_rows("adagrad_rows", table, (acc,), rep, sums)
    if not _on_cuda("adagrad_rows", table):
        return adagrad_rows_plain(table, acc, rep, sums, lr, eps)
    fn = _kernel_fn("adagrad_rows",
                    f"adagrad_rows_f32_{_ID_SUFFIX[rep.dtype]}")
    vocab, width = table.shape
    if rep.shape[0] and width:
        _checked("adagrad_rows", fn(
            table.data_ptr(), acc.data_ptr(), vocab, width, rep.data_ptr(),
            sums.data_ptr(), rep.shape[0], -float(lr), float(eps),
            int(_vec4(width, table, acc, sums)), _stream(table)))
    return table, acc


def adam_rows(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              rep: torch.Tensor, sums: torch.Tensor, lr: float, b1: float,
              b2: float, eps: float, c1: float, c2: float):
    """Lazy adam over unique rep, in place: ``mu = b1*mu + (1-b1)*s``,
    ``nu = b2*nu + (1-b2)*(s*s)``, ``table += ((-lr)*(mu/c1)) /
    (sqrt(nu/c2) + eps)``; c1/c2 are the float32 bias corrections of the
    step. Returns (table, mu, nu)."""
    _check_rows("adam_rows", table, (mu, nu), rep, sums)
    if not _on_cuda("adam_rows", table):
        return adam_rows_plain(table, mu, nu, rep, sums, lr, b1, b2, eps, c1,
                               c2)
    fn = _kernel_fn("adam_rows", f"adam_rows_f32_{_ID_SUFFIX[rep.dtype]}")
    vocab, width = table.shape
    if rep.shape[0] and width:
        _checked("adam_rows", fn(
            table.data_ptr(), mu.data_ptr(), nu.data_ptr(), vocab, width,
            rep.data_ptr(), sums.data_ptr(), rep.shape[0], -float(lr),
            float(b1), 1 - float(b1), float(b2), 1 - float(b2), float(c1),
            float(c2), float(eps), int(_vec4(width, table, mu, nu, sums)),
            _stream(table)))
    return table, mu, nu
