"""Fused multi-hot embedding lookup-combine: the hand-written CUDA kernel.

Counterpart of ``distributed_embeddings_tpu/ops/pallas_lookup.py``. There,
two Pallas kernels compute one function and the choice between them follows
the TPU's tiling (`_onehot_kernel` for V <= 8192, `_dma_gather_kernel` for
lane-aligned large vocabularies). Here one CUDA kernel,
``csrc/lookup_combine.cu``, computes it for every vocab size and width:

    out[n] = sum_k w[n, k] * table[clamp(ids[n, k], 0, V - 1)]

It is memory-bound (about ``N*K*(4W + 8) + 4*N*W`` bytes for ``2*N*K*W``
flops); see the source for its design.

`lookup_combine` dispatches on the table's device: a CPU tensor takes
`lookup_combine_plain`, the plain PyTorch version the tests and
``chip_smoke.py`` hold the kernel against; a CUDA tensor launches the kernel
or raises. ``launches`` counts kernel launches, so a run can show its main
path went through the kernel.

`fused_embedding_lookup` is differentiable in the table and the weights,
like the JAX function: its backward is `_fused_bwd`'s (a dense table
gradient by scatter-add of ``w * g``, and ``dweights = einsum(rows, g)``),
which the JAX package computes in XLA, so plain PyTorch is its counterpart.
The training step does not use it: its tables take row-wise sparse updates
(`ops.sparse_update`).
"""

import ctypes
from typing import Optional

import torch

from distributed_embeddings_tpu_torch.ops import kernel_build

# kernel launches made by `lookup_combine` on CUDA tensors
launches = 0

_KERNEL = "lookup_combine"
_SYMBOLS = {torch.int32: "lookup_combine_f32_i32",
            torch.int64: "lookup_combine_f32_i64"}


def _kernel_fn(id_dtype: torch.dtype):
    lib = kernel_build.load(_KERNEL)
    fn = getattr(lib, _SYMBOLS[id_dtype])
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, p, p, i64, i64, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def lookup_combine_plain(table: torch.Tensor, ids: torch.Tensor,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version: clamp, ``index_select``, multiply, sum over k.
    table [V, W], ids [N, K], weights [N, K] or None (all ones) -> [N, W]."""
    n, k = ids.shape
    rows = table.index_select(
        0, ids.reshape(-1).clamp(0, table.shape[0] - 1)).reshape(n, k, -1)
    if weights is not None:
        rows = rows * weights.unsqueeze(-1)
    return rows.sum(dim=1)


def _check(table, ids, weights):
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"expected table [V, W] and ids [N, K], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    if ids.dtype not in _SYMBOLS:
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if table.shape[0] == 0:
        raise ValueError("table has no rows")
    tensors = [table, ids]
    if weights is not None:
        if weights.shape != ids.shape or weights.dtype != torch.float32:
            raise ValueError(
                f"weights must be float32 {tuple(ids.shape)}, got "
                f"{weights.dtype} {tuple(weights.shape)}")
        tensors.append(weights)
    for t in tensors:
        if t.device != table.device:
            raise ValueError(f"tensors on {t.device} and {table.device}")
        if not t.is_contiguous():
            raise ValueError("lookup_combine takes contiguous tensors")


def lookup_combine(table: torch.Tensor, ids: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[n] = sum_k w[n,k] * table[clamp(ids[n,k], 0, V-1)]``.

    table [V, W] float32; ids [N, K] int32/int64; weights [N, K] float32 or
    None (all ones) -> out [N, W] float32. CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream."""
    global launches
    _check(table, ids, weights)
    if table.device.type == "cpu":
        return lookup_combine_plain(table, ids, weights)
    if table.device.type != "cuda":
        raise ValueError(f"lookup_combine runs on cpu or cuda, not "
                         f"{table.device}")
    fn = _kernel_fn(ids.dtype)
    n, k = ids.shape
    vocab, width = table.shape
    out = torch.empty((n, width), dtype=torch.float32, device=table.device)
    if n == 0 or width == 0:
        return out
    vec4 = (width % 4 == 0 and table.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), vocab, width, ids.data_ptr(),
             None if weights is None else weights.data_ptr(), n, k,
             out.data_ptr(), int(vec4), stream)
    if err != 0:
        raise RuntimeError(f"lookup_combine kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


class _FusedLookup(torch.autograd.Function):
    """The gather-combine with the JAX package's `_fused_bwd` as backward.
    ids arrive clamped into [0, V-1]."""

    @staticmethod
    def forward(ctx, params, ids, weights):
        ctx.save_for_backward(params, ids, weights)
        return lookup_combine(params, ids, weights)

    @staticmethod
    def backward(ctx, g):
        params, ids, weights = ctx.saved_tensors
        flat_ids = ids.reshape(-1).long()
        dtable = dweights = None
        if ctx.needs_input_grad[0]:
            contrib = (weights[..., None] * g[:, None, :]).reshape(
                -1, g.shape[-1])
            dtable = torch.zeros_like(params).index_add_(0, flat_ids,
                                                         contrib)
        if ctx.needs_input_grad[2]:
            rows = params.index_select(0, flat_ids).reshape(
                ids.shape + (params.shape[1],))
            dweights = torch.einsum("bkw,bw->bk", rows, g)
        return dtable, None, dweights


def fused_embedding_lookup(params: torch.Tensor, ids: torch.Tensor,
                           weights: Optional[torch.Tensor] = None,
                           combiner: str = "sum") -> torch.Tensor:
    """Fused padded multi-hot lookup: [V, W] table, [B, K] ids -> [B, W].

    Same contract as the JAX package's `pallas_lookup.
    fused_embedding_lookup`: weights [B, K] carry 0.0 in padded slots (None
    = all ones); mean pre-normalizes the weights so the kernel only ever
    computes a weighted sum; ids clamp into [0, V-1]. Differentiable in
    `params` and `weights` (see `_FusedLookup`)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"Unsupported combiner {combiner}")
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.float32,
                             device=ids.device)
    if combiner == "mean":
        denom = weights.sum(dim=1, keepdim=True).clamp_min(1.0)
        weights = weights / denom
    ids = ids.clamp(0, params.shape[0] - 1)
    return _FusedLookup.apply(params.contiguous(), ids.contiguous(),
                              weights.to(torch.float32).contiguous())
