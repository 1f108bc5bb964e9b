"""Fused multi-hot embedding lookup-combine: the hand-written CUDA kernel.

Counterpart of ``distributed_embeddings_tpu/ops/pallas_lookup.py``. There,
two Pallas kernels compute one function and the choice between them follows
the TPU's tiling (`_onehot_kernel` for V <= 8192, `_dma_gather_kernel` for
lane-aligned large vocabularies). Here ``csrc/lookup_combine.cu`` computes
it for every vocab size and width:

    out[n] = sum_k w[n, k] * table[clamp(ids[n, k], 0, V - 1)]

It is memory-bound (about ``N*K*(4W + 8) + 4*N*W`` bytes for ``2*N*K*W``
flops). Two kernels share the entry points and split by hotness: one-hot
ids (K == 1) take the one-hot walk, a grid that the card holds at once in
which each thread group keeps several rows' table loads in flight; any
other K takes the multi-hot kernel, one output row a thread group, the K
terms in ascending order. Both give the same bits as
`lookup_combine_plain`; see the source for their design.

Mixed precision (the JAX package's ``compute_dtype``): the table and the
sum stay float32, and ``out_dtype`` (bfloat16 or float16) is the type the
kernel stores, rounded once. Two forms, one for each of the JAX package's
routes: the store form (the TPU kernel, then ``.astype(compute_dtype)``),
which the table-parallel groups take, and, with ``round_inputs``, the
round-first form (each row element and weight rounded to ``out_dtype``
before the float32 multiply-add: XLA's gather, cast and einsum), which the
row-sliced groups take.

`lookup_combine` dispatches on the table's device: a CPU tensor takes
`lookup_combine_plain`, the plain PyTorch version the tests and
``chip_smoke.py`` hold the kernel against; a CUDA tensor launches the kernel
or raises. ``launches`` counts the kernel's launches by form (`form_name`:
``lookup_combine`` for the float32 form), so a run can show its main path
went through the kernel.

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

# kernel launches made by `lookup_combine` on CUDA tensors, by form
launches = {"lookup_combine": 0,
            "lookup_combine_bf16": 0, "lookup_combine_bf16_round": 0,
            "lookup_combine_f16": 0, "lookup_combine_f16_round": 0}

_KERNEL = "lookup_combine"
_OUT_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16"}
_ID_NAMES = {torch.int32: "i32", torch.int64: "i64"}


def form_name(out_dtype: torch.dtype = torch.float32,
              round_inputs: bool = False) -> str:
    """The kernel form's name: ``lookup_combine``, or
    ``lookup_combine_<bf16|f16>[_round]`` for a mixed-precision store."""
    if out_dtype == torch.float32:
        return _KERNEL
    return (f"{_KERNEL}_{_OUT_NAMES[out_dtype]}"
            + ("_round" if round_inputs else ""))


def _kernel_fn(id_dtype: torch.dtype, out_dtype: torch.dtype,
               round_inputs: bool):
    lib = kernel_build.load(_KERNEL)
    fn = getattr(lib, f"{_KERNEL}_{_OUT_NAMES[out_dtype]}"
                      f"{'_round' if round_inputs else ''}_"
                      f"{_ID_NAMES[id_dtype]}")
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, p, p, i64, i64, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def lookup_combine_plain(table: torch.Tensor, ids: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         out_dtype: torch.dtype = torch.float32,
                         round_inputs: bool = False) -> torch.Tensor:
    """Plain PyTorch version: clamp, ``index_select``, then for k in order
    a float32 multiply and a float32 add (the kernel's order, so the two
    agree bit for bit at any K), then one rounding to `out_dtype`; with
    `round_inputs`, the rows and weights are rounded to `out_dtype` first.
    table [V, W], ids [N, K], weights [N, K] or None (all ones) -> [N, W]."""
    n, k = ids.shape
    ids = ids.clamp(0, table.shape[0] - 1)
    if round_inputs and weights is not None:
        weights = weights.to(out_dtype).float()
    acc = torch.zeros((n, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(k):
        rows = table.index_select(0, ids[:, j])
        if round_inputs:
            rows = rows.to(out_dtype).float()
        if weights is not None:
            rows = rows * weights[:, j, None]
        acc = acc + rows
    return acc.to(out_dtype)


def _check(table, ids, weights, out_dtype):
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"expected table [V, W] and ids [N, K], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    if ids.dtype not in _ID_NAMES:
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if out_dtype not in _OUT_NAMES:
        raise TypeError(f"out_dtype must be float32, bfloat16 or float16, "
                        f"got {out_dtype}")
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
                   weights: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.float32,
                   round_inputs: bool = False) -> torch.Tensor:
    """``out[n] = sum_k w[n,k] * table[clamp(ids[n,k], 0, V-1)]``.

    table [V, W] float32; ids [N, K] int32/int64; weights [N, K] float32 or
    None (all ones) -> out [N, W] of `out_dtype` (float32, bfloat16 or
    float16): the float32 sum rounded once; with `round_inputs` (a
    mixed-precision `out_dtype` only), the round-first form, whose rows and
    weights are rounded to `out_dtype` before the float32 multiply-add. CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream."""
    _check(table, ids, weights, out_dtype)
    round_inputs = bool(round_inputs) and out_dtype != torch.float32
    if table.device.type == "cpu":
        return lookup_combine_plain(table, ids, weights, out_dtype,
                                    round_inputs)
    if table.device.type != "cuda":
        raise ValueError(f"lookup_combine runs on cpu or cuda, not "
                         f"{table.device}")
    fn = _kernel_fn(ids.dtype, out_dtype, round_inputs)
    n, k = ids.shape
    vocab, width = table.shape
    out = torch.empty((n, width), dtype=out_dtype, device=table.device)
    if n == 0 or width == 0:
        return out
    # 4 outputs a store: 16 bytes of float32, 8 of bfloat16 or float16
    vec4 = (width % 4 == 0 and table.data_ptr() % 16 == 0
            and out.data_ptr() % (4 * out.element_size()) == 0)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), vocab, width, ids.data_ptr(),
             None if weights is None else weights.data_ptr(), n, k,
             out.data_ptr(), int(vec4), stream)
    if err != 0:
        raise RuntimeError(f"lookup_combine kernel launch failed: CUDA error "
                           f"{err}")
    launches[form_name(out_dtype, round_inputs)] += 1
    return out


class _FusedLookup(torch.autograd.Function):
    """The gather-combine with the JAX package's `_fused_bwd` as backward.
    ids arrive clamped into [0, V-1]. A mixed-precision output's gradient
    is upcast to float32 first (the transpose of the convert after the
    TPU kernel); in the round-first form each row's and weight's
    contribution is rounded to the output type, as the transpose of an
    einsum of rounded operands rounds it."""

    @staticmethod
    def forward(ctx, params, ids, weights, out_dtype, round_inputs):
        ctx.save_for_backward(params, ids, weights)
        ctx.out_dtype, ctx.round_inputs = out_dtype, round_inputs
        return lookup_combine(params, ids, weights, out_dtype, round_inputs)

    @staticmethod
    def backward(ctx, g):
        params, ids, weights = ctx.saved_tensors
        g = g.float()
        flat_ids = ids.reshape(-1).long()
        dtable = dweights = None

        def rounded(x):
            return x.to(ctx.out_dtype).float() if ctx.round_inputs else x
        if ctx.needs_input_grad[0]:
            contrib = rounded(rounded(weights)[..., None]
                              * g[:, None, :]).reshape(-1, g.shape[-1])
            dtable = torch.zeros_like(params).index_add_(0, flat_ids,
                                                         contrib)
        if ctx.needs_input_grad[2]:
            rows = rounded(params.index_select(0, flat_ids)).reshape(
                ids.shape + (params.shape[1],))
            dweights = rounded(torch.einsum("bkw,bw->bk", rows, g))
        return dtable, None, dweights, None, None


def fused_embedding_lookup(params: torch.Tensor, ids: torch.Tensor,
                           weights: Optional[torch.Tensor] = None,
                           combiner: str = "sum",
                           out_dtype: torch.dtype = torch.float32,
                           round_inputs: bool = False) -> torch.Tensor:
    """Fused padded multi-hot lookup: [V, W] table, [B, K] ids -> [B, W].

    Same contract as the JAX package's `pallas_lookup.
    fused_embedding_lookup`: weights [B, K] carry 0.0 in padded slots (None
    = all ones); mean pre-normalizes the weights so the kernel only ever
    computes a weighted sum; ids clamp into [0, V-1]. Differentiable in
    `params` and `weights` (see `_FusedLookup`). `out_dtype` and
    `round_inputs` pick the kernel's store (see `lookup_combine`)."""
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
                              weights.to(torch.float32).contiguous(),
                              out_dtype,
                              bool(round_inputs)
                              and out_dtype != torch.float32)
