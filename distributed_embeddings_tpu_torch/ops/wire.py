"""The dp<->mp exchange collectives over ``torch.distributed``.

Counterpart of ``distributed_embeddings_tpu/ops/wire.py``: the exchange
wire formats (the true-splits ragged exchange is ROADMAP Queue A5) and its
row codec for quantized storage (below). As there, every exchange
collective of the embedding layer lives in this module:

  * `wire_all_to_all`: the mp->dp activation block (and the weight block
    of the dp->mp exchange), ``all_to_all_single`` split and concatenated
    on dim 0, as an autograd Function whose backward is
    `wire_all_to_all_t`;
  * `wire_all_to_all_t`: its transpose, the same collective on the
    gradient (a split-0 / concat-0 all_to_all is its own transpose);
  * `wire_id_all_to_all`: the dp->mp id block, a plain collective (ids
    carry no gradient).

Each takes ``[world, ...]`` with block r going to rank r and returns the
blocks received, block s from rank s, over the default process group.

The row-sliced tables' collectives, tiled over dim 0 (``[B_l, ...]`` on
each rank <-> ``[world * B_l, ...]``, rank r's block at rows ``[r * B_l,
(r + 1) * B_l)``):

  * `wire_all_gather`: the weight broadcast, ``all_gather_into_tensor``,
    whose backward is its transpose, a reduce-scatter of the gradient;
  * `wire_psum_scatter`: the partial-sum return, ``reduce_scatter_tensor``
    (a sum over the ranks), whose backward is `wire_psum_scatter_t`, a
    tiled all_gather of the gradient;
  * `wire_id_all_gather`: the id broadcast, a plain collective.

The float wire (`WIRE_FORMATS`, one per bucket, ``TPBucket.wire_dtype``):

  * ``f32``: the plain collective on the operand in its own dtype (under
    a 16-bit ``compute_dtype`` the activations and their gradients move
    in it), byte for byte the collectives before the wire formats;
  * ``bf16``: `encode_fwd` / `encode_bwd` round to bfloat16 (to nearest
    even) right before the collective and the receiver casts back to the
    operand's dtype, in both directions: one rounding a crossing, every
    gather, combine and update at the caller's precision;
  * ``bf16-sr``: bfloat16 forward, and the gradient rounded
    stochastically (`stochastic_round_bf16`, the JAX package's keyless
    hash of each element's bits and flat position, shared with the row
    codec's draw: `_keyless_hash`).

A compressed reduce-scatter (`wire_psum_scatter`, and `wire_all_gather`'s
backward) runs as encode -> all_to_all -> decode -> a sum of the W blocks
in the caller's dtype, added in rank order, so no add happens at wire
precision and the order is the same on every backend.

The id wire (`ID_WIRE_FORMATS`, ``TPBucket.id_wire_dtype``): the planner
names ``int16`` for a bucket whose every legal wire value (the ids and the
hot split's sentinel ``rows_max``) lies below `INT16_ID_MAX`;
`encode_ids` clips (never wraps) to the int16 range, so an invalid id
stays invalid, and `decode_ids` widens back. Neither gloo nor NCCL takes
int16, so the narrowed ids cross as their bytes (``uint8``, twice the
last dim) and are viewed back after.

The tensors stay on their device: NCCL moves CUDA tensors directly, gloo
stages them through host memory itself (gloo takes all three collective
forms on CUDA tensors under torch 2.11, probed on an H100; its
``reduce_scatter_tensor`` runs as an all-reduce of the whole tensor, which
its profiler events name), so one form serves both backends. Every
collective runs inside a profiler range named for it (`EXCHANGE_RANGE`,
`GATHER_RANGE`, `SCATTER_RANGE`; no-ops unless a profiler is on), so a
trace reads the exchange's host time and calls by collective.

The row codec (the JAX package's storage seam): `encode_rows` /
`decode_rows` turn float32 rows ``[..., w]`` into a 1-byte payload (int8,
or float8 e4m3 as ``torch.float8_e4m3fn``) and a per-row float32 scale
``[..., 1]`` and back, on the tensor's device, for the layer's quantized
buckets; `encode_rows_np` / `decode_rows_np` are their numpy twins for the
stream files (an fp8 payload is held as its raw bytes, ``uint8``: numpy
has no float8). int8 rounds to nearest even, or, with ``sr=True`` (the
training write-back), stochastically by `keyless_uniform`, the JAX
package's keyless hash of each element's bits and flat position; fp8
takes the cast's own rounding. The write-back's scale is
`writeback_scale`'s, the JAX package's compiled form. The byte model
(`store_itemsize`, `delta_row_bytes`, ...) is the JAX package's,
function for function.
"""

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from distributed_embeddings_tpu_torch.utils.device import device_scalar

__all__ = ["WIRE_FORMATS", "ID_WIRE_FORMATS", "INT16_ID_MAX", "resolve_wire",
           "wire_itemsize", "id_wire_itemsize", "encode_fwd", "encode_bwd",
           "stochastic_round_bf16", "int16_id_wire_ok", "encode_ids",
           "decode_ids", "wire_all_to_all", "wire_all_to_all_t",
           "wire_id_all_to_all", "wire_all_gather", "wire_psum_scatter",
           "wire_psum_scatter_t", "wire_id_all_gather", "ragged_exchange",
           "EXCHANGE_RANGE", "GATHER_RANGE", "SCATTER_RANGE", "SR_RANGE",
           "STORE_DTYPES", "INT8_AMAX", "FP8_AMAX", "resolve_store_dtype",
           "fp8_supported", "payload_dtype", "store_itemsize",
           "store_scale_bytes", "delta_row_bytes", "snapshot_row_bytes",
           "store_decode_bound", "keyless_uniform", "writeback_scale",
           "encode_rows", "decode_rows", "encode_rows_np", "decode_rows_np"]

EXCHANGE_RANGE = "exchange:all_to_all"
GATHER_RANGE = "exchange:all_gather"
SCATTER_RANGE = "exchange:reduce_scatter"
# the profiler range of every stochastic rounding (a no-op unless a
# profiler is on), so a trace reads its device time
SR_RANGE = "wire:stochastic_round"

WIRE_FORMATS = ("f32", "bf16", "bf16-sr")
ID_WIRE_FORMATS = ("int32", "int16")
# clip ceiling of the int16 id wire: the planner admits a bucket only when
# every legal wire value (valid ids and the hot sentinel rows_max) lies
# strictly below it, so a clipped invalid id aliases neither
INT16_ID_MAX = 2**15 - 1
SR_WIRE_SALT = 0x9E3779B9
_U32 = 0xFFFFFFFF


def resolve_wire(name: Optional[str]) -> str:
    """Validate and normalize a float wire format name (None -> 'f32')."""
    if name is None or name == "":
        return "f32"
    if name not in WIRE_FORMATS:
        raise ValueError(
            f"unknown exchange wire format {name!r}; expected one of "
            f"{WIRE_FORMATS}")
    return name


def _resolve_id_wire(name: str) -> str:
    if name not in ID_WIRE_FORMATS:
        raise ValueError(f"unknown id wire {name!r}; expected one of "
                         f"{ID_WIRE_FORMATS}")
    return name


def wire_itemsize(name: str) -> int:
    """Bytes per element the float wire moves."""
    return 4 if resolve_wire(name) == "f32" else 2


def id_wire_itemsize(name: str) -> int:
    """Bytes per id the id wire moves."""
    return 2 if name == "int16" else 4


# ------------------------------------------------------------- encoders
def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    """`x` cast to bfloat16, rounded to nearest even, a NaN as the quiet
    NaN of its sign (0x7FC0 / 0xFFC0), as XLA casts it: torch's casts
    store other NaN patterns, and the CPU's and the card's differ."""
    if x.dtype == torch.bfloat16:
        return x
    out = x.to(torch.bfloat16)
    if not x.is_floating_point():
        return out
    nan = torch.where(torch.signbit(x), -0x40, 0x7FC0).to(torch.int16)
    return torch.where(torch.isnan(x), nan.view(torch.bfloat16), out)


def encode_fwd(x: torch.Tensor, wire: str) -> torch.Tensor:
    """Forward-direction wire encode: bfloat16, rounded to nearest even,
    for both compressed formats; 'f32' is the identity."""
    if wire == "f32":
        return x
    return _to_bf16(x)


def encode_bwd(g: torch.Tensor, wire: str) -> torch.Tensor:
    """Gradient-direction wire encode: 'bf16-sr' rounds stochastically
    (`stochastic_round_bf16`), 'bf16' to nearest even; 'f32' is the
    identity."""
    if wire == "f32":
        return g
    if wire == "bf16-sr":
        return stochastic_round_bf16(g)
    return _to_bf16(g)


def stochastic_round_bf16(x: torch.Tensor,
                          salt: int = SR_WIRE_SALT) -> torch.Tensor:
    """float32 -> bfloat16 rounded up with probability equal to the
    distance to the lower neighbour (in units of the step): the JAX
    package's ``stochastic_round_bf16``, bit for bit. With ``bits`` the
    value's bit pattern and ``rnd`` the low 16 bits of `_keyless_hash`
    (the element's bits and its flat position in `x`, with `salt`), the
    result is the top half of ``bits + rnd`` (uint32, wrapping). The draw
    depends on the position, so `x` must be the whole block the JAX
    package encodes. Non-finite and non-float32 inputs take the plain
    cast."""
    if x.dtype != torch.float32:
        return _to_bf16(x)
    with record_function(SR_RANGE):
        x = x.contiguous()
        bits = x.view(torch.int32).to(torch.int64).bitwise_and_(_U32)
        up = _keyless_hash(x, salt).bitwise_and_(0xFFFF).add_(bits)
        up = up.bitwise_and_(_U32).bitwise_right_shift_(16)
        # the top half as a signed 16-bit pattern, viewed as bfloat16
        up = torch.where(up >= 0x8000, up - 0x10000, up).to(torch.int16)
        return torch.where(torch.isfinite(x), up.view(torch.bfloat16),
                           _to_bf16(x))


def int16_id_wire_ok(max_wire_value: int) -> bool:
    """True when every legal wire value (valid ids and the sentinel) lies
    strictly below the int16 clip ceiling: the planner's gate for a
    bucket's int16 id wire."""
    return 0 <= max_wire_value < INT16_ID_MAX


def encode_ids(ids: torch.Tensor, id_wire: str) -> torch.Tensor:
    """Narrow an id block for the wire: 'int16' clips to ``[-2^15,
    INT16_ID_MAX]`` (never wraps, so an out-of-range id stays out of
    range), 'int32' is the identity."""
    if id_wire != "int16":
        return ids
    return ids.clamp(-2**15, INT16_ID_MAX).to(torch.int16)


def decode_ids(ids: torch.Tensor, id_wire: str,
               dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Widen a narrowed id block back to `dtype` ('int32' is the
    identity)."""
    if id_wire != "int16":
        return ids
    return ids.to(dtype)


# ---------------------------------------------------------- collectives
def _all_to_all(x: torch.Tensor) -> torch.Tensor:
    with record_function(EXCHANGE_RANGE):
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    with record_function(GATHER_RANGE):
        x = x.contiguous()
        out = torch.empty((dist.get_world_size() * x.shape[0],)
                          + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out


def _reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    with record_function(SCATTER_RANGE):
        world = dist.get_world_size()
        if x.shape[0] % world:
            raise ValueError(f"reduce-scatter of {x.shape[0]} rows over "
                             f"{world} ranks")
        x = x.contiguous()
        out = torch.empty((x.shape[0] // world,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x)
        return out


def _rank_order_sum(blocks: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0 of `blocks` [W, ...], block 0 first, one add a
    block in the blocks' dtype."""
    acc = blocks[0]
    for r in range(1, blocks.shape[0]):
        acc = acc + blocks[r]
    return acc


class _AllToAll(torch.autograd.Function):
    """The all_to_all over the float wire, its transpose (the same
    collective over the gradient wire) as backward; each direction
    decodes to the operand's dtype."""

    @staticmethod
    def forward(ctx, x, wire):
        ctx.wire = wire
        if wire == "f32":
            return _all_to_all(x)
        return _all_to_all(encode_fwd(x, wire)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return wire_all_to_all_t(g, ctx.wire), None


def wire_all_to_all(x: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """``all_to_all`` (split 0 / concat 0) of a float block ``[world,
    ...]`` over the float wire `wire`, differentiable: the backward runs
    the same collective on the gradient (`wire_all_to_all_t`)."""
    return _AllToAll.apply(x, resolve_wire(wire))


def wire_all_to_all_t(g: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """Transpose of `wire_all_to_all`: the split-0 / concat-0 all_to_all
    is its own transpose, over the gradient wire (`encode_bwd`)."""
    wire = resolve_wire(wire)
    if wire == "f32":
        return _all_to_all(g)
    return _all_to_all(encode_bwd(g, wire)).to(g.dtype)


def _id_collective(collective, ids: torch.Tensor, id_wire: str):
    """`collective` of an id block over the id wire: int16 ids cross as
    their bytes (gloo and NCCL take no int16) and come back in the ids'
    own dtype."""
    if _resolve_id_wire(id_wire) != "int16":
        return collective(ids)
    enc = encode_ids(ids, id_wire).contiguous()
    raw = enc.view(torch.uint8) if enc.dim() else enc.reshape(1).view(
        torch.uint8)
    out = collective(raw).view(torch.int16)
    return decode_ids(out, id_wire, ids.dtype)


def wire_id_all_to_all(ids: torch.Tensor, id_wire: str = "int32"
                       ) -> torch.Tensor:
    """dp->mp id block ``all_to_all`` (split 0 / concat 0) over the id
    wire: 'int16' narrows (`encode_ids`) and the block crosses as its
    bytes; the ids come back in their own dtype."""
    return _id_collective(_all_to_all, ids, id_wire)


class _AllGather(torch.autograd.Function):
    """The tiled float all_gather over the wire; its backward, the
    transpose, is a tiled reduce-scatter of the gradient over the gradient
    wire (at 'f32' the plain collective, else encode, all_to_all, decode
    and the rank-order sum)."""

    @staticmethod
    def forward(ctx, x, wire):
        ctx.wire = wire
        if wire == "f32":
            return _all_gather(x)
        return _all_gather(encode_fwd(x, wire)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.wire == "f32":
            return _reduce_scatter(g), None
        return _scatter_sum(encode_bwd(g, ctx.wire), g.dtype), None


class _PsumScatter(torch.autograd.Function):
    """The tiled reduce-scatter over the wire, its transpose
    (`wire_psum_scatter_t`) as backward."""

    @staticmethod
    def forward(ctx, x, wire):
        ctx.wire = wire
        if wire == "f32":
            return _reduce_scatter(x)
        return _scatter_sum(encode_fwd(x, wire), x.dtype)

    @staticmethod
    def backward(ctx, g):
        return wire_psum_scatter_t(g, ctx.wire), None


def _scatter_sum(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The compressed reduce-scatter of the encoded `y` [world * B_l,
    ...]: the ``[world, B_l, ...]`` blocks through one all_to_all, decoded
    to `dtype`, then summed in rank order (`_rank_order_sum`)."""
    world = dist.get_world_size()
    if y.shape[0] % world:
        raise ValueError(f"reduce-scatter of {y.shape[0]} rows over "
                         f"{world} ranks")
    blocks = _all_to_all(y.reshape((world, y.shape[0] // world)
                                   + tuple(y.shape[1:])))
    return _rank_order_sum(blocks.to(dtype))


def wire_all_gather(x: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """Tiled all_gather over dim 0 of a float ``[B_l, ...]`` block ->
    ``[world * B_l, ...]`` (the row-sliced path's weight broadcast) over
    the float wire, differentiable: the backward reduce-scatters the
    gradient."""
    return _AllGather.apply(x, resolve_wire(wire))


def wire_psum_scatter(x: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """Tiled reduce-scatter over dim 0: ``[world * B_l, ...]`` summed over
    the ranks, this rank keeping rows ``[rank * B_l, (rank + 1) * B_l)``
    (the row-sliced path's partial-sum return), over the float wire
    (compressed: encode, all_to_all, decode, the rank-order sum),
    differentiable: the backward is `wire_psum_scatter_t`."""
    return _PsumScatter.apply(x, resolve_wire(wire))


def wire_psum_scatter_t(g: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """Transpose of `wire_psum_scatter`: a tiled all_gather of the
    gradient over the gradient wire."""
    wire = resolve_wire(wire)
    if wire == "f32":
        return _all_gather(g)
    return _all_gather(encode_bwd(g, wire)).to(g.dtype)


def wire_id_all_gather(ids: torch.Tensor, id_wire: str = "int32"
                       ) -> torch.Tensor:
    """Tiled id all_gather over dim 0 (the row-sliced path's id
    broadcast) over the id wire, as `wire_id_all_to_all`."""
    return _id_collective(_all_gather, ids, id_wire)


def ragged_exchange(*args, **kwargs):
    """The true-splits exchange (``all_to_all_single`` with split sizes)
    of the JAX package's ``DET_RAGGED_EXCHANGE``, which it takes by
    default on the TPU only; every exchange of the port is the padded
    one."""
    raise NotImplementedError(
        "the ragged (true-splits) exchange is not ported yet (ROADMAP Queue "
        "A5 (multi-hot and ragged exchange))")


# ------------------------------------------------------- storage codec
STORE_DTYPES = ("f32", "int8", "fp8")
INT8_AMAX = 127.0
FP8_AMAX = 448.0          # float8_e4m3fn's largest finite value
SR_SALT = 0x85EBCA6B


def fp8_supported() -> bool:
    """True when this torch has the float8 e4m3 dtype (2.1 and later)."""
    return hasattr(torch, "float8_e4m3fn")


def resolve_store_dtype(name: Optional[str]) -> str:
    """Validate and normalize a storage dtype name (None -> 'f32')."""
    if name is None or name == "":
        return "f32"
    if name not in STORE_DTYPES:
        raise ValueError(
            f"unknown storage dtype {name!r}; expected one of "
            f"{STORE_DTYPES}")
    if name == "fp8" and not fp8_supported():
        raise ValueError(
            "storage dtype 'fp8' requested but this torch has no "
            "float8_e4m3fn; use 'int8' or 'f32'")
    return name


def payload_dtype(name: str) -> torch.dtype:
    """The torch dtype a row payload is stored in."""
    name = resolve_store_dtype(name)
    if name == "f32":
        return torch.float32
    return torch.int8 if name == "int8" else torch.float8_e4m3fn


def store_itemsize(name: str) -> int:
    """Bytes per element a row payload occupies at rest."""
    return 4 if resolve_store_dtype(name) == "f32" else 1


def store_scale_bytes(name: str) -> int:
    """Per-row scale bytes (one float32 per quantized row)."""
    return 0 if resolve_store_dtype(name) == "f32" else 4


def delta_row_bytes(width: int, dtype: str) -> int:
    """Bytes one published delta row costs at `dtype`: the 8-byte int64
    flat key, the payload and the per-row scale."""
    return 8 + width * store_itemsize(dtype) + store_scale_bytes(dtype)


def snapshot_row_bytes(width: int, dtype: str) -> int:
    """Bytes one snapshot table row costs at `dtype` (no key)."""
    return width * store_itemsize(dtype) + store_scale_bytes(dtype)


def store_decode_bound(rows, dtype: str, sr: bool = False) -> np.ndarray:
    """Per-row absolute error bound of one encode / decode round trip of
    the float32 `rows` ``[..., w]`` at `dtype`: half a grid step of int8
    (amax / 254; a whole step under SR), 2^-4 of the row amax at fp8 (twice
    that under SR), 0 at f32."""
    rows = np.asarray(rows, np.float32)
    amax = np.max(np.abs(rows), axis=-1)
    dtype = resolve_store_dtype(dtype)
    if dtype == "f32":
        return np.zeros_like(amax)
    if dtype == "int8":
        return amax / INT8_AMAX * (1.0 if sr else 0.5)
    return amax * (2.0 ** -4) * (2.0 if sr else 1.0)


def _row_scale(amax: torch.Tensor, grid_amax: float) -> torch.Tensor:
    """Per-row scale from the row amax, a true division as the JAX
    package's eager and numpy encodes compute it; zero rows take scale 1,
    so they round-trip to zeros."""
    one = torch.ones((), dtype=torch.float32, device=amax.device)
    return torch.where(amax > 0, amax / device_scalar(grid_amax, amax), one)


def writeback_scale(rows: torch.Tensor, store_dtype: str) -> torch.Tensor:
    """The training write-back's per-row scale ``[..., 1]`` of the float32
    `rows`: the row amax times the float32 reciprocal of the grid's amax,
    as the JAX package's compiled train step computes ``amax / grid_amax``
    (XLA folds the division by a constant into that multiply); zero rows
    take scale 1. `encode_rows` takes it as ``scale=``; its own scale, like
    `encode_rows_np`'s, is the true division (`_row_scale`)."""
    store_dtype = resolve_store_dtype(store_dtype)
    grid = INT8_AMAX if store_dtype == "int8" else FP8_AMAX
    rows = rows.float()
    amax = (rows.abs().amax(dim=-1, keepdim=True) if rows.numel()
            else rows.new_zeros(tuple(rows.shape[:-1]) + (1,)))
    one = torch.ones((), dtype=torch.float32, device=amax.device)
    return torch.where(amax > 0, amax * float(
        np.float32(1.0) / np.float32(grid)), one)


def _keyless_hash(y: torch.Tensor, salt: int) -> torch.Tensor:
    """The JAX package's keyless hash of each element of the float32 `y`
    (contiguous): with its bit pattern ``bits`` and its flat position
    ``i`` (as uint32), ``h = bits ^ (i * 2654435761 + salt)``, two
    xor-shift-multiply rounds and a last xor-shift. uint32 arithmetic is
    emulated in int64, masked to 32 bits after every multiply (each
    product stays below 2^63); returns h as int64 in [0, 2^32)."""
    h = torch.arange(y.numel(), dtype=torch.int64, device=y.device)
    h = h.view(y.shape).bitwise_and_(_U32).mul_(2654435761).add_(salt)
    h.bitwise_and_(_U32).bitwise_xor_(
        y.view(torch.int32).to(torch.int64).bitwise_and_(_U32))
    h.bitwise_xor_(h >> 15).mul_(0x2C1B3C6D).bitwise_and_(_U32)
    h.bitwise_xor_(h >> 12).mul_(0x297A2D39).bitwise_and_(_U32)
    return h.bitwise_xor_(h >> 15)


def keyless_uniform(y: torch.Tensor, salt: int = SR_SALT) -> torch.Tensor:
    """The JAX package's keyless stochastic-rounding draw: for each element
    of the float32 `y`, ``u = (h & 0xFFFF) / 65536`` in [0, 1) with h its
    `_keyless_hash`. The draw depends on the position, so `y` must be the
    very array the JAX package encodes (a prefix of it gives the prefix's
    draws)."""
    y = y.contiguous()
    h = _keyless_hash(y, salt)
    return h.bitwise_and_(0xFFFF).to(torch.float32).div_(65536.0)


def encode_rows(rows: torch.Tensor, store_dtype: str, sr: bool = False,
                salt: int = SR_SALT, scale: Optional[torch.Tensor] = None):
    """float32 rows ``[..., w]`` -> (payload ``[..., w]``, scale ``[...,
    1]``), on the rows' device. 'f32' is the identity (scale None). 'int8':
    symmetric per-row linear quantization, rounded to nearest even, or
    with ``sr=True`` to ``floor(y + u)`` with `keyless_uniform`'s u (the
    training write-back: the rounding of repeated updates centres on zero).
    'fp8': the e4m3 cast of the rescaled rows (its own round-to-nearest;
    SR is int8's only). The scale is the row amax over the grid's amax (a
    true division, as `encode_rows_np` takes it), or the given `scale`
    (the write-back passes `writeback_scale`'s)."""
    store_dtype = resolve_store_dtype(store_dtype)
    if store_dtype == "f32":
        return rows, None
    rows = rows.float()
    grid = INT8_AMAX if store_dtype == "int8" else FP8_AMAX
    if scale is None:
        if rows.numel():
            amax = rows.abs().amax(dim=-1, keepdim=True)
        else:
            amax = rows.new_zeros(tuple(rows.shape[:-1]) + (1,))
        scale = _row_scale(amax, grid)
    if store_dtype == "int8":
        y = rows / scale
        q = (y + keyless_uniform(y, salt)).floor_() if sr else y.round()
        return q.clamp_(-INT8_AMAX, INT8_AMAX).to(torch.int8), scale
    return (rows / scale).to(torch.float8_e4m3fn), scale


def decode_rows(payload: torch.Tensor, scale: Optional[torch.Tensor],
                store_dtype: str) -> torch.Tensor:
    """(payload, scale) -> float32 rows: the gather-time decode. 'f32' is
    the identity."""
    if resolve_store_dtype(store_dtype) == "f32":
        return payload
    return payload.to(torch.float32) * scale


def _fp8_bytes(payload) -> np.ndarray:
    """An fp8 payload's raw bytes as uint8: from a tensor, from the raw
    1-byte void a ``.npz`` gives back for the JAX package's float8, from
    ``uint8`` or from an ``ml_dtypes`` float8 array (its bytes taken, the
    package never imported)."""
    if torch.is_tensor(payload):
        return payload.detach().cpu().contiguous().view(torch.uint8).numpy()
    payload = np.ascontiguousarray(payload)
    if payload.dtype.itemsize != 1:
        raise TypeError(f"an fp8 payload has 1-byte elements, got "
                        f"{payload.dtype}")
    return payload.view(np.uint8)


_FP8_VALUES = None


def encode_rows_np(rows, store_dtype: str, sr: bool = False,
                   salt: int = SR_SALT):
    """Numpy twin of `encode_rows` (which alone takes a ``scale=``), bit
    for bit the JAX package's `encode_rows_np`: round to nearest by
    default (stream bytes are deterministic), ``sr=True`` the same hash as
    the device encoder. An fp8 payload comes back as its raw bytes
    (``uint8``), which the JAX package's loader views back as float8."""
    store_dtype = resolve_store_dtype(store_dtype)
    rows = np.asarray(rows, np.float32)
    if store_dtype == "f32":
        return rows, None
    amax = (np.max(np.abs(rows), axis=-1, keepdims=True) if rows.size
            else np.zeros(rows.shape[:-1] + (1,), np.float32))
    if store_dtype == "int8":
        scale = np.where(amax > 0, amax / np.float32(INT8_AMAX),
                         np.float32(1.0)).astype(np.float32)
        with np.errstate(invalid="ignore"):
            y = (rows / scale).astype(np.float32)
            if sr and y.size:
                bits = y.view(np.uint32)
                idx = np.arange(y.size, dtype=np.uint32).reshape(y.shape)
                with np.errstate(over="ignore"):
                    h = bits ^ (idx * np.uint32(2654435761)
                                + np.uint32(salt))
                    h = (h ^ (h >> np.uint32(15))) * np.uint32(0x2C1B3C6D)
                    h = (h ^ (h >> np.uint32(12))) * np.uint32(0x297A2D39)
                    h = h ^ (h >> np.uint32(15))
                u = (h & np.uint32(0xFFFF)).astype(np.float32) \
                    / np.float32(65536.0)
                q = np.floor(y + u)
            else:
                q = np.rint(y)
        payload = np.clip(q, -INT8_AMAX, INT8_AMAX).astype(np.int8)
        return payload, scale
    scale = np.where(amax > 0, amax / np.float32(FP8_AMAX),
                     np.float32(1.0)).astype(np.float32)
    y = torch.from_numpy(np.ascontiguousarray(rows / scale))
    return _fp8_bytes(y.to(torch.float8_e4m3fn)), scale


def decode_rows_np(payload, scale, store_dtype: str) -> np.ndarray:
    """Numpy twin of `decode_rows`; an fp8 payload as raw bytes (uint8,
    the void a ``.npz`` gives back, or a float8 array)."""
    global _FP8_VALUES
    if resolve_store_dtype(store_dtype) == "f32":
        return np.asarray(payload, np.float32)
    scale = np.asarray(scale, np.float32)
    if store_dtype == "fp8":
        if _FP8_VALUES is None:
            _FP8_VALUES = torch.arange(256, dtype=torch.int32).to(
                torch.uint8).view(torch.float8_e4m3fn).float().numpy()
        return _FP8_VALUES[_fp8_bytes(payload)] * scale
    return np.asarray(payload).astype(np.float32) * scale
