"""The dp<->mp exchange collectives over ``torch.distributed``.

Counterpart of ``distributed_embeddings_tpu/ops/wire.py`` at its default
``f32`` wire (the bf16 activation wire, the int16 id wire and the row
codecs are ROADMAP Queue A6; the true-splits ragged exchange is A5). As
there, every exchange collective of the embedding layer lives in this
module:

  * `wire_all_to_all`: the mp->dp activation block (and the weight block
    of the dp->mp exchange), ``all_to_all_single`` split and concatenated
    on dim 0, as an autograd Function whose backward is
    `wire_all_to_all_t`;
  * `wire_all_to_all_t`: its transpose, the same collective on the
    gradient (a split-0 / concat-0 all_to_all is its own transpose);
  * `wire_id_all_to_all`: the dp->mp id block, a plain collective (ids
    carry no gradient). The planner names the int16 id wire for every
    bucket whose ids fit it; the narrowing is A6's, and the ids move in
    their own dtype meanwhile, which gives the same ids (the planner's
    gate makes the int16 wire lossless, and its clip keeps an invalid id
    invalid, as the lookups and updates treat every id past the table).

Each takes ``[world, ...]`` with block r going to rank r and returns the
blocks received, block s from rank s, over the default process group.
Every collective moves its operand in the operand's own dtype, as the JAX
package's ``f32`` wire runs the plain collective: under a 16-bit
``compute_dtype`` the activations and their gradients move in it (half
the bytes), the ids and the input weights as they come.

The row-sliced tables' collectives, tiled over dim 0 (``[B_l, ...]`` on
each rank <-> ``[world * B_l, ...]``, rank r's block at rows ``[r * B_l,
(r + 1) * B_l)``):

  * `wire_all_gather`: the weight broadcast, ``all_gather_into_tensor``,
    whose backward is its transpose, a reduce-scatter of the gradient;
  * `wire_psum_scatter`: the partial-sum return, ``reduce_scatter_tensor``
    (a sum over the ranks), whose backward is `wire_psum_scatter_t`, a
    tiled all_gather of the gradient;
  * `wire_id_all_gather`: the id broadcast, a plain collective.

The tensors stay on their device: NCCL moves CUDA tensors directly, gloo
stages them through host memory itself (gloo takes all three collective
forms on CUDA tensors under torch 2.11, probed on an H100; its
``reduce_scatter_tensor`` runs as an all-reduce of the whole tensor, which
its profiler events name), so one form serves both backends. Every
collective runs inside a profiler range named for it (`EXCHANGE_RANGE`,
`GATHER_RANGE`, `SCATTER_RANGE`; no-ops unless a profiler is on), so a
trace reads the exchange's host time and calls by collective.
"""

import torch
import torch.distributed as dist
from torch.profiler import record_function

__all__ = ["wire_all_to_all", "wire_all_to_all_t", "wire_id_all_to_all",
           "wire_all_gather", "wire_psum_scatter", "wire_psum_scatter_t",
           "wire_id_all_gather", "ragged_exchange", "EXCHANGE_RANGE",
           "GATHER_RANGE", "SCATTER_RANGE"]

EXCHANGE_RANGE = "exchange:all_to_all"
GATHER_RANGE = "exchange:all_gather"
SCATTER_RANGE = "exchange:reduce_scatter"


def _check_wire(wire: str, *ported: str) -> None:
    if wire not in ported:
        raise NotImplementedError(
            f"the {wire!r} exchange wire is not ported yet (ROADMAP Queue A6 "
            "(wire formats and quantized storage))")


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


class _AllToAll(torch.autograd.Function):
    """The float all_to_all with its transpose as backward."""

    @staticmethod
    def forward(ctx, x):
        return _all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return wire_all_to_all_t(g, "f32")


def wire_all_to_all(x: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """``all_to_all`` (split 0 / concat 0) of a float block ``[world,
    ...]``, differentiable: the backward runs the same collective on the
    gradient."""
    _check_wire(wire, "f32")
    return _AllToAll.apply(x)


def wire_all_to_all_t(g: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """Transpose of `wire_all_to_all`: the split-0 / concat-0 all_to_all
    is its own transpose."""
    _check_wire(wire, "f32")
    return _all_to_all(g)


def wire_id_all_to_all(ids: torch.Tensor, id_wire: str = "int32"
                       ) -> torch.Tensor:
    """dp->mp id block ``all_to_all`` (split 0 / concat 0), in the ids'
    own dtype (int32, or int64 for a bucket past the int32 range) on
    either id wire ("int32", "int16")."""
    _check_wire(id_wire, "int32", "int16")
    return _all_to_all(ids)


class _AllGather(torch.autograd.Function):
    """The tiled float all_gather with its transpose, a tiled
    reduce-scatter of the gradient, as backward."""

    @staticmethod
    def forward(ctx, x):
        return _all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g)


class _PsumScatter(torch.autograd.Function):
    """The tiled float reduce-scatter with its transpose as backward."""

    @staticmethod
    def forward(ctx, x):
        return _reduce_scatter(x)

    @staticmethod
    def backward(ctx, g):
        return wire_psum_scatter_t(g, "f32")


def wire_all_gather(x: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """Tiled all_gather over dim 0 of a float ``[B_l, ...]`` block ->
    ``[world * B_l, ...]`` (the row-sliced path's weight broadcast),
    differentiable: the backward reduce-scatters the gradient."""
    _check_wire(wire, "f32")
    return _AllGather.apply(x)


def wire_psum_scatter(x: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """Tiled reduce-scatter over dim 0: ``[world * B_l, ...]`` summed over
    the ranks, this rank keeping rows ``[rank * B_l, (rank + 1) * B_l)``
    (the row-sliced path's partial-sum return), differentiable: the
    backward is `wire_psum_scatter_t`."""
    _check_wire(wire, "f32")
    return _PsumScatter.apply(x)


def wire_psum_scatter_t(g: torch.Tensor, wire: str = "f32") -> torch.Tensor:
    """Transpose of `wire_psum_scatter`: a tiled all_gather of the
    gradient."""
    _check_wire(wire, "f32")
    return _all_gather(g)


def wire_id_all_gather(ids: torch.Tensor, id_wire: str = "int32"
                       ) -> torch.Tensor:
    """Tiled id all_gather over dim 0 (the row-sliced path's id
    broadcast), in the ids' own dtype on either id wire."""
    _check_wire(id_wire, "int32", "int16")
    return _all_gather(ids)


def ragged_exchange(*args, **kwargs):
    """The true-splits exchange (``all_to_all_single`` with split sizes)
    of the JAX package's ``DET_RAGGED_EXCHANGE``, which it takes by
    default on the TPU only; every exchange of the port is the padded
    one."""
    raise NotImplementedError(
        "the ragged (true-splits) exchange is not ported yet (ROADMAP Queue "
        "A5 (multi-hot and ragged exchange))")
