"""The dp<->mp exchange collectives over ``torch.distributed``.

Counterpart of ``distributed_embeddings_tpu/ops/wire.py`` at its default
``f32`` wire (the bf16 activation wire, the int16 id wire and the row
codecs are ROADMAP Queue A6). As there, every exchange collective of the
embedding layer lives in this module:

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
The tensors stay on their device: NCCL moves CUDA tensors directly, gloo
stages them through host memory itself. Every collective runs inside a
profiler range named `EXCHANGE_RANGE` (a no-op unless a profiler is on),
so a trace reads the exchange's host time and calls.
"""

import torch
import torch.distributed as dist
from torch.profiler import record_function

__all__ = ["wire_all_to_all", "wire_all_to_all_t", "wire_id_all_to_all",
           "EXCHANGE_RANGE"]

EXCHANGE_RANGE = "exchange:all_to_all"


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


class _AllToAll(torch.autograd.Function):
    """The f32 all_to_all with its transpose as backward."""

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
