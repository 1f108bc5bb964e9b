"""Process-group helpers: the port's counterpart of ``parallel/mesh.py``.

The JAX package spans its ranks with a 1-D `Mesh`, one axis playing both
the data-parallel and the model-parallel role (the reference's dp ranks ==
mp ranks). Here the ranks are the processes of the default
``torch.distributed`` process group: `initialize_distributed` starts it,
`world_size` and `rank` read it (1 and 0 without one), and
`average_across_ranks` is the data-parallel gradient all-reduce the
JAX package's sharded autodiff inserts for replicated parameters.
`broadcast_object` and `gather_objects` move small host objects (a
directory listing, a stream file's header, each rank's outcome of a
read) so that every rank decides alike.
"""

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

from distributed_embeddings_tpu_torch.utils.device import (device_scalar,
                                                           resolve_device)

__all__ = ["initialize_distributed", "world_size", "rank",
           "sum_across_ranks", "average_across_ranks", "gather_stack",
           "broadcast_object", "gather_objects", "ALL_REDUCE_RANGE"]

# the profiler range around the dense all-reduce (a no-op unless a
# profiler is on), beside `ops.wire`'s exchange ranges
ALL_REDUCE_RANGE = "exchange:all_reduce"


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> None:
    """Start the default process group (`dist.init_process_group`); a
    repeat call is a no-op.

    `backend` None means "nccl" when the default device
    (`resolve_device(None)`) is a CUDA device and "gloo" on the CPU; a
    caller who wants gloo on CUDA tensors (several ranks sharing one card,
    which NCCL refuses) passes it.
    `init_method` (e.g. ``tcp://localhost:<port>`` or ``file://<path>``),
    `world_size` and `rank` go to `init_process_group` as given; None
    leaves them to its ``env://`` defaults."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if resolve_device(None).type == "cuda" else "gloo"
    kwargs = {}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, **kwargs)


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def sum_across_ranks(tensors: Sequence[torch.Tensor],
                     mean: bool = False) -> List[torch.Tensor]:
    """The sum over ranks of each tensor (the mean with `mean`), through
    one all-reduce of one flat float32 buffer (the dense gradients and the
    loss of a step). Returns new tensors; at world size 1, the tensors
    themselves."""
    world = world_size()
    if world == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    with record_function(ALL_REDUCE_RANGE):
        dist.all_reduce(flat)
    if mean:
        flat = flat / device_scalar(world, flat)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def average_across_ranks(tensors: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """The mean over ranks of each tensor (`sum_across_ranks`)."""
    return sum_across_ranks(tensors, mean=True)


def gather_stack(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` stacked, ``[world, *t.shape]``, on `t`'s device,
    through one ``all_gather_into_tensor`` (concatenated on dim 0, the
    layout gloo and NCCL both take)."""
    world = world_size()
    t = t.contiguous()
    if world == 1:
        return t[None]
    out = torch.empty((world * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t)
    return out.view((world,) + tuple(t.shape))


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank (each rank passes its
    own, which only `src`'s replaces); `obj` itself at world size 1."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's picklable `obj`, in rank order, on every rank;
    ``[obj]`` at world size 1."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out
