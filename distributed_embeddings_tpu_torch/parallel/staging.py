"""Input staging: batches from the host to the rank's device.

Counterpart of ``distributed_embeddings_tpu/parallel/staging.py`` and of
``jax.device_put`` as the ingest pipeline's stage. `DeviceStager` copies a
host batch (a pytree of numpy arrays or CPU tensors) to the card without
blocking the host, in two halves:

``stager.stage(batch)``, which may run in a worker thread (the ingest
pipeline's ``stage`` worker; it makes its device current there, where the
current device is per thread):

1. every leaf is packed into one pinned host buffer (16-byte aligned
   offsets), taken from a ring of such buffers; a buffer is refilled only
   after the event recorded behind its last copy has completed, so a copy
   in flight never reads a buffer being overwritten;
2. one ``non_blocking`` copy moves the whole buffer to a device buffer, on
   a side CUDA stream of the stager's own, and an event is recorded
   behind it;
3. it returns a `StagedBatch`: the leaves as views of the device buffer,
   in the batch's structure, with the event.

``staged.take()`` (or `ready`), in the consumer's thread when the step
takes the batch:

4. the consumer's current stream waits on the event, so its kernels read
   the batch only after it arrived, and no earlier step waits for a batch
   staged ahead of it;
5. the device buffer is ``record_stream``'d onto that stream: it was
   allocated on the side stream, and without it the caching allocator
   could hand its memory out again while the consumer's kernels still
   read it.

``stager(batch)`` does both at once, for a caller that uses the batch
where it stages it. The leaves are on the device, so the layers'
``torch.as_tensor(..., device=)`` copies nothing. On a CPU device the
stager only turns the leaves into tensors.

`DoubleBufferSlots` is the lookahead pipeline's two-slot carry
(`schedule.LookaheadEngine`): one batch's prefetched artifacts kept
while the step makes the next batch's.

`dp_slice` cuts a rank's contiguous slice ``[r * B_l, (r + 1) * B_l)`` of
a global batch (as `InputGenerator` makes it), and `stage_dp_batch` stages
it. Rank r's slice is the r-th block of the global batch in both
packages, so the mp ranks see the samples in global order.
"""

import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from distributed_embeddings_tpu_torch.parallel import mesh
from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           resolve_device)

__all__ = ["DeviceStager", "StagedBatch", "ready", "DoubleBufferSlots",
           "dp_slice", "stage_dp_batch"]

# byte alignment of each leaf inside the pinned and the device buffer
ALIGN = 16
# pinned buffers a stager circulates: a refill waits only for the copy
# out of its own buffer, which lands long before the ring comes round
PINNED_SLOTS = 4


def _leaves(tree, out: List[torch.Tensor]):
    """Append the tree's leaves to `out` as CPU tensors; return a skeleton
    that `_rebuild` fills back in (None leaves stay None)."""
    if isinstance(tree, dict):
        return {k: _leaves(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves(v, out) for v in tree)
    if tree is None:
        return None
    t = tree if torch.is_tensor(tree) else torch.as_tensor(np.asarray(tree))
    out.append(t)
    return len(out) - 1


def _rebuild(skeleton, leaves: List[torch.Tensor]):
    if isinstance(skeleton, dict):
        return {k: _rebuild(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_rebuild(v, leaves) for v in skeleton)
    return None if skeleton is None else leaves[skeleton]


class _PinnedSlot:
    """One pinned host buffer and the event behind its last copy."""

    __slots__ = ("buf", "event")

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.event: Optional[torch.cuda.Event] = None


class StagedBatch:
    """A batch on the device whose copy may still be in flight (what
    `DeviceStager.stage` returns). `take()` makes the calling thread's
    current stream wait for the copy, ties the device buffer to that
    stream, and returns the batch."""

    __slots__ = ("batch", "_event", "_buffer")

    def __init__(self, batch: Any, event: Optional[torch.cuda.Event] = None,
                 buffer: Optional[torch.Tensor] = None):
        self.batch, self._event, self._buffer = batch, event, buffer

    def take(self) -> Any:
        if self._event is not None:
            stream = torch.cuda.current_stream(self._buffer.device)
            stream.wait_event(self._event)
            self._buffer.record_stream(stream)
            self._event = self._buffer = None
        return self.batch


def ready(item: Any) -> Any:
    """`item` for the current stream: a `StagedBatch` is taken; anything
    else (a stage function's plain result) passes through."""
    return item.take() if isinstance(item, StagedBatch) else item


class DeviceStager:
    """``stager.stage(batch)`` -> a `StagedBatch` on `device`, and
    ``stager(batch)`` -> the batch itself, taken (see the module
    docstring): one pinned host-to-device copy a batch. PINNED_SLOTS
    pinned buffers circulate; a slot's refill waits only for its own
    copy, never for the consumer."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lock = threading.Lock()
        self._next = 0
        self._slots = [_PinnedSlot() for _ in range(PINNED_SLOTS)]
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, batch: Any) -> Any:
        return self.stage(batch).take()

    def stage(self, batch: Any) -> StagedBatch:
        leaves: List[torch.Tensor] = []
        skeleton = _leaves(batch, leaves)
        if self.device.type != "cuda":
            return StagedBatch(_rebuild(skeleton,
                                        [t.to(self.device) for t in leaves]))
        # leaves on a card already pass (to this one); host leaves go
        # through the pinned buffer
        host = [i for i, t in enumerate(leaves) if t.device.type == "cpu"]
        out = [t if t.device.type == "cpu" else t.to(self.device)
               for t in leaves]
        if not host:
            return StagedBatch(_rebuild(skeleton, out))
        with self._lock:
            slot = self._slots[self._next]
            self._next = (self._next + 1) % len(self._slots)
            with torch.cuda.device(self.device):
                staged, event, buffer = self._copy(
                    slot, [leaves[i] for i in host])
        for i, t in zip(host, staged):
            out[i] = t
        return StagedBatch(_rebuild(skeleton, out), event, buffer)

    def _copy(self, slot: _PinnedSlot, leaves: List[torch.Tensor]):
        offsets, total = [], 0
        for t in leaves:
            offsets.append(total)
            nbytes = t.numel() * t.element_size()
            total += -(-nbytes // ALIGN) * ALIGN
        if slot.event is not None:
            slot.event.synchronize()        # its last copy has landed
        if slot.buf is None or slot.buf.numel() < total:
            slot.buf = torch.empty((max(total, ALIGN),), dtype=torch.uint8,
                                   pin_memory=True)
        host = slot.buf
        for t, off in zip(leaves, offsets):
            n = t.numel() * t.element_size()
            host[off:off + n].copy_(t.contiguous().reshape(-1)
                                    .view(torch.uint8))
        with torch.cuda.stream(self._stream):
            dev = torch.empty((max(total, ALIGN),), dtype=torch.uint8,
                              device=self.device)
            dev[:total].copy_(host[:total], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        out = []
        for t, off in zip(leaves, offsets):
            n = t.numel() * t.element_size()
            out.append(dev[off:off + n].view(t.dtype).view(t.shape))
        return out, event, dev


class DoubleBufferSlots:
    """The two-slot carry of the lookahead pipeline (JAX
    `DoubleBufferSlots` :54): `stage(tree, tag)` installs the carry just
    made (the previous one moves to the retired slot, the one before it
    is returned: it is dropped); `current` and `tag` read the live slot;
    `take()` pops it for the step that consumes it (it moves to the
    retired slot); `clear()` empties both (a flush after the tables moved
    outside the pipeline). The tag is an opaque identity (the engine
    passes the batch the carry was made for), so the consumer can tell
    that the carry is its batch's. PyTorch donates no buffer: the retired
    slot keeps the last carry alive until the next stage, as the JAX
    package's slot keeps the donated one."""

    def __init__(self):
        self._live = None        # (tag, tree)
        self._retired = None     # the previous (tag, tree)

    def stage(self, tree: Any, tag: Any = None) -> Optional[Any]:
        """Install `tree` as the live carry; returns the evicted tree."""
        evicted = self._retired[1] if self._retired is not None else None
        self._retired = self._live
        self._live = (tag, tree)
        return evicted

    @property
    def current(self) -> Optional[Any]:
        return self._live[1] if self._live is not None else None

    @property
    def tag(self) -> Optional[Any]:
        return self._live[0] if self._live is not None else None

    def take(self) -> Optional[Any]:
        """Pop the live carry for consumption (it moves to the retired
        slot)."""
        if self._live is None:
            return None
        tag_tree = self._live
        self._retired = tag_tree
        self._live = None
        return tag_tree[1]

    def clear(self) -> None:
        self._live = None
        self._retired = None


def dp_slice(batch: Any) -> Any:
    """This rank's slice of a global batch, on the host.

    Args:
      batch: a pytree (tuples, lists, dicts) of numpy arrays or tensors,
        each [B, ...] with the global batch B on dim 0.

    Returns the same pytree of tensors [B / world, ...]. A global batch
    that does not divide by the world raises ValueError."""
    rank, world = mesh.rank(), mesh.world_size()

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if x is None:
            return None
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if t.shape[0] % world:
            raise ValueError(f"Global batch {t.shape[0]} not divisible by "
                             f"world size {world}")
        local = t.shape[0] // world
        return t[rank * local:(rank + 1) * local]

    return cut(batch)


def stage_dp_batch(batch: Any, stage: Callable[[Any], Any]) -> Any:
    """``stage(dp_slice(batch))``: this rank's slice of a global batch,
    staged by `stage` (a `DeviceStager`, or its ``stage`` method where the
    consumer takes the batch later)."""
    return stage(dp_slice(batch))
