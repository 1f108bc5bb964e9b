"""Device-prefetching batch iterator.

Counterpart of ``distributed_embeddings_tpu/utils/prefetch.py``: keep
`size` batches already staged on the device ahead of the consumer. `stage`
(default: a `parallel.staging.DeviceStager`'s ``stage``, whose copies run
on a side stream from pinned memory; the consumer's stream waits for a
batch's copy only when the batch is yielded) and the upstream ``next()``
run in the consumer's thread: the iterator hides the host-to-device
copy, not the host-side read. `utils.pipeline.IngestPipeline` (what `training.fit`
uses) runs every stage in a worker of its own.
"""

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional

from distributed_embeddings_tpu_torch.parallel.staging import (DeviceStager,
                                                               ready)

__all__ = ["prefetch_to_device"]


def prefetch_to_device(batches: Iterable, size: int = 2,
                       stage: Optional[Callable[[Any], Any]] = None,
                       device=None) -> Iterator:
    """Yield batches with `size` of them already staged ahead.

    Args:
      batches: iterable of pytrees (numpy arrays or tensors).
      size: how many batches to keep in flight (2 = double buffer).
      stage: per-batch staging function, e.g. `parallel.staging.
        stage_dp_batch` at world size > 1; what it returns is taken with
        `parallel.staging.ready` when it is yielded. Default: a
        `DeviceStager`'s ``stage`` on `device` (None = cuda).

    Yields the staged pytrees in order. On an upstream (or stage) error
    the batches already staged are yielded first and the original
    exception re-raises after them: no staged work is dropped, and the
    consumer sees every batch before the failure exactly once.
    """
    if stage is None:
        stage = DeviceStager(device).stage
    queue: deque = deque()
    it = iter(batches)
    pending_exc = None

    def pull() -> bool:
        nonlocal pending_exc
        if pending_exc is not None:
            return False
        try:
            queue.append(stage(next(it)))
            return True
        except StopIteration:
            return False
        except Exception as e:  # noqa: BLE001 - re-raised after the drain
            pending_exc = e
            return False

    while len(queue) < size and pull():
        pass
    while queue:
        out = queue.popleft()
        pull()
        yield ready(out)
    if pending_exc is not None:
        raise pending_exc
