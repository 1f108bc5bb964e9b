"""Admission control for the serving fleet.

Counterpart of ``distributed_embeddings_tpu/fleet/admission.py``. The serve
path never raises for load: `FleetRouter.submit` returns a typed
`RouteResult`, and a shed is a value the caller can count, retry or
degrade on. The policy sheds before the tail latency explodes, on the
target replica's `MicroBatcher` instruments (`queue_depth`, `queued_rows`)
read at submit time. A request is shed rather than spilled to a sibling,
whose cache never sees that key range: capacity comes from adding
replicas. The port reads no environment: the defaults are the JAX
package's (a depth of 64, no row cap).
"""

from typing import Optional

__all__ = ["RouteResult", "AdmissionController"]


class RouteResult:
    """Typed outcome of one `FleetRouter.submit`.

    ``accepted=True``: `replica` took the request, and `handle` resolves
    in the next `FleetRouter.flush()`. ``accepted=False``: the request was
    shed; `shed_reason` says why (``queue_depth`` / ``queue_rows`` /
    ``no_replicas`` / ``oversize`` / ``router_error``), and `replica`
    names the overloaded target when one was resolved."""

    __slots__ = ("accepted", "replica", "handle", "shed_reason", "key")

    def __init__(self, accepted: bool, replica: Optional[str] = None,
                 handle: Optional[int] = None,
                 shed_reason: Optional[str] = None, key=None):
        self.accepted = bool(accepted)
        self.replica = replica
        self.handle = handle
        self.shed_reason = shed_reason
        self.key = key

    def __bool__(self) -> bool:
        return self.accepted

    def __repr__(self) -> str:
        if self.accepted:
            return (f"RouteResult(accepted, replica={self.replica!r}, "
                    f"handle={self.handle})")
        return (f"RouteResult(shed, reason={self.shed_reason!r}, "
                f"replica={self.replica!r})")


class AdmissionController:
    """Shed decision over one replica's batcher instruments.

    Args:
      max_queue_depth: shed when the target batcher already holds this
        many queued requests (default 64).
      max_queue_rows: optional row cap: shed when accepting the request
        would push the batcher's queued true rows past it (default: none).
    """

    def __init__(self, max_queue_depth: Optional[int] = None,
                 max_queue_rows: Optional[int] = None):
        self.max_queue_depth = int(64 if max_queue_depth is None
                                   else max_queue_depth)
        self.max_queue_rows = (None if max_queue_rows is None
                               else int(max_queue_rows))

    def shed_reason(self, batcher, rows: int) -> Optional[str]:
        """None: admit; else the typed shed reason. Reads only the
        host-side queue state."""
        if batcher.queue_depth >= self.max_queue_depth:
            return "queue_depth"
        if self.max_queue_rows is not None \
                and batcher.queued_rows + int(rows) > self.max_queue_rows:
            return "queue_rows"
        return None
