"""Serving fleet: consistent-hash routing, admission control, elastic
membership and canaried version rollout over the one-replica serving stack
(`serving.InferenceEngine` + `serving.MicroBatcher` + the publish stream).
Counterpart of ``distributed_embeddings_tpu/fleet``; every replica is a
world-1 engine.
"""

from distributed_embeddings_tpu_torch.fleet.admission import (
    AdmissionController, RouteResult)
from distributed_embeddings_tpu_torch.fleet.ring import HashRing, stable_hash64
from distributed_embeddings_tpu_torch.fleet.rollout import CanaryController
from distributed_embeddings_tpu_torch.fleet.router import FleetRouter

__all__ = [
    "AdmissionController",
    "CanaryController",
    "FleetRouter",
    "HashRing",
    "RouteResult",
    "stable_hash64",
]
