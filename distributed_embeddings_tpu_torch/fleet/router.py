"""`FleetRouter`: the serving fleet's traffic front end.

Counterpart of ``distributed_embeddings_tpu/fleet/router.py``. One router
owns N replicas (each an `InferenceEngine` and a `MicroBatcher`):

  * **routing**: `submit(batch, key=)` consistent-hashes the request key
    over the serving members (`fleet.ring`), so each replica's
    `HotRowCache` sees a stable key subset;
  * **admission**: before enqueueing, the target's queue instruments are
    checked (`fleet.admission`); overload returns a typed shed
    `RouteResult`, never an exception, and the shed and admit counters
    land on the shared registry;
  * **elastic membership**: `add_replica` starts a member ``joining``: it
    polls the stream up to the pinned version and enters the ring only
    once caught up; `remove_replica` drains its queue and drops its ring
    positions (bounded key movement);
  * **canaried rollout**: `step()` drives the `CanaryController`.

Synchronous and single-threaded like `MicroBatcher`: the caller decides
when to `flush()` and when to `step()`. `submit`, `flush` and `step` never
raise: failures become typed sheds, dropped handles or counted control
errors. Membership changes land on the flight recorder as
``fleet/replica_join``, ``fleet/replica_enter`` and ``fleet/replica_leave``
instants. The port reads no environment (64 ring positions a member, as
the JAX package's default).
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from distributed_embeddings_tpu_torch.fleet.admission import (
    AdmissionController, RouteResult)
from distributed_embeddings_tpu_torch.fleet.ring import HashRing
from distributed_embeddings_tpu_torch.fleet.rollout import CanaryController
from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
from distributed_embeddings_tpu_torch.obs.trace import default_recorder
from distributed_embeddings_tpu_torch.serving.batcher import MicroBatcher

__all__ = ["FleetRouter"]


class _Member:
    __slots__ = ("name", "engine", "batcher", "state", "routed")

    def __init__(self, name, engine, batcher):
        self.name = name
        self.engine = engine
        self.batcher = batcher
        self.state = "joining"         # joining -> serving (-> left)
        self.routed = 0


class FleetRouter:
    """Route request batches across an elastic replica fleet.

    Args:
      publish_dir: the training job's publish stream: joiners catch up
        from it, the rollout promotes versions out of it.
      registry: shared `MetricRegistry`; build every member's engine with
        ``registry=`` this one and a unique ``replica=`` name.
      vnodes: ring positions a member (default 64).
      admission: `AdmissionController` (default: its defaults).
      canaries / reference_weights / parity_atol: `CanaryController`'s.
      max_batch: each member's `MicroBatcher` cap (default: its own).
      key_fn: optional ``f(batch) -> hashable`` routing key; default the
        first id of the first categorical feature (routable, not affine:
        callers with a session or user key pass ``key=`` to `submit`).
    """

    def __init__(self, publish_dir: str, *, registry=None,
                 vnodes: Optional[int] = None, admission=None,
                 canaries: Optional[int] = None, reference_weights=None,
                 parity_atol: float = 0.0,
                 max_batch: Optional[int] = None, key_fn=None):
        self._metrics = registry if registry is not None \
            else MetricRegistry()
        self.publish_dir = publish_dir
        self.ring = HashRing(64 if vnodes is None else vnodes)
        self.admission = admission if admission is not None \
            else AdmissionController()
        self.rollout = CanaryController(
            publish_dir, canaries=canaries,
            reference_weights=reference_weights, parity_atol=parity_atol,
            registry=self._metrics)
        self._max_batch = max_batch
        self._key_fn = key_fn
        self._members: Dict[str, _Member] = {}     # insertion-ordered
        self._pending: Dict[int, Tuple[str, int]] = {}  # global -> (m, local)
        self._next_handle = 0
        self.submitted = 0
        self.shed = 0
        self.errors: List[str] = []

    # ------------------------------------------------------------ internals
    def _serving(self) -> List[_Member]:
        return [m for m in self._members.values() if m.state == "serving"]

    def _default_key(self, batch):
        if self._key_fn is not None:
            return self._key_fn(batch)
        first = next(iter(self._members.values()))
        cats = batch if first.engine._model is None else batch[1]
        x = cats[0]
        ids = np.asarray(x[0] if isinstance(x, tuple) else x).reshape(-1)
        return int(ids[0]) if ids.size else 0

    def _request_rows(self, member: _Member, batch) -> int:
        cats = batch if member.engine._model is None else batch[1]
        x = cats[0]
        return int(np.asarray(x[0] if isinstance(x, tuple)
                              else x).shape[0])

    def _shed_result(self, reason: str, replica: Optional[str],
                     key) -> RouteResult:
        self.shed += 1
        self._metrics.counter("fleet/shed_total", reason=reason).inc()
        self._metrics.gauge("fleet/shed_rate").set(
            self.shed / max(self.submitted, 1))
        return RouteResult(False, replica=replica, shed_reason=reason,
                           key=key)

    def _note_error(self, where: str, e: BaseException) -> None:
        self.errors.append(f"{where}: {type(e).__name__}: {e}"[:200])
        self._metrics.counter("fleet/router_errors_total").inc()

    def _try_enter(self, m: _Member) -> bool:
        """joining -> serving once caught up to the pinned version (with
        nothing promoted yet, at once, with its constructed state)."""
        pinned = self.rollout.pinned_version
        if pinned > 0:
            m.engine.poll_updates(self.publish_dir, upto=pinned)
            if int(m.engine.store.version) < pinned \
                    or m.engine.degraded_reasons():
                return False
        m.state = "serving"
        self.ring.add(m.name)
        default_recorder().instant(
            "fleet/replica_enter", replica=m.name,
            version=int(m.engine.store.version), pinned=pinned)
        self._metrics.gauge("fleet/replicas").set(len(self._serving()))
        return True

    # ------------------------------------------------------- membership API
    def add_replica(self, name: str, engine, *,
                    max_batch: Optional[int] = None) -> None:
        """Register a member, ``joining`` (a control-plane call: a
        duplicate name raises). It enters rotation on this call if already
        caught up, else on a later `step()`."""
        if name in self._members:
            raise ValueError(f"replica {name!r} already in the fleet")
        batcher = MicroBatcher(engine, max_batch or self._max_batch,
                               registry=self._metrics, replica=name)
        m = _Member(name, engine, batcher)
        self._members[name] = m
        default_recorder().instant("fleet/replica_join", replica=name,
                                   pinned=self.rollout.pinned_version)
        self._try_enter(m)

    def remove_replica(self, name: str) -> Dict[int, Any]:
        """Take a member out of rotation and drain its queue. Returns the
        drained ``{global_handle: outputs}`` (empty when the final flush
        failed: counted, never raised). Its hash ranges fall to the
        clockwise neighbours; every other key keeps its replica."""
        m = self._members.pop(name, None)
        if m is None:
            return {}
        self.ring.remove(name)
        m.state = "left"
        default_recorder().instant("fleet/replica_leave", replica=name)
        self._metrics.gauge("fleet/replicas").set(len(self._serving()))
        drained: Dict[int, Any] = {}
        try:
            local_results = m.batcher.flush() if m.batcher.queue_depth \
                else {}
        except Exception as e:  # noqa: BLE001 - drain must not unwind
            self._note_error(f"drain:{name}", e)
            local_results = {}
        lmap = {local: g for g, (n, local) in self._pending.items()
                if n == name}
        for local, val in local_results.items():
            g = lmap.get(local)
            if g is not None:
                drained[g] = val
        for g in lmap.values():
            self._pending.pop(g, None)
        return drained

    # ------------------------------------------------------------ serve API
    def submit(self, batch, key=None) -> RouteResult:
        """Route one request batch. Never raises: overload, an empty
        rotation, an oversize request and a router fault all return typed
        shed results."""
        self.submitted += 1
        self._metrics.counter("fleet/submitted_total").inc()
        try:
            serving = self._serving()
            if not serving:
                return self._shed_result("no_replicas", None, key)
            if key is None:
                key = self._default_key(batch)
            name = self.ring.route(key)
            m = self._members[name]
            rows = self._request_rows(m, batch)
            if rows > m.batcher.max_batch:
                return self._shed_result("oversize", name, key)
            reason = self.admission.shed_reason(m.batcher, rows)
            if reason is not None:
                return self._shed_result(reason, name, key)
            local = m.batcher.submit(batch)
        except Exception as e:  # noqa: BLE001 - typed shed, never raise
            self._note_error("submit", e)
            return self._shed_result("router_error", None, key)
        g = self._next_handle
        self._next_handle += 1
        self._pending[g] = (name, local)
        m.routed += 1
        self._metrics.counter("fleet/admitted_total", replica=name).inc()
        self._metrics.gauge("fleet/shed_rate").set(
            self.shed / max(self.submitted, 1))
        return RouteResult(True, replica=name, handle=g, key=key)

    def flush(self) -> Dict[int, Any]:
        """Flush every member's queue; returns ``{global_handle:
        outputs}``. A member whose flush fails drops its in-flight handles
        (counted in ``fleet/flush_errors_total`` and `errors`); the other
        members' results still return."""
        out: Dict[int, Any] = {}
        by_member: Dict[str, Dict[int, int]] = {}
        for g, (name, local) in self._pending.items():
            by_member.setdefault(name, {})[local] = g
        for name, m in list(self._members.items()):
            if m.batcher.queue_depth == 0:
                continue
            try:
                local_results = m.batcher.flush()
            except Exception as e:  # noqa: BLE001 - degrade, never raise
                self._note_error(f"flush:{name}", e)
                self._metrics.counter("fleet/flush_errors_total",
                                      replica=name).inc()
                for g in by_member.get(name, {}).values():
                    self._pending.pop(g, None)
                continue
            lmap = by_member.get(name, {})
            for local, val in local_results.items():
                g = lmap.get(local)
                if g is not None:
                    out[g] = val
                    self._pending.pop(g, None)
        return out

    # ---------------------------------------------------- control-plane API
    def step(self) -> dict:
        """One control-plane tick: joiners try to enter rotation, the
        canary rollout advances, and the containment audit runs. Never
        raises: a failure lands in `errors` and
        ``fleet/control_errors_total``, and serving continues pinned."""
        info: dict = {"entered": [], "event": None}
        try:
            for m in list(self._members.values()):
                if m.state == "joining" and self._try_enter(m):
                    info["entered"].append(m.name)
            serving = self._serving()
            info["event"] = self.rollout.advance(serving)
            # no member outside the canary set may ever sit at a condemned
            # version (the canaries pass through one, then roll back)
            k = min(self.rollout.canaries, len(serving))
            for m in serving[k:]:
                if int(m.engine.store.version) in self.rollout.bad_versions:
                    self._metrics.counter(
                        "fleet/bad_version_served_total").inc()
        except Exception as e:  # noqa: BLE001 - control plane degrades
            self._note_error("step", e)
            self._metrics.counter("fleet/control_errors_total").inc()
            info["error"] = self.errors[-1]
        return info

    # ------------------------------------------------------------ stats API
    @property
    def pinned_version(self) -> int:
        return self.rollout.pinned_version

    def stats(self) -> dict:
        """Fleet accounting and each member's state (host-side reads)."""
        members = {}
        for name, m in self._members.items():
            members[name] = {
                "state": m.state, "routed": m.routed,
                "queue_depth": m.batcher.queue_depth,
                "version": int(m.engine.store.version),
                "degraded": sorted(m.engine.degraded_reasons()),
            }
        return {
            "submitted": self.submitted, "shed": self.shed,
            "shed_rate": round(self.shed / max(self.submitted, 1), 4),
            "pinned_version": self.rollout.pinned_version,
            "bad_versions": sorted(self.rollout.bad_versions),
            "promotes": sum(1 for e in self.rollout.events
                            if e["event"] == "promote"),
            "rollbacks": sum(1 for e in self.rollout.events
                             if e["event"] == "rollback"),
            "router_errors": len(self.errors),
            "members": members,
        }
