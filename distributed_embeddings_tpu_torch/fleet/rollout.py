"""Canaried version rollout for the serving fleet.

Counterpart of ``distributed_embeddings_tpu/fleet/rollout.py``. A newly
published version serves fleet-wide only after K canary replicas vouch
for it:

  1. **candidate**: the newest published version above the pinned one
     that was not condemned;
  2. **canary**: the first K serving replicas poll up to the candidate
     (``upto=``) while the rest of the fleet stays pinned;
  3. **verdict**: a canary passes when it reached the candidate with no
     active degradation and (with a reference wired) its
     `TableStore.get_weights()` equals the publisher's within
     ``parity_atol`` (0.0: bit for bit);
  4. **promote**: every canary passed; the pin advances and every other
     serving replica polls up to it;
  5. **rollback**: a canary failed; the version is condemned (never
     retried, never served fleet-wide) and the canaries re-anchor on the
     pinned version (`InferenceEngine.reanchor_published`).

A canary that cannot reach the candidate yet (its delta chain waits for
the publisher's next snapshot) is pending, not bad: the next tick retries.
Promotes and rollbacks land on the flight recorder as
``fleet/canary_promote`` / ``fleet/canary_rollback`` instants. The port
has no fault seam (``fleet.canary_apply``) yet (ROADMAP Queue A15b): a
rollback is driven by a `reference_weights` that disagrees with what a
canary applied.
"""

from typing import Callable, List, Optional, Sequence

import numpy as np

from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
from distributed_embeddings_tpu_torch.obs.trace import default_recorder
from distributed_embeddings_tpu_torch.store import scan_published

__all__ = ["CanaryController"]


class CanaryController:
    """Owns the pin, the condemned versions and the promote / rollback
    ledger (`events`). Driven by `FleetRouter.step()`; usable alone.

    Args:
      publish_dir: the publisher's stream directory.
      canaries: how many serving replicas vouch for a version (capped at
        the serving count; default 1).
      reference_weights: optional ``f(version) -> list[np.ndarray] |
        None`` returning the publisher's `get_weights()` at `version`
        (None: no parity check for that version); without it the verdict
        is health only.
      parity_atol: the largest |canary - reference| tolerated (0.0: bit
        for bit).
      registry: optional `MetricRegistry` for ``fleet/promotes_total``,
        ``fleet/rollbacks_total``, ``fleet/pinned_version`` and
        ``fleet/bad_versions``.
    """

    def __init__(self, publish_dir: str, *, canaries: Optional[int] = None,
                 reference_weights: Optional[Callable] = None,
                 parity_atol: float = 0.0, registry=None):
        self.publish_dir = publish_dir
        self.canaries = max(int(1 if canaries is None else canaries), 1)
        self.reference_weights = reference_weights
        self.parity_atol = float(parity_atol)
        self._metrics = registry if registry is not None \
            else MetricRegistry()
        self.pinned_version = 0
        self.bad_versions: set = set()
        self.events: List[dict] = []
        self._metrics.gauge("fleet/pinned_version").set(0)

    # ------------------------------------------------------------ internals
    def candidate(self) -> Optional[int]:
        """The newest published version above the pin that is not
        condemned (None: nothing to roll out)."""
        cand = [v for v, _, _ in scan_published(self.publish_dir)
                if v > self.pinned_version and v not in self.bad_versions]
        return max(cand) if cand else None

    def _parity_dev(self, engine, version: int) -> Optional[float]:
        if self.reference_weights is None:
            return None
        ref = self.reference_weights(version)
        if ref is None:
            return None
        dev = 0.0
        for a, b in zip(ref, engine.store.get_weights()):
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32)
            # equal tables (the common case) need no difference array
            if a.size and not np.array_equal(a, b):
                dev = max(dev, float(np.max(np.abs(a - b))))
        return dev

    def _rollback_one(self, member, backup) -> None:
        """Return one canary to the pinned state: a re-anchor on the stream
        where a pinned version exists, else its in-memory backup (pin 0:
        nothing was promoted, so nothing published to anchor on)."""
        eng = member.engine
        try:
            if self.pinned_version > 0:
                eng.reanchor_published(self.publish_dir,
                                       upto=self.pinned_version)
                return
        except Exception:  # noqa: BLE001 - fall through to the backup
            pass
        eng.store.set_weights(backup)
        eng.refresh()

    # ---------------------------------------------------------------- API
    def advance(self, serving: Sequence) -> Optional[dict]:
        """One rollout tick over the serving members (objects with
        ``.name`` and ``.engine``, in rotation order). Returns None when
        idle, else a dict with ``event`` "pending", "promote" or
        "rollback"; promotes and rollbacks land in `events`."""
        members = list(serving)
        if not members:
            return None
        target = self.candidate()
        if target is None:
            return None
        canaries = members[:min(self.canaries, len(members))]
        rest = members[len(canaries):]
        rec = default_recorder()

        results, reached_all = [], True
        for m in canaries:
            # `get_weights` returns fresh arrays: the backup needs no copy
            backup = [np.asarray(w, np.float32)
                      for w in m.engine.store.get_weights()]
            m.engine.poll_updates(self.publish_dir, upto=target)
            reached = int(m.engine.store.version) >= target
            dev = self._parity_dev(m.engine, target) if reached else None
            degraded = sorted(m.engine.degraded_reasons())
            ok = (reached and not degraded
                  and (dev is None or dev <= self.parity_atol))
            reached_all = reached_all and reached
            results.append({"replica": m.name, "reached": reached,
                            "degraded": degraded, "parity_dev": dev,
                            "ok": ok, "backup": backup})

        if all(r["ok"] for r in results):
            self.pinned_version = target
            for m in rest:
                m.engine.poll_updates(self.publish_dir, upto=target)
            event = {"event": "promote", "version": target,
                     "canaries": [r["replica"] for r in results],
                     "parity_devs": [r["parity_dev"] for r in results]}
            rec.instant("fleet/canary_promote", version=target,
                        canaries=",".join(r["replica"] for r in results))
            self._metrics.counter("fleet/promotes_total").inc()
            self._metrics.gauge("fleet/pinned_version").set(target)
        elif reached_all or any(not r["ok"] and r["reached"]
                                for r in results):
            # a canary reached the candidate and failed it: condemn the
            # version and pull every canary back to the pin
            self.bad_versions.add(target)
            for m, r in zip(canaries, results):
                self._rollback_one(m, r["backup"])
            event = {"event": "rollback", "version": target,
                     "pinned": self.pinned_version,
                     "canaries": [r["replica"] for r in results],
                     "failed": [r["replica"] for r in results
                                if not r["ok"]],
                     "parity_devs": [r["parity_dev"] for r in results],
                     "degraded": sorted({d for r in results
                                         for d in r["degraded"]})}
            rec.instant("fleet/canary_rollback", version=target,
                        pinned=self.pinned_version,
                        failed=",".join(event["failed"]))
            self._metrics.counter("fleet/rollbacks_total").inc()
            self._metrics.gauge("fleet/bad_versions").set(
                len(self.bad_versions))
        else:
            # no canary reached the candidate: retry next tick
            return {"event": "pending", "version": target,
                    "reached": [r["replica"] for r in results
                                if r["reached"]]}
        for r in results:
            r.pop("backup", None)
        event["results"] = results
        self.events.append(event)
        return event
