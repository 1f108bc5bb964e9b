"""The port's serving fleet against the JAX package's `fleet`.

tests/test_fleet.py's rig at world 1 (the JAX side on a one-device mesh):
two 600-row tables all in host memory (``gpu_embedding_size=1``), engines
with a hot-row cache, one publisher's stream of forced snapshots.

* `stable_hash64` and `HashRing.assignments` equal to the JAX package's
  over 10,000 keys, before and after a join and a leave, with the movement
  bounded: a join moves keys only to the new node, a leave only the
  leaver's, and the round trip restores the map;
* typed sheds (``queue_depth``, ``queue_rows``, ``oversize``,
  ``no_replicas``, ``router_error``), never an exception, with the latency
  histogram counting only the admitted requests;
* a promote at parity 0.0 with every member on the publisher's bytes;
* a rollback driven by a `reference_weights` that disagrees with the
  stream at one version (the port has no fault seam yet), containment,
  then the next version promoting; the promote / rollback event sequence
  equal to a JAX `FleetRouter` on the same stream;
* join and leave mid-traffic, a duplicate name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_embeddings_tpu.fleet import FleetRouter as JaxRouter  # noqa: E402
from distributed_embeddings_tpu.fleet import HashRing as JaxRing  # noqa: E402
from distributed_embeddings_tpu.fleet import (  # noqa: E402
    stable_hash64 as jax_hash64)
from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.obs.registry import (  # noqa: E402
    MetricRegistry as JaxRegistry)
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu.serving import (  # noqa: E402
    InferenceEngine as JaxEngine)
from distributed_embeddings_tpu_torch.fleet import (  # noqa: E402
    AdmissionController, FleetRouter, HashRing, RouteResult, stable_hash64)
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry  # noqa: E402
from distributed_embeddings_tpu_torch.serving import InferenceEngine  # noqa: E402
from distributed_embeddings_tpu_torch.store import TableStore  # noqa: E402

SPECS = [(600, 8, "sum"), (600, 8, "sum")]
KEYS = list(range(5000)) + [f"user-{i}" for i in range(5000)]


# --------------------------------------------------------------- hash ring
def test_stable_hash_matches_jax():
    for key in (0, 7, -3, np.int64(7), "7", "r0#0", b"raw", 2.5, True):
        assert stable_hash64(key) == jax_hash64(key)
    assert stable_hash64("replica-a") == 0xD873391571CC4E3A


def test_ring_assignments_match_jax_with_bounded_movement():
    ring, ref = HashRing(vnodes=64), JaxRing(vnodes=64)
    for n in ("a", "b", "c"):
        ring.add(n)
        ref.add(n)
    before = ring.assignments(KEYS)
    assert before == ref.assignments(KEYS)
    ring.add("d")
    ref.add("d")
    with_d = ring.assignments(KEYS)
    assert with_d == ref.assignments(KEYS)
    moved = [k for k in KEYS if with_d[k] != before[k]]
    assert moved and all(with_d[k] == "d" for k in moved)
    assert len(moved) < len(KEYS) / 2
    ring.remove("d")
    assert ring.assignments(KEYS) == before
    ring.remove("b")
    ref.remove("d")
    ref.remove("b")
    after = ring.assignments(KEYS)
    assert after == ref.assignments(KEYS)
    for k in KEYS:
        assert after[k] == before[k] if before[k] != "b" \
            else after[k] in ("a", "c")
    assert ring.nodes() == ["a", "c"] and len(ring) == 2 and "a" in ring
    assert HashRing(vnodes=8).route(1) is None


# ---------------------------------------------------------------- admission
class _FakeBatcher:
    def __init__(self, depth, rows):
        self.queue_depth = depth
        self.queued_rows = rows


def test_admission_sheds_typed_on_depth_and_rows():
    adm = AdmissionController(max_queue_depth=4, max_queue_rows=100)
    assert adm.shed_reason(_FakeBatcher(0, 0), 16) is None
    assert adm.shed_reason(_FakeBatcher(4, 0), 16) == "queue_depth"
    assert adm.shed_reason(_FakeBatcher(1, 90), 16) == "queue_rows"
    assert adm.shed_reason(_FakeBatcher(1, 84), 16) is None
    default = AdmissionController()
    assert (default.max_queue_depth, default.max_queue_rows) == (64, None)
    ok = RouteResult(True, replica="r0", handle=3, key=9)
    shed = RouteResult(False, shed_reason="queue_depth", key=9)
    assert ok and not shed
    assert "queue_depth" in repr(shed) and "r0" in repr(ok)


# ------------------------------------------------------------- fleet rig
def _zeros():
    return [np.zeros((v, w), np.float32) for v, w, _ in SPECS]


def _layer():
    return DistributedEmbedding(
        [Embedding(v, w, combiner=c, device="meta") for v, w, c in SPECS],
        device="cpu", gpu_embedding_size=1)


def _engine(reg, name):
    emb = _layer()
    emb.set_weights(_zeros())
    return InferenceEngine(emb, device="cpu", cache_capacity=64,
                           registry=reg, replica=name)


def _jax_engine(reg, name):
    jl = JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner=c) for v, w, c in SPECS],
        mesh=create_mesh(jax.devices()[:1]), gpu_embedding_size=1)
    return JaxEngine(jl, jl.set_weights(_zeros()), cache_capacity=64,
                     registry=reg, replica=name)


class _Pub:
    """The publisher: a port store of forced snapshots, each version's
    weights kept for the reference."""

    def __init__(self, d):
        self.d = d
        self.emb = _layer()
        self.store = TableStore(self.emb, snapshot_every=2)
        self.versions = {}
        self.bad = set()

    def publish(self, weights):
        self.emb.set_weights(weights)
        self.store.commit()
        self.store.publish(self.d, force_snapshot=True)
        self.versions[self.store.version] = [w.copy() for w in weights]
        return self.store.version

    def reference(self, version):
        """The publisher's weights at `version`; at a version marked bad,
        weights that disagree by 1.0 in one element."""
        w = [x.copy() for x in self.versions[version]]
        if version in self.bad:
            w[0].flat[0] += 1.0
        return w


@pytest.fixture()
def pub(tmp_path):
    rng = np.random.RandomState(0)
    p = _Pub(str(tmp_path / "pub"))
    w1 = [rng.randn(v, w).astype(np.float32) * 0.1 for v, w, _ in SPECS]
    for k in range(3):
        p.publish([t + 0.25 * k for t in w1])
    return p


def _fleet(reg, pub, n=3, make=_engine, router=FleetRouter, **kw):
    kw.setdefault("admission", AdmissionController(max_queue_depth=4))
    r = router(pub.d, registry=reg, vnodes=32, canaries=1,
               reference_weights=pub.reference, **kw)
    for i in range(n):
        r.add_replica(f"r{i}", make(reg, f"r{i}"))
    return r


def _req(key, rows=4):
    ids = np.full((rows, 2), (key * 37) % 600, np.int64)
    return [(ids + t) % 600 for t in range(len(SPECS))]


def _weights_of(member):
    return member.engine.store.get_weights()


# ----------------------------------------------------------------- rollout
def test_promote_at_parity_zero_and_the_fleet_converges(pub):
    reg = MetricRegistry()
    router = _fleet(reg, pub)
    ev = router.step()["event"]
    assert ev["event"] == "promote" and ev["parity_devs"] == [0.0]
    top = max(pub.versions)
    assert router.pinned_version == top
    for m in router._members.values():
        assert m.state == "serving" and m.engine.store.version == top
        for a, b in zip(pub.versions[top], _weights_of(m)):
            np.testing.assert_array_equal(a, b)
    assert router.rollout.candidate() is None
    assert router.step()["event"] is None
    assert router.errors == []


def test_rollback_then_next_version_promotes_as_the_jax_fleet(pub):
    """A reference that disagrees at one version condemns it: the pin
    holds, the canary re-anchors, no member serves the condemned version,
    it is never retried, and the next version promotes through the same
    stream; the events equal a JAX router's on the same stream and
    reference."""
    reg, jreg = MetricRegistry(), JaxRegistry()
    router = _fleet(reg, pub)
    jrouter = _fleet(jreg, pub, make=_jax_engine, router=JaxRouter)
    steps = []
    for r in (router, jrouter):
        assert r.step()["event"]["event"] == "promote"
    v1 = router.pinned_version
    bad = pub.publish([w + 1.5 for w in pub.versions[v1]])
    pub.bad.add(bad)
    for r in (router, jrouter):
        steps.append(r.step()["event"])
    ev = steps[0]
    assert ev["event"] == "rollback" and ev["version"] == bad
    assert ev["parity_devs"] == [pytest.approx(1.0)]
    assert router.pinned_version == v1 and bad in router.rollout.bad_versions
    for m in router._members.values():
        assert m.engine.store.version == v1
        assert not m.engine.store._chain_broken
        for a, b in zip(pub.versions[v1], _weights_of(m)):
            np.testing.assert_array_equal(a, b)
    assert reg.counter("fleet/bad_version_served_total").value == 0
    assert router.step()["event"] is None
    jrouter.step()
    good = pub.publish([w + 0.125 for w in pub.versions[v1]])
    for r in (router, jrouter):
        ev = r.step()["event"]
        assert ev["event"] == "promote" and ev["version"] == good
        assert ev["parity_devs"] == [0.0]
    for m in router._members.values():
        for a, b in zip(pub.versions[good], _weights_of(m)):
            np.testing.assert_array_equal(a, b)
    assert router.rollout.events == jrouter.rollout.events
    assert [e["event"] for e in router.rollout.events] == [
        "promote", "rollback", "promote"]
    assert reg.counter("fleet/rollbacks_total").value == 1
    assert reg.counter("fleet/promotes_total").value == 2
    s, js = router.stats(), jrouter.stats()
    for key in ("pinned_version", "bad_versions", "promotes", "rollbacks",
                "router_errors"):
        assert s[key] == js[key], key


# -------------------------------------------------------- routing + sheds
def test_routing_covers_the_fleet_and_affinity_holds(pub):
    reg = MetricRegistry()
    router = _fleet(reg, pub)
    router.step()
    owners = {}
    for key in range(64):
        r = router.submit(_req(key), key=key)
        assert r.accepted, r
        owners[key] = r.replica
        out = router.flush()
        assert set(out) == {r.handle}
    assert set(owners.values()) == {"r0", "r1", "r2"}
    for key in range(64):
        assert router.submit(_req(key), key=key).replica == owners[key]
        router.flush()
    assert router.errors == []


def test_sheds_are_typed_and_latency_counts_only_admitted(pub):
    reg = MetricRegistry()
    router = _fleet(reg, pub, max_batch=8)
    router.step()
    accepted, shed = [], []
    for _ in range(12):                    # one key -> one replica's queue
        r = router.submit(_req(99), key=99)
        (accepted if r else shed).append(r)
    assert len(accepted) == 4
    assert {s.shed_reason for s in shed} == {"queue_depth"}
    assert all(s.replica == accepted[0].replica for s in shed)
    out = router.flush()
    assert set(out) == {r.handle for r in accepted}
    h = reg.histogram("serve/request_seconds", replica=accepted[0].replica)
    assert h.count == len(accepted)
    assert reg.counter("fleet/shed_total", reason="queue_depth").value == 8
    big = router.submit(_req(5, rows=9), key=5)
    assert not big and big.shed_reason == "oversize"
    broken = router.submit([], key=5)
    assert not broken and broken.shed_reason == "router_error"
    assert len(router.errors) == 1
    rows = FleetRouter(pub.d, registry=MetricRegistry(), admission=(
        AdmissionController(max_queue_depth=64, max_queue_rows=6)))
    rows.add_replica("r0", _engine(MetricRegistry(), "r0"))
    assert rows.submit(_req(1), key=1)
    r = rows.submit(_req(1), key=1)
    assert not r and r.shed_reason == "queue_rows"
    empty = FleetRouter("/nonexistent", registry=MetricRegistry())
    r = empty.submit([np.zeros((2, 2), np.int32)], key=1)
    assert not r and r.shed_reason == "no_replicas"


# ------------------------------------------------------ elastic membership
def test_join_and_leave_mid_traffic_never_raise(pub):
    reg = MetricRegistry()
    router = _fleet(reg, pub)
    router.step()
    pinned = router.pinned_version
    handles = {router.submit(_req(key), key=key).handle for key in range(8)}
    drained = router.remove_replica("r1")
    assert drained and all(v is not None for v in drained.values())
    for key in range(8, 16):
        r = router.submit(_req(key), key=key)
        assert r.replica in ("r0", "r2")
        handles.add(r.handle)
    # the joiner catches up to the pin before it enters the ring
    router.add_replica("r9", _engine(reg, "r9"))
    m = router._members["r9"]
    assert m.state == "serving" and m.engine.store.version == pinned
    out = router.flush()
    handles.discard(None)                  # sheds past a queue's depth
    assert set(out) | set(drained) == handles
    assert router.errors == []
    assert "r9" in router.ring and "r1" not in router.ring
    with pytest.raises(ValueError, match="already in the fleet"):
        router.add_replica("r0", _engine(reg, "r0"))
    assert router.stats()["members"]["r9"]["version"] == pinned
