"""The port's engine consuming a publish stream, against the JAX engine.

tests/test_store.py's engine-streaming case and tests/test_faults.py's
degradation cases at world 1 (the JAX side on a one-device mesh), over
tests/test_serving.py's offloaded tables with a hot-row cache:

* `poll_updates` and `apply_delta` over a stream the JAX package wrote and
  over one the port wrote: a snapshot, then deltas that rewrite the cached
  rows; the resident slots are patched from each delta's payload, so
  cached serving stays bit-equal to the forward on the new tables and to
  the JAX cached engine on the same stream, `cache_stats` equal;
* `set_params` breaks the chain: an aliasing delta is refused and the next
  poll re-anchors on the newest snapshot;
* `upto` is a ceiling (caught up, not degraded), and `reanchor_published`
  adopts the publisher's version space as the JAX engine does;
* the vocabulary sidecar loaded late, without new rows; a corrupt sidecar
  (``vocab_sidecar``), a corrupt stream file (``corrupt_stream``) and a
  stream of another model (``poll_error``) degrade and never raise, with
  the ``serve/degraded{reason=}`` gauges under the replica's label;
* a serving replica's query-only `VocabManager` over a table of an
  offloaded bucket (the port takes it; `maintain` refuses it): the
  binding loaded from the sidecar, the raw keys served bit-equal;
* the collective apply's agreement: a failed read raises its type on
  every rank and writes nothing (the W = 2 and 4 paths run in
  `tests/test_torch_multigpu.py`'s spawns).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_embeddings_tpu.serving import (  # noqa: E402
    InferenceEngine as JaxEngine)
from distributed_embeddings_tpu.store import (  # noqa: E402
    TableStore as JaxTableStore)
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry  # noqa: E402
from distributed_embeddings_tpu_torch.serving import InferenceEngine  # noqa: E402
from distributed_embeddings_tpu_torch.store import (  # noqa: E402
    DeltaChainError, TableStore, table_store)
from distributed_embeddings_tpu_torch.utils.checkpoint import (  # noqa: E402
    StreamIntegrityError)
from distributed_embeddings_tpu_torch.vocab import (  # noqa: E402
    VocabManager, vocab_state_path)

from test_serving import SPECS  # noqa: E402
from test_torch_serving_cache import (  # noqa: E402
    BATCH, _assert_bit_equal, _jax_layer, _layer, _weights)

HOT = [np.tile(np.arange(4, dtype=np.int32), BATCH // 4) for _ in SPECS]


def _bump(ws, x):
    """`ws` with `x` added to the rows `HOT` touches (a delta carries
    only those)."""
    out = [w.copy() for w in ws]
    for w in out:
        w[:4] += x
    return out


def _zeros():
    return [np.zeros((v, w), np.float32) for v, w, _ in SPECS]


class _Publisher:
    """A training job's store in either package, publishing whole weight
    lists: `snapshot(w)` forces a snapshot, `delta(w)` publishes the rows
    `HOT` touches."""

    def __init__(self, kind, d, w):
        self.kind, self.d = kind, d
        if kind == "jax":
            self.emb = _jax_layer()
            self.store = JaxTableStore(self.emb, self.emb.set_weights(w))
            self.touched = self.emb.touched_row_keys(HOT)
        else:
            self.emb = _layer()
            self.emb.set_weights(w)
            self.store = TableStore(self.emb)
            self.touched = self.emb.touched_row_keys(HOT)

    def _commit(self, w, touched):
        if self.kind == "jax":
            self.store.commit(self.emb.set_weights(w), touched=touched)
        else:
            self.emb.set_weights(w)
            self.store.commit(touched=touched)

    def snapshot(self, w):
        self._commit(w, None)
        return self.store.publish(self.d, force_snapshot=True)

    def delta(self, w):
        self._commit(w, self.touched)
        return self.store.publish(self.d)

    def weights(self):
        return self.store.get_weights()


def _engines(reg=None, replica=None):
    """A cached port engine and a cached JAX engine, both over zero
    tables."""
    layer = _layer()
    layer.set_weights(_zeros())
    eng = InferenceEngine(layer, device="cpu", cache_capacity=1024,
                          promote_threshold=1, registry=reg,
                          replica=replica)
    jl = _jax_layer()
    jeng = JaxEngine(jl, jl.set_weights(_zeros()), cache_capacity=1024,
                     promote_threshold=1)
    return eng, jeng


def _same(eng, jeng, cats, what):
    got = eng.predict(cats)
    with torch.no_grad():
        plain = eng.embedding(cats)
    _assert_bit_equal(got, plain, f"{what}: the uncached forward")
    _assert_bit_equal(got, jeng.predict(cats), f"{what}: the JAX engine")
    return got


def _tables_equal(got, want):
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"table {i}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stream_patches_slots_and_serves_bit_equal(tmp_path, writer):
    d = str(tmp_path / "pub")
    w0 = _weights()
    pub = _Publisher(writer, d, w0)
    pub.snapshot(w0)
    eng, jeng = _engines()
    assert [i["kind"] for i in eng.poll_updates(d)] == ["snapshot"]
    assert [i["kind"] for i in jeng.poll_updates(d)] == ["snapshot"]
    assert eng.store.version == 1
    for r in range(3):                 # count -> promote -> serve cached
        _same(eng, jeng, HOT, f"warm {r}")
    assert eng.cache_stats()["hits"] > 0

    # the publisher rewrites the rows the caches hold: a delta
    w1 = _bump(w0, 1.0)
    assert pub.delta(w1)["kind"] == "delta"
    assert [i["version"] for i in eng.poll_updates(d)] == [2]
    jeng.poll_updates(d)
    cache = eng.caches[eng.embedding.offloaded_buckets[0]]
    assert cache.patched > 0 and cache.refreshed_version == 2
    _same(eng, jeng, HOT, "after the delta")
    _tables_equal(eng.store.get_weights(), pub.weights())

    # one file through apply_delta
    info = pub.delta(_bump(w1, 0.5))
    assert eng.apply_delta(info["path"])["version"] == 3
    jeng.apply_delta(info["path"])
    assert cache.refreshed_version == 3
    _same(eng, jeng, HOT, "after apply_delta")
    _tables_equal(eng.store.get_weights(), pub.weights())
    stats = eng.update_stats(d)
    assert stats["version_monotonic"] and stats["applied"] == 2
    assert eng.cache_stats() == jeng.cache_stats()
    assert eng.cache_stats()["store_version"] == 3


def test_set_params_breaks_the_chain_and_poll_reanchors(tmp_path):
    """tests/test_store.py's aliasing interleaving: after `set_params` the
    engine's version numerically equals a later delta's base, which must
    not chain; the next poll re-anchors on the newest snapshot and replays
    the chain from it."""
    d = str(tmp_path / "pub")
    w0 = _weights()
    pub = _Publisher("port", d, w0)
    pub.snapshot(w0)
    eng, _ = _engines()
    eng.poll_updates(d)
    for _ in range(2):
        eng.predict(HOT)
    w1 = _bump(w0, 1.0)
    pub.delta(w1)
    eng.poll_updates(d)
    assert eng.store.version == 2
    eng.set_params(eng.embedding.state_dict(), refresh=True)
    assert eng.store.version == 3
    pub.delta(w1)                                  # v3, base 2
    aliasing = pub.delta(w1)                       # v4, base 3
    assert aliasing["base_version"] == eng.store.version
    with pytest.raises(DeltaChainError, match="out of band"):
        eng.store.apply_published(aliasing["path"])
    applied = eng.poll_updates(d)
    assert [i["kind"] for i in applied] == ["snapshot", "delta", "delta",
                                            "delta"]
    assert eng.store.version == 4
    _tables_equal(eng.store.get_weights(), pub.weights())
    with torch.no_grad():
        _assert_bit_equal(eng.predict(HOT), eng.embedding(HOT), "re-anchored")


def test_upto_is_a_ceiling_and_reanchor_adopts_the_version(tmp_path):
    d = str(tmp_path / "pub")
    w0 = _weights()
    pub = _Publisher("port", d, w0)
    versions = {pub.snapshot(w0)["version"]: w0}
    for k in (1, 2):
        wk = _bump(w0, 0.25 * k)
        versions[pub.delta(wk)["version"]] = wk
    vs = sorted(versions)
    eng, jeng = _engines(reg=MetricRegistry(), replica="pin")
    assert [i["version"] for i in eng.poll_updates(d, upto=vs[1])] == vs[:2]
    assert eng.store.version == vs[1] and not eng.degraded_reasons()
    _tables_equal(eng.store.get_weights(), versions[vs[1]])
    assert [i["version"] for i in eng.poll_updates(d)] == [vs[2]]

    eng2, _ = _engines()
    assert eng2.reanchor_published(d, upto=vs[1]) == vs[1]
    assert jeng.reanchor_published(d, upto=vs[1]) == vs[1]
    assert eng2.store.version == jeng.store.version == vs[1]
    assert eng2.store.table_versions == list(jeng.store.table_versions)
    assert not eng2.store._chain_broken
    _tables_equal(eng2.store.get_weights(), versions[vs[1]])
    # the stream continues from there, chained, without a snapshot
    assert [i["kind"] for i in eng2.poll_updates(d)] == ["delta"]
    assert eng2.store.version == vs[2]


# ------------------------------------------------- sidecars and degradation
SIZES = [(48, 8), (32, 8), (100, 8), (64, 8)]


def _vocab_layer():
    return DistributedEmbedding(
        [Embedding(v, w, combiner="sum", device="meta") for v, w in SIZES],
        device="cpu", vocab_slack=16)


def test_late_sidecar_loads_without_new_rows(tmp_path):
    """tests/test_vocab.py's race: the rows arrive before their binding
    sidecar; the next poll loads it although no row file is new."""
    emb = _vocab_layer()
    mgr = VocabManager(emb, admit_threshold=1, use_native=False)
    mgr.vocabs[0].bind([111, 222])
    store = TableStore(emb)
    d = str(tmp_path)
    store.commit()
    store.publish(d)                               # rows v1, no sidecar
    emb_c = _vocab_layer()
    mgr_c = VocabManager(emb_c, use_native=False)
    eng = InferenceEngine(emb_c, device="cpu", vocab_manager=mgr_c)
    assert eng.poll_updates(d) and mgr_c.vocabs[0].bound == 0
    mgr.save_state(vocab_state_path(d, 1))         # the sidecar lands late
    assert eng.poll_updates(d) == []
    assert mgr_c.vocabs[0].bound == 2
    assert not eng.degraded_reasons()


def test_corrupt_sidecar_degrades_and_never_raises(tmp_path):
    emb = _vocab_layer()
    mgr = VocabManager(emb, admit_threshold=1, use_native=False)
    mgr.vocabs[0].bind([111, 222])
    store = TableStore(emb)
    d = str(tmp_path)
    store.commit()
    store.publish(d)
    with open(vocab_state_path(d, 1), "wb") as f:
        f.write(b"not a sidecar")
    reg = MetricRegistry()
    emb_c = _vocab_layer()
    mgr_c = VocabManager(emb_c, use_native=False)
    eng = InferenceEngine(emb_c, device="cpu", vocab_manager=mgr_c,
                          registry=reg, replica="r0")
    assert [i["version"] for i in eng.poll_updates(d)] == [1]
    assert eng.degraded_reasons() == frozenset({"vocab_sidecar"})
    assert reg.gauge("serve/degraded", reason="vocab_sidecar",
                     replica="r0").value == 1
    assert reg.counter("serve/poll_errors_total", replica="r0").value == 1
    assert eng.last_poll_error
    assert mgr_c.vocabs[0].bound == 0              # the old binding serves
    out = eng.predict([np.asarray([111, 5]), np.zeros(2, np.int64),
                       np.zeros(2, np.int64), np.zeros(2, np.int64)])
    assert tuple(out[0].shape) == (2, 8)
    # the next publish's good sidecar heals it
    store.commit()
    mgr.save_state(vocab_state_path(d, 2))
    store.publish(d)
    eng.poll_updates(d)
    assert not eng.degraded_reasons() and mgr_c.vocabs[0].bound == 2
    assert reg.gauge("serve/degraded", reason="vocab_sidecar",
                     replica="r0").value == 0


def test_corrupt_stream_file_degrades_then_heals(tmp_path):
    d = str(tmp_path / "pub")
    w0 = _weights()
    pub = _Publisher("port", d, w0)
    pub.snapshot(w0)
    reg = MetricRegistry()
    eng, _ = _engines(reg=reg, replica="r1")
    eng.poll_updates(d)
    bad = pub.delta(_bump(w0, 1.0))["path"]
    raw = bytearray(open(bad, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(bad, "wb").write(bytes(raw))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert eng.poll_updates(d) == []
    assert eng.degraded_reasons() == frozenset({"corrupt_stream"})
    assert reg.gauge("serve/degraded", reason="corrupt_stream",
                     replica="r1").value == 1
    assert eng.store.version == 1                  # the last good version
    with torch.no_grad():
        _assert_bit_equal(eng.predict(HOT), eng.embedding(HOT), "degraded")
    pub.snapshot([w + 2.0 for w in w0])
    assert [i["kind"] for i in eng.poll_updates(d)] == ["snapshot"]
    assert eng.degraded_reasons() == frozenset()
    assert reg.gauge("serve/degraded", reason="corrupt_stream",
                     replica="r1").value == 0
    _tables_equal(eng.store.get_weights(), pub.weights())


def test_another_models_stream_is_a_poll_error(tmp_path):
    """A failure the consumer does not classify (a stream published for
    other table shapes) reaches the engine, which counts it and keeps
    serving: ``poll_error``."""
    d = str(tmp_path / "pub")
    other = DistributedEmbedding([Embedding(10, 4, device="meta")],
                                 device="cpu")
    store = TableStore(other)
    store.commit()
    store.publish(d)
    reg = MetricRegistry()
    eng, _ = _engines(reg=reg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert eng.poll_updates(d) == []
    assert eng.degraded_reasons() == frozenset({"poll_error"})
    assert "different model" in eng.last_poll_error
    assert reg.counter("serve/poll_errors_total").value == 1
    assert reg.gauge("serve/degraded", reason="poll_error").value == 1


@pytest.mark.parametrize("err,cls", [
    (OSError("busy"), OSError),
    (StreamIntegrityError("bad crc"), StreamIntegrityError),
    (DeltaChainError("base 3"), DeltaChainError),
    (ValueError("another model"), ValueError),
    (KeyError("k"), RuntimeError)])
def test_stream_read_failures_agree_by_type(err, cls):
    """The agreement a collective apply makes before any rank writes
    (`table_store._raise_agreed`): the first failed rank's error is
    raised on every rank as its type, so every rank's consumer retries a
    transient read, quarantines a corrupt file or fails the poll alike
    (any other type agrees as a RuntimeError)."""
    msg = f"{type(err).__name__}: {err}"
    outcomes = [None, (table_store._error_kind(err), msg),
                (table_store._error_kind(OSError()), "OSError: later")]
    with pytest.raises(cls) as info:
        table_store._raise_agreed(outcomes, None)
    assert type(info.value) is cls
    assert str(info.value) == f"rank 1: {msg}"
    table_store._raise_agreed([None, None], None)


def test_stream_read_fault_writes_nothing(tmp_path, monkeypatch):
    """A collective apply (the layer's world size set to 2; with no
    process group the agreement is this rank's) whose payload read fails
    writes nothing: a corrupt delta is quarantined, the version and the
    tables stay, the engine reports ``corrupt_stream``; the other ranks'
    reads of the stream's listing and headers are rank 0's."""
    d = str(tmp_path)
    w0 = _weights()
    pub = _Publisher("pt", d, w0)
    eng, _ = _engines()
    pub.snapshot(w0)
    assert [i["kind"] for i in eng.poll_updates(d)] == ["snapshot"]
    pub.delta(_bump(w0, 1.0))
    before = eng.store.get_weights()
    real = table_store.ckpt.load_row_delta

    def damaged(path, *args, **kwargs):
        if "delta" in path:
            raise StreamIntegrityError("injected: payload crc")
        return real(path, *args, **kwargs)
    monkeypatch.setattr(table_store.ckpt, "load_row_delta", damaged)
    eng.embedding.world_size = 2
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert eng.poll_updates(d) == []
    finally:
        eng.embedding.world_size = 1
    assert eng.store.version == 1
    assert eng.degraded_reasons() == frozenset({"corrupt_stream"})
    for a, b in zip(eng.store.get_weights(), before):
        np.testing.assert_array_equal(a, b)
    assert eng.update_stats(d)["quarantined_files"] == 1


def test_query_only_manager_translates_an_offloaded_table(tmp_path):
    """A serving replica's manager may take a table of a host-offloaded
    bucket (the port's query-only role; the default set leaves it out, as
    the JAX manager does): it loads the publisher's binding and the
    cached engine serves the raw keys bit-equal to the publisher's layer;
    `maintain` refuses the table."""
    def offloaded_layer():
        return DistributedEmbedding(
            [Embedding(v, w, combiner="sum", device="meta")
             for v, w in SIZES], device="cpu", vocab_slack=16,
            gpu_embedding_size=1536)
    emb = offloaded_layer()
    (b,) = emb.offloaded_buckets
    assert 2 not in VocabManager(emb, use_native=False).vocabs
    mgr = VocabManager(emb, tables=[0, 2], use_native=False)
    with pytest.raises(ValueError, match="host-offloaded"):
        mgr.maintain()
    mgr.vocabs[0].bind([111, 222])
    mgr.vocabs[2].bind([5000, 6000, 7000])
    with torch.no_grad():
        emb.tp[b].mul_(0.0).add_(torch.arange(
            emb.tp[b].numel(), dtype=torch.float32).view(emb.tp[b].shape))
    store = TableStore(emb)
    d = str(tmp_path)
    store.commit()
    mgr.save_state(vocab_state_path(d, 1))
    store.publish(d)
    emb_c = offloaded_layer()
    mgr_c = VocabManager(emb_c, tables=[0, 2], use_native=False)
    eng = InferenceEngine(emb_c, device="cpu", vocab_manager=mgr_c,
                          cache_capacity=4, promote_threshold=1)
    assert [i["kind"] for i in eng.poll_updates(d)] == ["snapshot"]
    assert mgr_c.vocabs[2].bound == 3 and not eng.degraded_reasons()
    raw = [np.asarray([111, 222, 9, 111]), np.zeros(4, np.int64),
           np.asarray([5000, 7000, 5000, 42]), np.zeros(4, np.int64)]
    for _ in range(3):
        got = eng.predict(raw)
        with torch.no_grad():
            want = emb(mgr.translate(raw))
        _assert_bit_equal(got, want, "raw keys")
    assert eng.cache_stats()["hits"] > 0
