"""The port's table store against the JAX package's `store`, at world 1.

Mirrors tests/test_store.py case for case (its engine streaming case runs
in tests/test_torch_serving_stream.py at world 1 and in
tests/test_torch_multigpu.py at W = 2 and 4) and the green store cases of
tests/test_store_dtype.py,
on a one-device JAX mesh, whose flat keys are the port's at world 1:
`touched_row_keys` equal to the JAX layer's, key for key; after the same
steps the published keys equal and the rows within rtol 1e-4 / atol 1e-5
(the port's training tests' table bar); streams cross-read both ways, each
consumer ending bit-equal to the other package's publisher; the chain
guards (`DeltaChainError`, the signature guard, `replace`); a flipped byte
quarantined and the chain re-anchored on the next snapshot;
`restore_from_published`; the hot overlay of `read_rows`; an offloaded
float32 bucket and int8 buckets, in host memory and on the device, read and
written bit-equal to the JAX store's; a delta re-keyed onto a consumer of
another placement (its header records the publisher's), and a table whose
column slices cannot be re-keyed refused; the producer's refusal of a world
above one, and the consumer's apply agreed across ranks.
"""

import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu.store import (  # noqa: E402
    TableStore as JaxTableStore)
from distributed_embeddings_tpu.store import (  # noqa: E402
    scan_published as jax_scan_published)
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.ops import wire  # noqa: E402
from distributed_embeddings_tpu_torch.store import (  # noqa: E402
    DeltaChainError, DeltaConsumer, TableStore, restore_from_published,
    scan_published)
from distributed_embeddings_tpu_torch.store.table_store import (  # noqa: E402
    _translate_delta, padded_gather_rows, padded_scatter_rows)
from distributed_embeddings_tpu_torch.training import (  # noqa: E402
    make_sparse_train_step)
from distributed_embeddings_tpu_torch.utils import checkpoint  # noqa: E402

SIZES = [(96, 8), (50, 8), (1000, 16), (2000, 16)]
BATCH = 16
LR = 0.1
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)


def _mesh():
    return create_mesh(jax.devices()[:1])


def _jax_layer(sizes=SIZES, combiner=None, **kw):
    return JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner=combiner) for v, w in sizes],
        mesh=_mesh(), **kw)


def _layer(sizes=SIZES, combiner=None, **kw):
    return DistributedEmbedding(
        [Embedding(v, w, combiner=combiner, device="meta")
         for v, w in sizes], device="cpu", **kw)


class _JaxModel:
    """tests/test_store.py's embedding-only model: the loss is the mean
    squared distance of the outputs' sum to the labels."""

    def __init__(self, emb):
        self.embedding = emb

    def loss_fn(self, p, numerical, cats, labels, taps=None,
                return_residuals=False):
        out = self.embedding(p["embedding"], list(cats), taps=taps,
                             return_residuals=return_residuals)
        outs, res = out if return_residuals else (out, None)
        x = jnp.concatenate([o.reshape(o.shape[0], -1) for o in outs],
                            axis=1)
        loss = jnp.mean((jnp.sum(x, axis=1) - labels.reshape(-1)) ** 2)
        return (loss, res) if return_residuals else loss


class _Model(torch.nn.Module):
    """The same model in the port."""

    def __init__(self, emb):
        super().__init__()
        self.embedding = emb

    def loss_fn(self, numerical, cats, labels, taps=None,
                return_residuals=False):
        out = self.embedding(list(cats), taps=taps,
                             return_residuals=return_residuals)
        outs, res = out if return_residuals else (out, None)
        x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], 1).float()
        labels = torch.as_tensor(labels, dtype=torch.float32)
        loss = torch.mean((x.sum(1) - labels.reshape(-1)) ** 2)
        return (loss, res) if return_residuals else loss


def _weights(seed, sizes=SIZES):
    rng = np.random.RandomState(seed)
    return [rng.randn(v, w).astype(np.float32) * 0.1 for v, w in sizes]


def _cats(rng, sizes=SIZES, k=None):
    shape = (BATCH,) if k is None else (BATCH, k)
    return [rng.randint(0, v, shape).astype(np.int32) for v, _ in sizes]


def _raw(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _assert_tables_bit_equal(got, want):
    for t, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and _raw(a) == _raw(b), f"table {t}"


# ------------------------------------------------------------ touched rows
@pytest.mark.parametrize("form", ["ids", "multi_hot", "weighted_zero",
                                  "out_of_range", "hot"])
def test_touched_row_keys_cover_update(form):
    """`touched_row_keys` equals the JAX layer's key for key (ids past
    their table and negative ids left out, zero-weight lanes and hot-hit
    lanes kept) and covers every row one adagrad step changes: rows
    outside it are bit-identical before and after."""
    rng = np.random.RandomState(0)
    kw = dict(hot_rows=8, combiner="sum") if form == "hot" else (
        dict(combiner="sum") if form != "ids" else {})
    port, ref = _layer(**kw), _jax_layer(**kw)
    port.set_weights(_weights(0))
    cats = _cats(rng, k=None if form in ("ids", "hot") else 3)
    if form == "weighted_zero":
        cats = [(c, (rng.rand(*c.shape) > 0.5).astype(np.float32))
                for c in cats]
    if form == "out_of_range":
        for c, (v, _) in zip(cats, SIZES):
            # past the bucket either way: the update drops them (an id
            # past its table but inside its bucket is a neighbour's row)
            c[0, 0], c[1, 1], c[2, 2] = -10 ** 5, v + 10 ** 5, 10 ** 6
    if form == "hot":
        keys = port.hot_keys_from_counts([np.bincount(c, minlength=v)
                                          for c, (v, _) in zip(cats, SIZES)])
        port.sync_hot_rows(new_keys=keys)
    touched = port.touched_row_keys(cats)
    want = ref.touched_row_keys([tuple(jnp.asarray(a) for a in c)
                                 if isinstance(c, tuple) else jnp.asarray(c)
                                 for c in cats])
    assert sorted(touched) == sorted(want)
    for key in want:
        assert touched[key].dtype == np.int64
        np.testing.assert_array_equal(touched[key], want[key])
    assert all(k[0] == "tp" for k in touched)

    model = _Model(port)
    init, step = make_sparse_train_step(model, "adagrad", lr=LR)
    state = init(model)
    before = [t.detach().clone() for t in port.tp]
    step(model, state, np.zeros((BATCH, 1), np.float32), cats,
         rng.randn(BATCH).astype(np.float32))
    changed_inside = 0
    for b, bk in enumerate(port.plan.tp_buckets):
        keys = touched.get(("tp", b), np.zeros((0,), np.int64))
        mask = np.zeros((port.tp[b].shape[0],), bool)
        mask[keys % max(bk.rows_max, 1)] = True
        diff = (before[b] != port.tp[b]).any(dim=1).numpy()
        assert not (diff & ~mask).any(), f"bucket {b}: untouched row moved"
        changed_inside += int((diff & mask).sum())
    assert changed_inside > 0 or form == "hot"
    bad = [np.full((BATCH,), 10 ** 6, np.int32) for _ in SIZES]
    assert port.touched_row_keys(bad) == {}


# ------------------------------------------------------- publish / consume
def _jax_publisher(weights, d, rng_seed, steps=2):
    """The JAX side of the round trip: snapshot, then `steps` adagrad steps
    each observed, committed and published. Returns (layer, params,
    store, the batches)."""
    ref = _jax_layer()
    model = _JaxModel(ref)
    init_fn, step_fn = jax_training.make_sparse_train_step(model, "adagrad",
                                                           lr=LR)
    p = {"embedding": ref.set_weights(weights)}
    s = init_fn(p)
    store = JaxTableStore(ref, p["embedding"], s["emb"])
    store.commit(p["embedding"], s["emb"])
    store.publish(d)
    rng = np.random.RandomState(rng_seed)
    batches = []
    for _ in range(steps):
        cats = _cats(rng)
        labels = rng.randn(BATCH).astype(np.float32)
        batches.append((cats, labels))
        store.observe([jnp.asarray(c) for c in cats])
        p, s, _ = step_fn(p, s, jnp.zeros((BATCH, 1)),
                          [jnp.asarray(c) for c in cats],
                          jnp.asarray(labels))
        store.commit(p["embedding"], s["emb"])
        store.publish(d)
    return ref, p, store, batches


def test_store_publish_consume_roundtrip(tmp_path):
    """Train, publish, consume (tests/test_store.py's case): a snapshot
    and chained deltas reproduce the live tables bit for bit; versions are
    monotonic and per table; replaying a consumed delta raises;
    `restore_from_published` rebuilds from the snapshot and the deltas; a
    consumer off the chain recovers from a forced snapshot alone. Against
    the JAX publisher on the same weights and batches: the same files, the
    same keys in every delta, the rows within TABLE_TOL."""
    weights = _weights(1)
    port = _layer()
    port.set_weights(weights)
    model = _Model(port)
    init, step = make_sparse_train_step(model, "adagrad", lr=LR)
    state = init(model)
    store = TableStore(port, opt_states=state["emb"])
    d = str(tmp_path / "stream")
    assert store.version == 0 and store.table_versions == [0] * len(SIZES)
    store.commit(None, state["emb"])
    info0 = store.publish(d)
    assert info0["kind"] == "snapshot" and info0["version"] == 1
    with pytest.raises(ValueError, match="nothing committed"):
        store.publish(d)

    consumer = _layer()
    consumer.set_weights([np.zeros_like(w) for w in weights])
    cstore = TableStore(consumer)
    cons = DeltaConsumer(cstore, d)
    assert [i["kind"] for i in cons.poll()] == ["snapshot"]

    jd = str(tmp_path / "jax_stream")
    ref, jp, jstore, batches = _jax_publisher(weights, jd, rng_seed=11)
    versions = [cstore.version]
    delta_infos = []
    for cats, labels in batches:
        store.observe(cats)
        _, state, _ = step(model, state, np.zeros((BATCH, 1), np.float32),
                           cats, labels)
        store.commit(None, state["emb"])
        delta_infos.append(store.publish(d))
    applied = cons.poll()
    assert [i["kind"] for i in applied] == ["delta", "delta"]
    versions += [i["version"] for i in applied]
    assert versions == sorted(versions) and len(set(versions)) == 3
    stats = cons.stats()
    assert stats["version_monotonic"] and stats["applied"] == 3
    assert stats["rows_applied"] > 0 and stats["delta_bytes_total"] > 0
    _assert_tables_bit_equal(consumer.get_weights(), port.get_weights())
    assert max(i["bytes"] for i in delta_infos) \
        < 0.1 * store.full_table_bytes()

    # against the JAX publisher: the same stream, key for key
    assert [(v, k) for v, k, _ in scan_published(d)] == \
        [(v, k) for v, k, _ in jax_scan_published(jd)]
    for (_, _, mine), (_, _, theirs) in zip(scan_published(d),
                                            jax_scan_published(jd)):
        m_meta, m_arr = checkpoint.load_row_delta(mine)
        j_meta, j_arr = checkpoint.load_row_delta(theirs)
        for key in ("kind", "version", "base_version", "sig", "dtype"):
            assert m_meta[key] == j_meta[key], key
        assert sorted(m_arr) == sorted(j_arr)
        for name in j_arr:
            if name.endswith("_keys"):
                np.testing.assert_array_equal(m_arr[name], j_arr[name])
            else:
                np.testing.assert_allclose(m_arr[name], j_arr[name],
                                           **TABLE_TOL, err_msg=name)

    with pytest.raises(DeltaChainError):
        cstore.apply_published(delta_infos[0]["path"])
    assert all(v == store.version for v in store.table_versions)

    rlayer = _layer()
    rstore = restore_from_published(rlayer, d)
    assert rstore.version == store.version
    _assert_tables_bit_equal(rlayer.get_weights(), port.get_weights())

    store.commit(None, touched=port.touched_row_keys(
        [np.zeros((4,), np.int32) for _ in SIZES]))
    snap = store.publish(d, force_snapshot=True)
    for di in delta_infos:
        os.remove(di["path"])
    lost_layer = _layer()
    lost = TableStore(lost_layer)
    lost.version = 2                              # mid-chain orphan
    out = DeltaConsumer(lost, d).poll()
    assert [i["kind"] for i in out] == ["snapshot"]
    assert lost.version == snap["version"]
    _assert_tables_bit_equal(lost_layer.get_weights(), port.get_weights())
    assert len(scan_published(d)) == 2


@pytest.mark.parametrize("dtype", ["f32", "int8", "fp8"])
def test_streams_cross_read_both_ways(tmp_path, dtype):
    """A JAX-published stream (snapshot and two deltas at `dtype`) applied
    by the port's consumer, and a port-published one applied by the JAX
    consumer: each consumer ends bit-equal to the other package's
    consumer of the same stream, and at f32 to its publisher's
    `get_weights`; at int8 / fp8 within one decode of it."""

    def jax_consume(directory):
        layer = _jax_layer()
        jcons = JaxTableStore(layer, layer.set_weights(
            [np.zeros_like(w) for w in weights]))
        for _, _, path in jax_scan_published(directory):
            jcons.apply_published(path)
        return jcons.get_weights()

    def port_consume(directory):
        layer = _layer()
        cons = DeltaConsumer(TableStore(layer), directory)
        assert [i["kind"] for i in cons.poll()] == ["snapshot", "delta",
                                                     "delta"]
        return layer.get_weights()

    def near(got, publisher):
        if dtype == "f32":
            _assert_tables_bit_equal(got, publisher)
            return
        for a, b in zip(got, publisher):
            bound = wire.store_decode_bound(b, dtype)
            assert (np.abs(a - b).max(axis=1) <= bound + 1e-6).all()

    weights = _weights(2)
    jd = str(tmp_path / "jax")
    ref = _jax_layer()
    model = _JaxModel(ref)
    init_fn, step_fn = jax_training.make_sparse_train_step(model, "adagrad",
                                                           lr=LR)
    p = {"embedding": ref.set_weights(weights)}
    s = init_fn(p)
    jstore = JaxTableStore(ref, p["embedding"], s["emb"], delta_dtype=dtype)
    jstore.commit(p["embedding"], s["emb"])
    jstore.publish(jd)
    rng = np.random.RandomState(5)
    for _ in range(2):
        cats = [jnp.asarray(c) for c in _cats(rng)]
        jstore.observe(cats)
        p, s, _ = step_fn(p, s, jnp.zeros((BATCH, 1)), cats,
                          jnp.asarray(rng.randn(BATCH).astype(np.float32)))
        jstore.commit(p["embedding"], s["emb"])
        jstore.publish(jd)
    got = port_consume(jd)
    _assert_tables_bit_equal(got, jax_consume(jd))
    near(got, jstore.get_weights())

    port = _layer()
    port.set_weights(weights)
    pmodel = _Model(port)
    init, step = make_sparse_train_step(pmodel, "adagrad", lr=LR)
    state = init(pmodel)
    store = TableStore(port, opt_states=state["emb"], delta_dtype=dtype)
    pd = str(tmp_path / "port")
    store.commit()
    store.publish(pd)
    for _ in range(2):
        cats = _cats(rng)
        store.observe(cats)
        _, state, _ = step(pmodel, state, np.zeros((BATCH, 1), np.float32),
                           cats, rng.randn(BATCH).astype(np.float32))
        store.commit(None, state["emb"])
        store.publish(pd)
    got = jax_consume(pd)
    _assert_tables_bit_equal(got, port_consume(pd))
    near(got, port.get_weights())


def test_store_sig_guard_and_replace(tmp_path):
    """A stream of another model is refused; `replace` breaks the chain
    (every table's version moves, the next publish snapshots)."""
    port = _layer()
    port.set_weights(_weights(2))
    store = TableStore(port)
    d = str(tmp_path / "s")
    store.commit()
    store.publish(d)
    store.commit(touched={("tp", 0): np.arange(4)})
    info = store.publish(d)
    assert info["kind"] == "delta"

    other = DistributedEmbedding([Embedding(7, 4, device="meta")],
                                 device="cpu")
    with pytest.raises(ValueError, match="different model"):
        TableStore(other).apply_published(info["path"])
    store.replace()
    assert all(v == store.version for v in store.table_versions)
    assert store.publish(d)["kind"] == "snapshot"
    with pytest.raises(ValueError, match="holds its own tables"):
        TableStore(port, params={})


def test_chain_broken_consumer_resyncs_from_a_snapshot(tmp_path):
    """An out-of-band `set_weights` on a consumer breaks its chain: a
    delta whose base version aliases the consumer's bumped version is
    refused, and a poll re-anchors on the newest snapshot and replays the
    deltas after it."""
    port = _layer()
    port.set_weights(_weights(3))
    prod = TableStore(port)
    d = str(tmp_path / "s")
    prod.commit()
    prod.publish(d)
    consumer = _layer()
    cstore = TableStore(consumer)
    cons = DeltaConsumer(cstore, d)
    cons.poll()
    assert cstore.version == 1
    cstore.set_weights(_weights(4))              # bumps to 2, chain broken
    prod.commit(touched={("tp", 0): np.arange(6)})
    aliasing = prod.publish(d)                   # v2, base 1
    prod.commit(touched={("tp", 1): np.arange(6)})
    prod.publish(d)                              # v3, base 2 == cstore
    with pytest.raises(DeltaChainError, match="out of band"):
        cstore.apply_published(os.path.join(
            d, "stream_v00000003_delta.npz"))
    assert aliasing["kind"] == "delta"
    assert [i["kind"] for i in cons.poll()] == ["snapshot", "delta",
                                                 "delta"]
    _assert_tables_bit_equal(consumer.get_weights(), port.get_weights())


def test_flipped_byte_is_quarantined(tmp_path):
    """A delta with one flipped payload byte is quarantined (counted, one
    warning, never applied); the consumer reports ``corrupt_stream`` until
    the publisher's next snapshot re-anchors it, then ends bit-equal."""
    port = _layer()
    port.set_weights(_weights(5))
    prod = TableStore(port)
    d = str(tmp_path / "s")
    prod.commit()
    prod.publish(d)
    consumer = _layer()
    cstore = TableStore(consumer)
    cons = DeltaConsumer(cstore, d)
    cons.poll()
    with torch.no_grad():
        port.tp[0][:3] += 1.0
    prod.commit(touched={("tp", 0): np.arange(3)})
    bad = prod.publish(d)["path"]
    raw = bytearray(open(bad, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(bad, "wb").write(bytes(raw))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert cons.poll() == []
    assert cons.stats()["quarantined_files"] == 1
    assert cons.degraded_reasons() == frozenset({"corrupt_stream"})
    assert cstore._metrics.counter("store/corrupt_files_total").value == 1
    prod.commit(touched={("tp", 0): np.arange(3)})
    prod.publish(d, force_snapshot=True)
    assert [i["kind"] for i in cons.poll()] == ["snapshot"]
    assert cons.degraded_reasons() == frozenset()
    _assert_tables_bit_equal(consumer.get_weights(), port.get_weights())


def test_transient_read_errors_retry_then_give_up(tmp_path, monkeypatch):
    """An `OSError` on read is retried with capped backoff and, when it
    persists, the file is left for the next poll (``io_transient``)."""
    port = _layer()
    port.set_weights(_weights(6))
    prod = TableStore(port)
    d = str(tmp_path / "s")
    prod.commit()
    prod.publish(d)
    cstore = TableStore(_layer())
    cons = DeltaConsumer(cstore, d, retry_backoff_s=0.0)
    real = checkpoint.load_row_delta
    monkeypatch.setattr(checkpoint, "load_row_delta",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("flaky")))
    assert cons.poll() == []
    assert cons.stats()["poll_retries"] == cons.max_transient_retries
    assert cons.degraded_reasons() == frozenset({"io_transient"})
    monkeypatch.setattr(checkpoint, "load_row_delta", real)
    assert [i["kind"] for i in cons.poll()] == ["snapshot"]
    assert cons.degraded_reasons() == frozenset()


def test_consistency_seam_single_source():
    """`read_rows` and `get_weights` agree on hot-resident rows (one
    source, `hot_resident_rows`), the canonical copy lags them while
    resident, `sync_hot_rows` through the store leaves the merged view
    unchanged, and a consumer with resident hot rows refuses deltas; the
    merged rows equal the JAX store's `read_rows` on the same state."""
    vocab, width, batch = 500, 8, 32
    rng = np.random.RandomState(3)
    emb = DistributedEmbedding([Embedding(vocab, width, combiner="sum",
                                          device="meta")], device="cpu",
                               hot_rows=16)
    model = _Model(emb)
    init, step = make_sparse_train_step(model, "adagrad", lr=LR)
    state = init(model)
    store = TableStore(emb, opt_states=state["emb"])
    warm = (rng.zipf(1.3, size=(batch, 2)) % vocab).astype(np.int32)
    emb.observe_hot_ids([warm])
    v0 = store.version
    store.sync_hot_rows(admit=True)
    assert store.version == v0 + 1
    state["emb"] = store.opt_states
    for _ in range(2):
        cats = [(rng.zipf(1.3, size=(batch, 2)) % vocab).astype(np.int32)]
        _, state, _ = step(model, state, np.zeros((batch, 1), np.float32),
                           cats, rng.randn(batch).astype(np.float32))
    store.commit(None, state["emb"])
    keys, rows = emb.hot_resident_rows()[0]
    assert len(keys) > 0
    np.testing.assert_array_equal(store.read_rows(0, keys), rows)
    rows_max = max(emb.plan.tp_buckets[0].rows_max, 1)
    np.testing.assert_array_equal(emb.get_weights()[0][keys % rows_max],
                                  rows)
    canonical = emb.tp[0].detach().numpy()[keys % rows_max]
    assert not np.array_equal(canonical, rows)

    before = store.read_rows(0, keys)
    store.sync_hot_rows()
    np.testing.assert_array_equal(store.read_rows(0, keys), before)
    np.testing.assert_array_equal(
        emb.tp[0].detach().numpy()[keys % rows_max], rows)
    # the JAX store's versioned read of the same (now canonical) tables
    ref = JaxDistributedEmbedding([JaxEmbedding(vocab, width,
                                                combiner="sum")],
                                  mesh=_mesh(), hot_rows=16)
    jstore = JaxTableStore(ref, ref.set_weights(emb.get_weights()))
    assert _raw(jstore.read_rows(0, keys)) == _raw(store.read_rows(0, keys))

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        store.commit(touched={("tp", 0): np.arange(4)})
        store.publish(d)
        store.commit(touched={("tp", 0): np.arange(4)})
        info = store.publish(d)
        assert info["kind"] == "delta"
        hot_consumer = TableStore(emb)
        hot_consumer.version = info["base_version"]
        with pytest.raises(ValueError, match="EMPTY hot set"):
            hot_consumer.apply_published(info["path"])


def test_row_helpers_keep_the_jax_contract():
    """`padded_gather_rows` clips its indices; `padded_scatter_rows` drops
    the lanes whose world index is out of range, writes in place and
    takes an fp8 payload as its bytes."""
    table = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    got = padded_gather_rows(table, np.array([0, 0, 3]),
                             np.array([1, 12, -4]))
    np.testing.assert_array_equal(got.numpy(), table.numpy()[[1, 9, 0]])
    padded_scatter_rows(table, np.array([0, 1, -1, 0]),
                        np.array([2, 3, 4, 5]),
                        np.full((4, 2), -1.0, np.float32))
    assert (table[2] == -1).all() and (table[5] == -1).all()
    assert (table[3] != -1).all() and (table[4] != -1).all()
    fp8 = torch.zeros((4, 3), dtype=torch.float8_e4m3fn)
    payload, _ = wire.encode_rows_np(np.ones((2, 3), np.float32), "fp8")
    padded_scatter_rows(fp8, np.zeros(2), np.array([1, 3]), payload)
    np.testing.assert_array_equal(
        padded_gather_rows(fp8, np.zeros(2), np.array([1, 3]))
        .view(torch.uint8).numpy(), payload)


# ------------------------------------------------------------ storage dtypes
QSPECS = [(4000, 32, "sum")] + [(100 + i, 32, "sum") for i in range(7)]
MIXED_BUDGET = 4000


def _qlayer(storage_dtype, specs=QSPECS, budget=None):
    return DistributedEmbedding(
        [Embedding(v, w, combiner=c, device="meta") for v, w, c in specs],
        device="cpu", gpu_embedding_size=budget,
        storage_dtype=storage_dtype)


def _jax_qlayer(storage_dtype, specs=QSPECS, budget=None):
    return JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner=c) for v, w, c in specs],
        mesh=_mesh(), gpu_embedding_size=budget,
        storage_dtype=storage_dtype)


def _qweights(rng, specs=QSPECS):
    return [rng.randn(v, w).astype(np.float32) * 0.1 for v, w, _ in specs]


def _qinputs(rng, specs=QSPECS, k=2):
    return [rng.randint(0, v, size=(BATCH, k)).astype(np.int32)
            for v, _, _ in specs]


@pytest.mark.parametrize("dtype", ["f32", "int8", "fp8"])
def test_publish_consume_parity_and_byte_model(dtype, tmp_path):
    """tests/test_store_dtype.py:264 on the port, width 128 with an
    offloaded float32 bucket: the payload bytes equal the byte model on
    both kinds, the consumer's tables equal the publisher's at f32 and
    within one decode at int8 / fp8, the quantized payloads at least 3.5x
    smaller; every file's arrays bit-equal to the JAX store's on the same
    weights and touched keys."""
    specs = [(1500, 128, "sum")] + [(80 + i, 128, "sum") for i in range(7)]
    rng = np.random.RandomState(5)
    weights = _qweights(rng, specs)
    ins = _qinputs(rng, specs)
    emb = _qlayer("f32", specs, budget=3000 * 40)
    assert emb.offloaded_buckets
    emb.set_weights(weights)
    store = TableStore(emb, delta_dtype=dtype)
    d = str(tmp_path / dtype)
    snap = store.publish(d)
    store.observe(ins)
    store.commit()
    delta = store.publish(d)
    assert checkpoint.load_row_delta_meta(snap["path"])["dtype"] == dtype
    assert snap["payload_bytes"] == snap["model_payload_bytes"]
    assert delta["payload_bytes"] == delta["model_payload_bytes"]
    con_layer = _qlayer("f32", specs, budget=3000 * 40)
    con = TableStore(con_layer)
    for _, _, path in scan_published(d):
        con.apply_published(path)
    errs = [float(np.abs(a - b).max()) for a, b in
            zip(store.get_weights(), con.get_weights())]
    if dtype == "f32":
        assert max(errs) == 0.0
    else:
        for e, w in zip(errs, weights):
            assert e <= float(wire.store_decode_bound(w, dtype).max()) + 1e-6
    # the JAX store on the same weights and keys writes the same arrays
    ref = _jax_qlayer("f32", specs, budget=3000 * 40)
    jstore = JaxTableStore(ref, ref.set_weights(weights), delta_dtype=dtype)
    jd = str(tmp_path / f"jax_{dtype}")
    jstore.publish(jd)
    jstore.observe([jnp.asarray(c) for c in ins])
    jstore.commit(jstore.params)
    jstore.publish(jd)
    for (_, _, mine), (_, _, theirs) in zip(scan_published(d),
                                            jax_scan_published(jd)):
        _, m_arr = checkpoint.load_row_delta(mine)
        _, j_arr = checkpoint.load_row_delta(theirs)
        assert sorted(m_arr) == sorted(j_arr)
        for name in j_arr:
            assert _raw(m_arr[name]) == _raw(j_arr[name]), name
    if dtype != "f32":
        emb2 = _qlayer("f32", specs, budget=3000 * 40)
        emb2.set_weights(weights)
        st32 = TableStore(emb2)
        d32 = str(tmp_path / "base_f32")
        snap32 = st32.publish(d32)
        st32.observe(ins)
        st32.commit()
        delta32 = st32.publish(d32)
        assert snap32["payload_bytes"] / snap["payload_bytes"] >= 3.5
        assert delta32["payload_bytes"] / delta["payload_bytes"] >= 3.5


def test_quantized_table_storage_through_store_reads():
    """tests/test_store_dtype.py:316: `read_rows` decodes int8 buckets in
    host memory and on the device, bit-equal to the JAX store's read; a
    write through the apply seam re-encodes (round to nearest even), payload
    and scale bit-equal to the JAX store's, and reads back within one
    more step."""
    from distributed_embeddings_tpu_torch.store.table_store import (
        _set_bucket_rows)
    rng = np.random.RandomState(11)
    weights = _qweights(rng)
    emb = _qlayer("int8", budget=MIXED_BUDGET)
    off = [b for b in emb.quantized_buckets
           if emb.plan.tp_buckets[b].offload]
    hbm = [b for b in emb.quantized_buckets
           if not emb.plan.tp_buckets[b].offload]
    assert off and hbm
    emb.set_weights(weights)
    ref = _jax_qlayer("int8", budget=MIXED_BUDGET)
    assert [bk.offload for bk in ref.plan.tp_buckets] == \
        [bk.offload for bk in emb.plan.tp_buckets]
    jstore = JaxTableStore(ref, ref.set_weights(weights))
    store = TableStore(emb)
    keys = np.arange(0, 64, dtype=np.int64)
    for b in (off[0], hbm[0]):
        assert _raw(store.read_rows(b, keys)) == \
            _raw(jstore.read_rows(b, keys))
    b0 = off[0]
    bound = float(wire.store_decode_bound(weights[0][:64], "int8").max())
    assert np.abs(store.read_rows(b0, keys) - weights[0][:64]).max() \
        <= bound + 1e-6
    for b in (off[0], hbm[0]):
        new_rows = rng.randn(8, 32).astype(np.float32) * 0.1
        _set_bucket_rows(emb, b, keys[:8], new_rows)
        table, scale = jstore._apply_tp_rows(b, keys[:8], new_rows)
        jstore._params["tp"][b] = table
        jstore._params["tp_scale"][b] = scale
        assert _raw(store.read_rows(b, keys)) == \
            _raw(jstore.read_rows(b, keys))
        got = store.read_rows(b, keys[:8])
        b2 = float(wire.store_decode_bound(new_rows, "int8").max())
        assert np.abs(got - new_rows).max() <= b2 + 1e-6
    assert emb.tp[hbm[0]].dtype == torch.int8


def test_publish_consume_through_quantized_hbm_bucket(tmp_path):
    """tests/test_store_dtype.py:365: producer and consumer hold int8
    buckets (one in host memory, one on the device); the stream decodes
    from the producer's and re-encodes into the consumer's, whose payloads
    stay 1-byte and whose decoded weights land within one rounding of the
    producer's, bit-equal to the JAX consumer's on the same stream."""
    rng = np.random.RandomState(23)
    weights = _qweights(rng)
    emb = _qlayer("int8", budget=MIXED_BUDGET)
    emb.set_weights(weights)
    store = TableStore(emb)
    d = str(tmp_path / "hbm_stream")
    store.commit()
    store.publish(d)
    store.observe(_qinputs(rng))
    store.commit()
    store.publish(d)
    c_emb = _qlayer("int8", budget=MIXED_BUDGET)
    con = TableStore(c_emb)
    for _, _, path in scan_published(d):
        con.apply_published(path)
    for b in c_emb.quantized_buckets:
        assert c_emb.tp[b].element_size() == 1
    for a, c in zip(store.get_weights(), con.get_weights()):
        bound = float(wire.store_decode_bound(a, "int8").max())
        assert np.abs(a - c).max() <= bound + 1e-6
    ref = _jax_qlayer("int8", budget=MIXED_BUDGET)
    jcon = JaxTableStore(ref, ref.init(jax.random.PRNGKey(7)))
    for _, _, path in jax_scan_published(d):
        jcon.apply_published(path)
    _assert_tables_bit_equal(con.get_weights(), jcon.get_weights())


def test_offloaded_float32_bucket_applies_through_the_host_seam(tmp_path):
    """A delta into an offloaded float32 bucket writes the host buffer in
    place (`host_apply_rows_inplace`, kind "set"): the tensor stays the
    same storage and ends bit-equal to the publisher's."""
    rng = np.random.RandomState(31)
    weights = _qweights(rng)
    emb = _qlayer("f32", budget=MIXED_BUDGET)
    emb.set_weights(weights)
    store = TableStore(emb)
    d = str(tmp_path / "s")
    store.commit()
    store.publish(d)
    c_emb = _qlayer("f32", budget=MIXED_BUDGET)
    b0 = c_emb.offloaded_buckets[0]
    ptr = c_emb.tp[b0].data_ptr()
    con = DeltaConsumer(TableStore(c_emb), d)
    con.poll()
    with torch.no_grad():
        emb.tp[b0][:5] *= 2.0
    store.commit(touched={("tp", b0): np.arange(5)})
    store.publish(d)
    assert [i["kind"] for i in con.poll()] == ["delta"]
    assert c_emb.tp[b0].data_ptr() == ptr
    _assert_tables_bit_equal(c_emb.get_weights(), emb.get_weights())


def test_delta_rekeyed_onto_another_placement(tmp_path):
    """A delta's bucket keys mean rows only under its publisher's
    placement, which its header records (``meta["plan"]``): a consumer
    whose layer places the tables otherwise (here the two 16-wide tables
    in a host-offloaded bucket of their own, against one fused bucket a
    width) re-keys the rows onto its own buckets and ends bit-equal to
    the publisher at every version, and so do its cached serving's slots;
    a consumer of the same placement applies the keys as they are."""
    rng = np.random.RandomState(41)
    pub = _layer(combiner="sum")
    pub.set_weights(_weights(3))
    store = TableStore(pub)
    d = str(tmp_path)
    store.commit()
    store.publish(d)
    other = _layer(combiner="sum", gpu_embedding_size=1000)
    assert len(other.tp) != len(pub.tp) and other.offloaded_buckets
    same = _layer(combiner="sum")
    from distributed_embeddings_tpu_torch.serving import InferenceEngine
    eng = InferenceEngine(other, device="cpu", cache_capacity=64,
                          promote_threshold=1)
    cons = DeltaConsumer(TableStore(same), d)
    cats = _cats(rng)
    for step in range(3):
        assert eng.poll_updates(d) and cons.poll()
        _assert_tables_bit_equal(other.get_weights(), pub.get_weights())
        _assert_tables_bit_equal(same.get_weights(), pub.get_weights())
        got = eng.predict(cats)
        with torch.no_grad():
            want = pub(cats)
        for a, b in zip(got, want):
            assert torch.equal(a, b), step
        with torch.no_grad():
            for t in pub.tp:
                t[:7] += 0.5 + step
        store.commit(touched=pub.touched_row_keys(
            [np.arange(7, dtype=np.int32)] * len(SIZES)))
        assert store.publish(d)["kind"] == "delta"
    assert [i["kind"] for i in eng.poll_updates(d)] == ["delta"]
    _assert_tables_bit_equal(other.get_weights(), pub.get_weights())
    assert eng.cache_stats()["hits"] > 0
    assert all(c.patched for c in eng.caches.values())


def test_delta_rekeying_refuses_split_columns():
    """A table whose columns the consumer holds across two of the
    publisher's column slices cannot be re-keyed row by row."""
    emb = _layer(sizes=[(20, 8), (30, 8)], combiner="sum")
    # the publisher's: table 0 in two 4-wide column slices (bucket 0),
    # table 1 whole (bucket 1)
    plan = {"tp": [[0, 0, 0, 20, 0, 0, 4], [0, 0, 20, 20, 0, 4, 8],
                   [1, 0, 0, 30, 1, 0, 8]], "rows_max": [40, 30]}
    out = _translate_delta(emb, plan, {("tp", 1): (
        np.asarray([3], np.int64), np.ones((1, 8), np.float32))})
    (kind, b), (keys, rows) = next(iter(out.items()))
    assert kind == "tp" and rows.shape == (1, 8)
    assert keys[0] == emb.plan.tp_placements[1].row_offset + 3
    with pytest.raises(ValueError, match="column slices"):
        _translate_delta(emb, plan, {("tp", 0): (
            np.asarray([1], np.int64), np.ones((1, 4), np.float32))})


def test_producer_refuses_a_world_above_one():
    """The producer is single-process: at world size > 1 `observe`,
    `publish` and `read_rows` raise; `apply_published` is collective
    there, and a file no rank can read raises the first rank's error type
    on every rank (the W = 2 spawn of tests/test_torch_multigpu.py runs
    both in a real process group)."""
    emb = _layer()
    store = TableStore(emb)
    emb.world_size = 2
    for call in (lambda: store.observe(_cats(np.random.RandomState(0))),
                 lambda: store.publish("unused"),
                 lambda: store.read_rows(0, np.arange(2))):
        with pytest.raises(NotImplementedError, match="single-process"):
            call()
    with pytest.raises(OSError, match="^rank 0: FileNotFoundError"):
        store.apply_published("unused")
    assert store.version == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        emb.world_size = 1
        assert store.commit() == 1
