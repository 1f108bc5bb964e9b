"""The port's vocabulary manager against the JAX package's, at world 1.

Mirrors tests/test_vocab.py (its late-sidecar poll is ROADMAP Queue A13),
the sidecar round trip of tests/test_store.py and the quantized stash of
tests/test_store_dtype.py, on a one-device JAX mesh: on the same raw
stream the two managers give the same translations, bindings, free lists,
admissions, evictions, stash contents and state files, and `maintain`
writes the same rows, bit for bit; each package loads the other's
sidecar. JAX's recompile count becomes "no bucket or optimizer-state
tensor moves across growth" (``data_ptr`` unchanged). `fit(vocab=,
store=)` publishes rows and sidecars that a consumer layer and an engine
over raw keys serve bit-equal to the publisher, and a pipelined run equals
a serial one bit for bit. The port's binding runs both backends (the C++
map and its numpy twin) against the JAX package's numpy binding.
"""

import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu.vocab import (  # noqa: E402
    VocabManager as JaxVocabManager)
from distributed_embeddings_tpu.vocab.manager import (  # noqa: E402
    ManagedVocab as JaxManagedVocab)
from distributed_embeddings_tpu_torch import training  # noqa: E402
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.ops import wire  # noqa: E402
from distributed_embeddings_tpu_torch.ops.embedding_ops import (  # noqa: E402
    RaggedIds, SparseIds)
from distributed_embeddings_tpu_torch.serving.engine import (  # noqa: E402
    InferenceEngine)
from distributed_embeddings_tpu_torch.store import (  # noqa: E402
    DeltaConsumer, TableStore)
from distributed_embeddings_tpu_torch.utils import checkpoint  # noqa: E402
from distributed_embeddings_tpu_torch.vocab import (  # noqa: E402
    ManagedVocab, VocabManager, default_admit_threshold, latest_vocab_state,
    vocab_state_path)

SIZES = [(48, 8), (32, 8), (100, 8), (64, 8)]
NATIVE = [pytest.param(False, id="numpy"), pytest.param(True, id="native")]


def _mesh():
    return create_mesh(jax.devices()[:1])


def _layer(slack=16, sizes=SIZES, combiner="sum", **kw):
    return DistributedEmbedding(
        [Embedding(v, w, combiner=combiner, device="meta")
         for v, w in sizes], device="cpu", vocab_slack=slack, **kw)


def _jax_layer(slack=16, sizes=SIZES, combiner="sum", **kw):
    return JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner=combiner) for v, w in sizes],
        mesh=_mesh(), vocab_slack=slack, **kw)


def _weights(layer, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(c["input_dim"], c["output_dim"]).astype(np.float32)
            for c in layer.strategy.global_configs]


def _pair(slack=16, seed=0, **mgr_kw):
    """(port layer, port manager, JAX layer, JAX params, JAX manager),
    both layers holding the same weights; the port's binding backend from
    ``native`` in `mgr_kw` (the JAX one always numpy)."""
    native = mgr_kw.pop("native", False)
    port, ref = _layer(slack), _jax_layer(slack)
    weights = _weights(port, seed)
    port.set_weights(weights)
    params = ref.set_weights(weights)
    return (port, VocabManager(port, use_native=native, **mgr_kw), ref,
            params, JaxVocabManager(ref, use_native=False, **mgr_kw))


def _raw(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _assert_same_state(mgr, jmgr):
    """Bindings, free lists, counters, stash and stats equal."""
    assert sorted(mgr.vocabs) == sorted(jmgr.vocabs)
    for t, mv in mgr.vocabs.items():
        jv = jmgr.vocabs[t]
        np.testing.assert_array_equal(mv.resident_keys(),
                                      jv.resident_keys())
        np.testing.assert_array_equal(mv.binding.free_slots(),
                                      jv.binding.free_slots())
        assert list(mv.stash) == list(jv.stash)
        for k in mv.stash:
            assert _raw(mv.stash[k]) == _raw(jv.stash[k])
        ms, js = mv.state_dict(), jv.state_dict()
        assert sorted(ms) == sorted(js)
        for name in js:
            assert ms[name].dtype == js[name].dtype, name
            assert _raw(ms[name]) == _raw(js[name]), name
    assert mgr.stats() == jmgr.stats()


def _assert_same_tables(port, ref, params):
    for t, (a, b) in enumerate(zip(port.get_weights(),
                                   ref.get_weights(params))):
        assert _raw(a) == _raw(b), f"table {t}"


def test_slack_zero_is_plan_noop():
    """vocab_slack 0 plans exactly what no slack plans; a slack inflates
    every table-parallel table and its bucket as the JAX planner does."""
    base = DistributedEmbedding([Embedding(v, w, combiner="sum",
                                           device="meta")
                                 for v, w in SIZES], device="cpu")
    z = _layer(0)
    assert [b.rows for b in z.plan.tp_buckets] == \
        [b.rows for b in base.plan.tp_buckets]
    assert all(b.slack_rows == 0 for b in z.plan.tp_buckets)
    assert all("vocab_slack" not in c for c in z.strategy.global_configs)
    s, ref = _layer(8), _jax_layer(8)
    assert s.strategy.vocab_slack == 8
    assert [b.rows for b in s.plan.tp_buckets] == \
        [b.rows for b in ref.plan.tp_buckets]
    assert [b.slack_rows for b in s.plan.tp_buckets] == \
        [b.slack_rows for b in ref.plan.tp_buckets]
    for gtid in s.strategy.table_groups[1]:
        cfg = s.strategy.global_configs[gtid]
        assert cfg["input_dim"] == cfg["vocab_base_rows"] + 8
    assert [w.shape for w in s.get_weights()] == \
        [(v + 8, w) for v, w in SIZES]
    # the slack rows cross `convert` both ways, bit for bit
    from distributed_embeddings_tpu_torch import convert
    weights = _weights(s, 3)
    jparams = jax.tree.map(np.asarray, ref.set_weights(weights))
    s.load_state_dict(convert.params_from_jax(jparams, s))
    assert all(_raw(a) == _raw(b) for a, b in zip(s.get_weights(), weights))
    back = convert.params_to_numpy(s)
    assert all(_raw(a) == _raw(b) for a, b in zip(back["tp"], jparams["tp"]))


@pytest.mark.parametrize("native", NATIVE)
def test_admission_eviction_growth_cycle(native):
    """The policy loop on both managers over one raw stream: unknown keys
    ride the fallback row until their decayed count crosses the threshold;
    admitted keys get zeroed rows; drift evicts the cold tail (rows
    stashed) and occupancy never passes the high watermark; a stable
    universe does not churn. After every step the translations, bindings,
    free lists, stash, state and stats equal the JAX manager's, and the
    tables equal bit for bit."""
    port, mgr, ref, params, jmgr = _pair(
        8, admit_threshold=2, decay=0.9, high_watermark=0.5,
        low_watermark=0.25, native=native)
    rng = np.random.RandomState(0)
    raw = [rng.randint(10**9, 2 * 10**9, size=(16, 2)).astype(np.int64)
           for _ in SIZES]

    def step(batch, maintain=False):
        nonlocal params
        got = mgr.translate(batch, observe=True)
        want = jmgr.translate(batch, observe=True)
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if maintain:
            mgr.maintain()
            params, _ = jmgr.maintain(params)
        _assert_same_state(mgr, jmgr)
        return got

    t0 = step(raw, maintain=True)
    assert all((np.asarray(x) == 0).all() for x in t0)
    assert mgr.stats()["admissions"] == 0
    for _ in range(3):
        step(raw)
    mgr.maintain()
    params, _ = jmgr.maintain(params)
    _assert_same_state(mgr, jmgr)
    _assert_same_tables(port, ref, params)
    t1 = mgr.translate(raw)
    jmgr.translate(raw)
    assert any((np.asarray(x) > 0).any() for x in t1)
    rows0 = np.unique(np.asarray(t1[0]).reshape(-1))
    assert (port.get_weights()[0][rows0[rows0 > 0]] == 0).all()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(6):
            raw2 = [rng.randint(10**9, 2 * 10**9,
                                size=(16, 2)).astype(np.int64)
                    for _ in SIZES]
            for i in range(3):
                step(raw2, maintain=(i == 2))
            _assert_same_tables(port, ref, params)
            assert all(mv.occupancy <= 0.5 + 1e-9
                       for mv in mgr.vocabs.values())
    assert mgr.stats()["evictions"] > 0
    assert any(len(mv.stash) for mv in mgr.vocabs.values())

    p2, m2, r2, jp2, j2 = _pair(8, seed=1, admit_threshold=1, decay=0.9,
                                native=native)
    fixed = [rng.randint(0, 30, size=(16, 2)).astype(np.int64) + 10**9
             for _ in SIZES]
    for _ in range(6):
        m2.translate(fixed, observe=True)
        m2.maintain()
        j2.translate(fixed, observe=True)
        jp2, _ = j2.maintain(jp2)
    assert m2.stats()["evictions"] == 0
    _assert_same_state(m2, j2)
    _assert_same_tables(p2, r2, jp2)


def test_stash_restores_trained_row():
    """Evict, then re-admit: the key gets its trained row back (42.0
    written into it), not a zero row; the stash holds it meanwhile."""
    port, mgr, ref, params, jmgr = _pair(
        8, seed=1, admit_threshold=1, decay=0.9, high_watermark=0.9,
        low_watermark=0.3)
    rng = np.random.RandomState(3)
    key_a = np.full((4, 2), 777_777, np.int64)
    quiet = np.zeros((4, 2), np.int64)

    def both(batch):
        nonlocal params
        mgr.translate(batch, observe=True)
        jmgr.translate(batch, observe=True)

    both([key_a, quiet, quiet, quiet])
    mgr.maintain()
    params, _ = jmgr.maintain(params)
    row_a = int(mgr.vocabs[0].binding.lookup(np.array([777_777]))[0])
    assert row_a > 0
    w = port.get_weights()
    w[0][row_a] = 42.0
    port.set_weights(w)
    params = ref.set_weights(w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(60):
            flood = rng.randint(10**6, 10**7,
                                size=(16, 4)).astype(np.int64)
            both([flood, quiet, quiet, quiet])
            both([flood, quiet, quiet, quiet])
            mgr.maintain()
            params, _ = jmgr.maintain(params)
            if mgr.vocabs[0].binding.lookup(np.array([777_777]))[0] == 0:
                break
    assert mgr.vocabs[0].binding.lookup(np.array([777_777]))[0] == 0
    assert (mgr.vocabs[0].stash[777_777] == 42.0).all()
    for _ in range(30):
        both([key_a, quiet, quiet, quiet])
    mgr.maintain()
    params, _ = jmgr.maintain(params)
    row_a2 = int(mgr.vocabs[0].binding.lookup(np.array([777_777]))[0])
    assert row_a2 > 0
    np.testing.assert_array_equal(port.get_weights()[0][row_a2],
                                  np.full((8,), 42.0))
    _assert_same_state(mgr, jmgr)
    _assert_same_tables(port, ref, params)


def test_translate_forms_and_drop_mode():
    """Translation keeps every input form (dense, (ids, weights),
    RaggedIds, SparseIds) and the ids' dtype, equal to the JAX manager's;
    ``on_miss="drop"`` zero-weights unadmitted lanes, and the forward of
    the translated batch drops them."""
    port, mgr, ref, params, jmgr = _pair(8, admit_threshold=1)
    rows = mgr.vocabs[0].bind([111, 222])
    assert (np.asarray(jmgr.vocabs[0].bind([111, 222])) == rows).all()
    assert (np.asarray(rows) > 0).all()
    zeros = [np.zeros((2, 2), np.int64)] * 3
    dense = np.array([[111, 222], [333, 111]], np.int64)
    for batch in ([dense] + zeros, [dense.astype(np.int32)] + zeros,
                  [torch.from_numpy(dense)] + zeros):
        o = np.asarray(mgr.translate(batch)[0])
        ref_batch = [np.asarray(b) for b in batch]
        want = np.asarray(jmgr.translate(ref_batch)[0])
        assert o.dtype == want.dtype
        np.testing.assert_array_equal(o, want)
    o = np.asarray(mgr.translate([dense] + zeros)[0])
    assert o[0, 0] == rows[0] and o[0, 1] == rows[1]
    assert o[1, 0] == 0 and o[1, 1] == rows[0]
    wts = np.ones((2, 2), np.float32)
    ids_t, w_t = mgr.translate([(dense, wts)] + zeros)[0]
    np.testing.assert_array_equal(ids_t, o)
    np.testing.assert_array_equal(w_t, wts)
    rag = RaggedIds(torch.tensor([111, 333, 222], dtype=torch.int32),
                    torch.tensor([0, 2, 3], dtype=torch.int32))
    np.testing.assert_array_equal(
        np.asarray(mgr.translate([rag] + zeros)[0].values),
        [rows[0], 0, rows[1]])
    sp = SparseIds(torch.tensor([[0, 0], [1, 1]], dtype=torch.int32),
                   torch.tensor([222, 333], dtype=torch.int32), (2, 2))
    np.testing.assert_array_equal(
        np.asarray(mgr.translate([sp] + zeros)[0].values), [rows[1], 0])

    mgr_d = VocabManager(port, admit_threshold=1, use_native=False,
                         on_miss="drop")
    jmgr_d = JaxVocabManager(ref, admit_threshold=1, use_native=False,
                             on_miss="drop")
    mgr_d.vocabs[0].bind([111])
    jmgr_d.vocabs[0].bind([111])
    dense8 = np.zeros((8, 2), np.int64)
    dense8[0] = [111, 222]
    dense8[1] = [333, 444]
    batch = [dense8] + [np.zeros((8, 2), np.int64)] * 3
    ids_d, w_d = mgr_d.translate(batch)[0]
    j_ids, j_w = jmgr_d.translate(batch)[0]
    np.testing.assert_array_equal(ids_d, j_ids)
    np.testing.assert_array_equal(w_d, j_w)
    assert w_d[0, 0] == 1.0 and w_d[0, 1] == 0.0 and (w_d[1] == 0.0).all()
    port.set_weights([np.ones((c["input_dim"], c["output_dim"]),
                              np.float32)
                      for c in port.strategy.global_configs])
    with torch.no_grad():
        out = port([(ids_d, w_d)] + [np.zeros((8, 2), np.int32)] * 3)
    np.testing.assert_allclose(out[0][0].numpy(), np.ones((8,)))
    np.testing.assert_allclose(out[0][1].numpy(), np.zeros((8,)))
    with pytest.raises(ValueError, match="drop"):
        mgr_d.translate([rag] + zeros)


class _M(torch.nn.Module):
    """tests/test_vocab.py's model in the port."""

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


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_growth_moves_no_tensor(optimizer):
    """Admission, eviction and rebinding change no tensor's shape or
    storage (the JAX test's one compile per shape): every bucket and
    optimizer-state tensor keeps its ``data_ptr`` across cycles that bind,
    evict and rebind, while train steps run in between; each admitted
    slot's optimizer rows are zero right after the cycle that bound it."""
    emb = _layer(8)
    model = _M(emb)
    init, step = training.make_sparse_train_step(model, optimizer, lr=0.05)
    state = init(model)
    mgr = VocabManager(emb, admit_threshold=1, decay=0.9, use_native=False,
                       high_watermark=0.5, low_watermark=0.25)
    ptrs = [t.data_ptr() for t in emb.tp] + [
        x.data_ptr() for s in state["emb"]["tp"] for x in s
        if torch.is_tensor(x)]
    rng = np.random.RandomState(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(4):
            raw = [rng.randint(10**9, 2 * 10**9,
                               size=(16, 2)).astype(np.int64)
                   for _ in SIZES]
            for _ in range(2):
                cats = mgr.translate(raw, observe=True)
            state["emb"] = mgr.maintain(None, state["emb"])
            touched = mgr.drain_touched()
            for (_, b), keys in touched.items():
                rows_max = emb.plan.tp_buckets[b].rows_max
                for x in state["emb"]["tp"][b]:
                    if torch.is_tensor(x):
                        assert (x[keys % rows_max] == 0).all()
                assert (emb.tp[b][keys % rows_max] == 0).all()
            _, state, loss = step(model, state,
                                  np.zeros((16, 1), np.float32), cats,
                                  np.zeros((16,), np.float32))
            assert np.isfinite(float(loss))
    st = mgr.stats()
    assert st["admissions"] > 0 and st["evictions"] > 0
    assert ptrs == [t.data_ptr() for t in emb.tp] + [
        x.data_ptr() for s in state["emb"]["tp"] for x in s
        if torch.is_tensor(x)]


def _fit_run(tmp_path, name, pipelined, steps=9, raw_seed=7):
    emb = _layer(16)
    emb.set_weights(_weights(emb, 0))
    model = _M(emb)
    mgr = VocabManager(emb, admit_threshold=1, decay=0.99, use_native=False)
    rng = np.random.RandomState(raw_seed)
    batches = []
    for _ in range(steps):
        cats = [rng.randint(10**8, 10**8 + 60,
                            size=(16, 2)).astype(np.int64) for _ in SIZES]
        batches.append((np.zeros((16, 1), np.float32), cats,
                        rng.randn(16).astype(np.float32)))
    init, _ = training.make_sparse_train_step(model, "adagrad", lr=0.05)
    state = init(model)
    store = TableStore(emb, opt_states=state["emb"])
    d = str(tmp_path / name)
    _, state, hist = training.fit(
        model, batches, steps, "adagrad", lr=0.05, opt_state=state,
        vocab=mgr, vocab_every=3, store=store, publish_every=3,
        publish_dir=d, log_every=0, pipelined=pipelined)
    return emb, mgr, store, d, hist, state


def test_fit_publish_serve_roundtrip(tmp_path):
    """`fit(vocab=, store=)` on raw keys publishes rows and binding
    sidecars; a consumer layer polls the rows, a consumer manager loads
    the newest sidecar, and an engine over them serves the same raw keys
    bit-equal to the publisher's engine. The serial run (pipelined=False)
    equals the pipelined one bit for bit: losses, tables, optimizer
    state, bindings and every published file's arrays."""
    emb, mgr, store, d, hist, state = _fit_run(tmp_path, "p", True)
    assert hist["vocab_stats"]["admissions"] > 0
    assert hist["published"][0]["kind"] == "snapshot"
    assert [p["kind"] for p in hist["published"]][1:] == ["delta"] * (
        len(hist["published"]) - 1)
    assert latest_vocab_state(d) is not None
    assert os.path.exists(vocab_state_path(d, store.version))

    s_emb, s_mgr, _, sd, s_hist, s_state = _fit_run(tmp_path, "s", False)
    assert s_hist["loss"] == hist["loss"]
    for a, b in zip(s_emb.get_weights(), emb.get_weights()):
        assert _raw(a) == _raw(b)
    for a, b in zip(s_state["emb"]["tp"], state["emb"]["tp"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_same_state(s_mgr, mgr)
    assert sorted(os.listdir(sd)) == sorted(os.listdir(d))
    for name in os.listdir(d):
        _, a = checkpoint.load_row_delta(os.path.join(d, name))
        _, b = checkpoint.load_row_delta(os.path.join(sd, name))
        assert sorted(a) == sorted(b)
        assert all(_raw(a[k]) == _raw(b[k]) for k in a), name

    emb_c = _layer(16)
    cons = DeltaConsumer(TableStore(emb_c), d)
    infos = cons.poll()
    assert infos and infos[0]["kind"] == "snapshot"
    mgr_c = VocabManager(emb_c, use_native=False)
    mgr_c.load_state(latest_vocab_state(d, upto=cons.store.version))
    for t in mgr.vocabs:
        np.testing.assert_array_equal(mgr_c.vocabs[t].resident_keys(),
                                      mgr.vocabs[t].resident_keys())
    rng = np.random.RandomState(8)
    raw = [rng.randint(10**8, 10**8 + 60, size=(8, 2)).astype(np.int64)
           for _ in SIZES]
    out_c = InferenceEngine(emb_c, device="cpu",
                            vocab_manager=mgr_c).predict(raw)
    out_p = InferenceEngine(emb, device="cpu", vocab_manager=mgr).predict(raw)
    for i, (a, b) in enumerate(zip(out_p, out_c)):
        assert _raw(a.numpy()) == _raw(b.numpy()), f"output {i}"
    with pytest.raises(ValueError, match="different layer"):
        InferenceEngine(emb_c, device="cpu", vocab_manager=mgr)


def test_fit_refuses_what_the_reference_refuses():
    """The JAX `fit`'s guards: publish_every without publish_dir, vocab
    with the dense step, a manager over another layer."""
    emb = _layer(8)
    model = _M(emb)
    with pytest.raises(ValueError, match="publish_dir"):
        training.fit(model, [], 0, store=TableStore(emb), publish_every=2)
    mgr = VocabManager(emb, use_native=False)
    with pytest.raises(ValueError, match="sparse"):
        training.fit(model, [], 0, sparse=False, vocab=mgr)
    with pytest.raises(ValueError, match="different layer"):
        training.fit(model, [], 0, vocab=VocabManager(_layer(8),
                                                      use_native=False))


def test_shared_table_decays_once_per_batch():
    """A table fed by two inputs ages its counters once a batch, and its
    inputs' streams add up into one observation (the JAX numbers)."""
    emb = DistributedEmbedding(
        [Embedding(v, w, combiner="sum", device="meta") for v, w in SIZES],
        device="cpu", vocab_slack=8, input_table_map=[0, 1, 2, 3, 0])
    mgr = VocabManager(emb, admit_threshold=3, decay=0.5, use_native=False)
    key = np.full((8, 1), 123_456, np.int64)
    quiet = np.zeros((8, 1), np.int64)
    mgr.translate([key, quiet, quiet, quiet, quiet], observe=True)
    mgr.translate([key, quiet, quiet, quiet, quiet], observe=True)
    got = mgr.vocabs[0].tracker.counts_for(np.array([123_456]))[0]
    assert got == pytest.approx(12.0), got
    mgr.translate([key, quiet, quiet, quiet, key], observe=True)
    got = mgr.vocabs[0].tracker.counts_for(np.array([123_456]))[0]
    assert got == pytest.approx(22.0), got


def test_stash_is_bounded():
    """Past stash_max the oldest demotion drops (its key re-admits from
    zeros), as in the JAX manager."""
    mgr = VocabManager(_layer(8), admit_threshold=1, use_native=False,
                       stash_max=3)
    mv = mgr.vocabs[0]
    for k in range(10):
        mv.bind([1000 + k])
        mv.unbind(np.array([1000 + k]),
                  np.full((1, 8), float(k), np.float32))
    assert len(mv.stash) == 3
    assert sorted(mv.stash) == [1007, 1008, 1009]


def test_vocab_manager_rejects_bad_configs():
    emb = _layer(8)
    with pytest.raises(ValueError):
        VocabManager(emb, on_miss="nonsense")
    with pytest.raises(ValueError):
        VocabManager(emb, high_watermark=0.5, low_watermark=0.9)
    with pytest.raises(ValueError):
        VocabManager(emb, tables=[999])
    with pytest.raises(ValueError):
        VocabManager(_layer(4, combiner=None), on_miss="drop")
    emb_h = _layer(8, hot_rows=8)
    assert emb_h._hot_buckets
    with pytest.raises(ValueError, match="hot"):
        VocabManager(emb_h, tables=[0])
    with pytest.raises(ValueError, match="manageable"):
        VocabManager(emb_h)
    assert default_admit_threshold() == 2
    assert VocabManager(emb).admit_threshold == 2
    assert all(mv.stash_dtype == "f32"
               for mv in VocabManager(emb).vocabs.values())
    emb.world_size = 2
    with pytest.raises(NotImplementedError, match="single-process"):
        VocabManager(emb)


def test_replan_recommendation_logged():
    """Demand past the post-eviction capacity logs and warns the re-plan
    recommendation (raise vocab_slack)."""
    emb = _layer(0)
    logs = []
    mgr = VocabManager(emb, admit_threshold=1, decay=1.0, use_native=False,
                       tables=[1], log_fn=logs.append)
    rng = np.random.RandomState(0)
    quiet = np.zeros((4, 2), np.int64)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(3):
            flood = rng.randint(10**6, 10**7,
                                size=(64, 2)).astype(np.int64)
            mgr.translate([quiet, flood, quiet, quiet], observe=True)
            mgr.maintain()
    assert any("vocab_slack" in str(x.message) for x in w)
    assert logs and "re-plan" in logs[0]


@pytest.mark.parametrize("full", [True, False])
def test_sidecars_load_across_packages(tmp_path, full):
    """tests/test_store.py's sidecar round trip, across packages: each
    manager's saved state (the checkpoint form and the sidecar form) loads
    into the other's manager with the same bindings, free lists, counters
    and policy; the files' arrays equal; `latest_vocab_state` picks by
    version; a manager over another slack refuses the state."""
    port, mgr, ref, params, jmgr = _pair(8, admit_threshold=1, decay=0.9)
    rng = np.random.RandomState(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for r in range(4):
            raw = [rng.randint(10**8 + r * 30, 10**8 + r * 30 + 40,
                               (16, 2)).astype(np.int64) for _ in SIZES]
            mgr.translate(raw, observe=True)
            mgr.maintain()
            jmgr.translate(raw, observe=True)
            params, _ = jmgr.maintain(params)
    assert mgr.stats()["admissions"] > 0
    d = str(tmp_path)
    mgr.save_state(vocab_state_path(d, 3), full=full)
    mgr.save_state(vocab_state_path(d, 7), full=full)
    jmgr.save_state(os.path.join(d, "jax_state"), full=full)
    assert latest_vocab_state(d) == vocab_state_path(d, 7)
    assert latest_vocab_state(d, upto=5) == vocab_state_path(d, 3)
    assert latest_vocab_state(d, upto=1) is None
    m_meta, m_arr = checkpoint.load_row_delta(vocab_state_path(d, 7))
    j_meta, j_arr = checkpoint.load_row_delta(os.path.join(d,
                                                           "jax_state.npz"))
    for key in ("kind", "tables", "admit_threshold", "decay",
                "stash_dtype", "capacity"):
        assert m_meta[key] == j_meta[key], key
    assert sorted(m_arr) == sorted(j_arr)
    assert all(_raw(m_arr[k]) == _raw(j_arr[k]) for k in j_arr)

    fresh = VocabManager(port, use_native=False)
    fresh.load_state(os.path.join(d, "jax_state.npz"))
    jfresh = JaxVocabManager(ref, use_native=False)
    jfresh.load_state(vocab_state_path(d, 7))
    probe = rng.randint(10**8, 10**8 + 200, 256).astype(np.int64)
    for t in mgr.vocabs:
        for other in (fresh.vocabs[t], jfresh.vocabs[t]):
            np.testing.assert_array_equal(other.resident_keys(),
                                          mgr.vocabs[t].resident_keys())
            np.testing.assert_array_equal(other.binding.free_slots(),
                                          mgr.vocabs[t].binding.free_slots())
            np.testing.assert_array_equal(other.binding.lookup(probe),
                                          mgr.vocabs[t].binding.lookup(probe))
            if full:
                np.testing.assert_allclose(
                    other.tracker.counts_for(probe),
                    mgr.vocabs[t].tracker.counts_for(probe))
    assert fresh.admit_threshold == 1
    assert all(mv.tracker.promote_threshold == 1 and mv.tracker.decay == 0.9
               for mv in fresh.vocabs.values())
    with pytest.raises(ValueError, match="capacity"):
        VocabManager(_layer(32), use_native=False).load_state(
            latest_vocab_state(d))


# ----------------------------------------------------------- quantized stash
def test_quantized_stash_evict_readmit_and_byte_budget():
    """tests/test_store_dtype.py:461: an int8 stash parks rows at
    8 + width + 4 bytes, restores within one quantization step (bit-equal
    to the JAX stash's), and holds at least 3x the float32 tenants under
    one byte budget."""
    rng = np.random.RandomState(13)
    width = 32
    rows = rng.randn(6, width).astype(np.float32)
    kw = dict(capacity=64, base_rows=48, slack=16, admit_threshold=2,
              decay=0.99, use_native=False, stash_dtype="int8")
    mv, jv = ManagedVocab(0, **kw), JaxManagedVocab(0, **kw)
    keys = np.arange(100, 106, dtype=np.int64)
    for v in (mv, jv):
        v.bind(keys)
        v.unbind(keys, rows)
    assert mv.stash_bytes() == jv.stash_bytes() == 6 * (8 + width + 4)
    for i, k in enumerate(keys):
        back = mv.stash_take(int(k))
        assert _raw(back) == _raw(jv.stash_take(int(k)))
        bound = float(wire.store_decode_bound(rows[i], "int8").max())
        assert np.abs(back - rows[i]).max() <= bound + 1e-7
    assert mv.stash_bytes() == 0
    budget = 10 * (8 + 4 * width)
    held = {}
    for sd in ("f32", "int8"):
        m2 = ManagedVocab(0, capacity=256, base_rows=128, slack=128,
                          admit_threshold=2, decay=0.99, use_native=False,
                          stash_dtype=sd, stash_max_bytes=budget)
        ks = np.arange(1000, 1100, dtype=np.int64)
        m2.bind(ks)
        m2.unbind(ks, rng.randn(100, width).astype(np.float32))
        assert m2.stash_bytes() <= budget
        held[sd] = len(m2.stash)
    assert held["f32"] == 10
    assert held["int8"] >= 3 * held["f32"]


def test_quantized_stash_state_roundtrip(tmp_path):
    """tests/test_store_dtype.py:496: a quantized stash saves compressed
    (with its scales) and loads, in either package, at the saved dtype,
    also into a manager configured at another stash dtype."""
    rng = np.random.RandomState(17)
    specs = [(64, 8), (48, 8), (40, 8), (32, 8), (30, 8), (28, 8), (26, 8),
             (24, 8)]
    mgr = VocabManager(_layer(8, specs), use_native=False,
                       stash_dtype="int8")
    gtid = min(mgr.vocabs)
    keys = np.arange(500, 508, dtype=np.int64)
    rows = rng.randn(8, 8).astype(np.float32)
    mgr.vocabs[gtid].bind(keys)
    mgr.vocabs[gtid].unbind(keys, rows)
    path = mgr.save_state(str(tmp_path / "vocab_state"))
    assert checkpoint.load_row_delta_meta(path)["stash_dtype"] == "int8"
    bound = float(wire.store_decode_bound(rows[2], "int8", sr=True).max())
    for loader_dtype in ("int8", "f32"):
        m2 = VocabManager(_layer(8, specs), use_native=False,
                          stash_dtype=loader_dtype)
        m2.load_state(path)
        j2 = JaxVocabManager(_jax_layer(8, specs), use_native=False,
                             stash_dtype=loader_dtype)
        j2.load_state(path)
        back = m2.vocabs[gtid].stash_take(502)
        assert back is not None
        assert _raw(back) == _raw(j2.vocabs[gtid].stash_take(502))
        assert np.abs(back - rows[2]).max() <= bound + 1e-6
