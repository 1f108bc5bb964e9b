"""Hot-row replication in the port against the JAX package's, at world 1.

The port's `HotnessTracker` (its own copy) against the JAX package's on
the same observation sequences: slots, top keys, stats, admission plans.
`sorted_member_positions` against the JAX package's. The hot split's
forward and its sparse steps (sgd, adagrad and adam; weighted and
unweighted inputs, a mean table, invalid and negative ids) against the
JAX layer on one device, from the same weights and the same admitted keys:
losses at rtol 1e-5 / atol 1e-6, tables, hot rows and optimizer state at
rtol 1e-4 / atol 1e-5, the JAX package's own hot-parity bars
(tests/test_hotrows.py); the same steps against the port's hot-less step;
an empty hot set as the identity; lazy adam leaving a hit's canonical row
untouched; `sync_hot_rows` then `get_weights` equal to the overlaid dump;
`fit(hot_sync_every=)`, `convert` of a hot tree and state, resume files
and the engine. The W = 2 cases (the bf16 wire with hot rows) ride
tests/test_torch_wire.py's spawns.
"""

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
from distributed_embeddings_tpu.ops import (  # noqa: E402
    embedding_ops as jax_ops)
from distributed_embeddings_tpu.utils.hotness import (  # noqa: E402
    HotnessTracker as JaxTracker)
from distributed_embeddings_tpu_torch import convert  # noqa: E402
from distributed_embeddings_tpu_torch import training as pt_training  # noqa: E402
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.ops import (  # noqa: E402
    embedding_ops, sparse_update)
from distributed_embeddings_tpu_torch.serving.engine import (  # noqa: E402
    InferenceEngine)
from distributed_embeddings_tpu_torch.utils import checkpoint  # noqa: E402
from distributed_embeddings_tpu_torch.utils.hotness import (  # noqa: E402
    HotnessTracker)

BATCH = 16
HOT = 8
LR = 0.05
STEPS = 3
ADMIT_AT = 1
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
SPECS = [(40, 4, "sum"), (60, 8, "sum"), (30, 4, "sum"), (50, 8, "mean")]


def _jax_layer(specs=SPECS, **kw):
    return JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner=c) for v, w, c in specs], **kw)


def _layer(specs=SPECS, **kw):
    return DistributedEmbedding(
        [Embedding(v, w, combiner=c, device="meta") for v, w, c in specs],
        device="cpu", **kw)


class _JaxModel:
    """The JAX package's hot-row test model: the loss is the mean squared
    distance of the outputs' sum to the labels."""

    def __init__(self, specs=SPECS, **kw):
        self.embedding = _jax_layer(specs, **kw)

    def loss_fn(self, params, numerical, cats, labels, taps=None,
                return_residuals=False):
        out = self.embedding(params["embedding"], list(cats), taps=taps,
                             return_residuals=return_residuals)
        outs, res = out if return_residuals else (out, None)
        x = jnp.concatenate([o.reshape(o.shape[0], -1) for o in outs],
                            axis=1).astype(jnp.float32)
        loss = jnp.mean((jnp.sum(x, axis=1) - labels.reshape(-1)) ** 2)
        return (loss, res) if return_residuals else loss


class _Model(torch.nn.Module):
    """The same model in the port."""

    def __init__(self, specs=SPECS, **kw):
        super().__init__()
        self.embedding = _layer(specs, **kw)

    def loss_fn(self, numerical, cats, labels, taps=None,
                return_residuals=False):
        out = self.embedding(list(cats), taps=taps,
                             return_residuals=return_residuals)
        outs, res = out if return_residuals else (out, None)
        x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], 1).float()
        labels = torch.as_tensor(labels, dtype=torch.float32)
        loss = torch.mean((x.sum(1) - labels.reshape(-1)) ** 2)
        return (loss, res) if return_residuals else loss


def _weights(specs=SPECS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(v, w).astype(np.float32) * 0.1 for v, w, _ in specs]


def _cats(rng, specs=SPECS, weighted=False, invalid=None):
    """Zipf ids at hotness 2 (the JAX test's draw, its tail past the
    table redrawn uniformly, so the last row is not hot); with
    `weighted`, weights in [0.5, 1.5). `invalid` "bucket": ids past their
    table or negative that still land inside their bucket once the
    table's row offset is added (SPECS' tables 0 and 2 share a bucket),
    where both packages read the same row; "outside": negative ids and
    ids past the bucket in every input, which the port's lookups clamp
    into the bucket (the kernels' contract) and the JAX package's XLA
    route on the CPU wraps or fills; "past": ids past the bucket only."""
    cats = []
    for t, (v, _, _) in enumerate(specs):
        ids = rng.zipf(1.3, size=(BATCH, 2)) - 1
        tail = ids >= v
        ids[tail] = rng.randint(0, v, size=int(tail.sum()))
        ids = ids.astype(np.int32)
        if invalid == "outside":
            ids[0, 0], ids[1, 1], ids[2, 0] = -1000, 1000 + v, -1 - v - 1000
        elif invalid == "past":
            ids[1, 1], ids[4, 0] = 1000 + v, 2000 + v
        elif invalid == "bucket" and t == 0:
            ids[0, 0], ids[3, 1] = v + 3, v + 7
        elif invalid == "bucket" and t == 2:
            ids[1, 1], ids[2, 0] = -1, -5
        if weighted:
            cats.append((ids, (rng.rand(BATCH, 2) + 0.5).astype(np.float32)))
        else:
            cats.append(ids)
    return cats


def _jax_cats(cats):
    return [(jnp.asarray(c[0]), jnp.asarray(c[1])) if isinstance(c, tuple)
            else jnp.asarray(c) for c in cats]


def _batches(weighted, invalid, specs=SPECS, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        cats = _cats(rng, specs, weighted, invalid)
        out.append((cats, rng.randn(BATCH).astype(np.float32)))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run_jax(optimizer, batches, hot_rows, specs=SPECS):
    model = _JaxModel(specs, hot_rows=hot_rows)
    emb = model.embedding
    params = {"embedding": emb.set_weights(_weights(specs))}
    init_fn, step_fn = jax_training.make_sparse_train_step(model, optimizer,
                                                           lr=LR)
    state = init_fn(params)
    losses = []
    for s, (cats, labels) in enumerate(batches):
        if hot_rows:
            emb.observe_hot_ids(_jax_cats(cats))
            if s == ADMIT_AT:
                p, st = emb.sync_hot_rows(params["embedding"], state["emb"],
                                          admit=True)
                params, state = {**params, "embedding": p}, {**state,
                                                             "emb": st}
        params, state, loss = step_fn(params, state, jnp.zeros((BATCH, 1)),
                                      _jax_cats(cats), jnp.asarray(labels))
        losses.append(float(loss))
    return losses, params, state, emb


def _run_port(optimizer, batches, hot_rows, specs=SPECS):
    model = _Model(specs, hot_rows=hot_rows)
    emb = model.embedding
    emb.set_weights(_weights(specs))
    init_fn, step_fn = pt_training.make_sparse_train_step(model, optimizer,
                                                          lr=LR)
    state = init_fn(model)
    losses = []
    for s, (cats, labels) in enumerate(batches):
        if hot_rows:
            emb.observe_hot_ids(cats)
            if s == ADMIT_AT:
                state["emb"] = emb.sync_hot_rows(state["emb"], admit=True)
        _, state, loss = step_fn(model, state, np.zeros((BATCH, 1)), cats,
                                 labels)
        losses.append(float(loss))
    return losses, model, state


def _close(got, want, what, tol=TABLE_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **tol)


# ------------------------------------------------------------- the tracker
TRACKER_CASES = {
    "threshold1": dict(capacity=8, promote_threshold=1),
    "threshold2": dict(capacity=8),
    "pruned": dict(capacity=4, promote_threshold=2, max_tracked=16),
    "decayed": dict(capacity=8, promote_threshold=2, decay=0.7),
}


@pytest.mark.parametrize("case", list(TRACKER_CASES))
def test_tracker_matches_jax(case):
    """The same observations, admissions and resets in both trackers: the
    slots, top keys, candidates and stats agree at every round."""
    kw = TRACKER_CASES[case]
    ours, ref = HotnessTracker(**kw), JaxTracker(**kw)
    rng = np.random.RandomState(len(case))
    for rnd in range(12):
        keys = np.minimum(rng.zipf(1.2, size=(24,)) - 1, 200)
        valid = rng.rand(24) > 0.1
        np.testing.assert_array_equal(ours.lookup_slots(keys, valid),
                                      ref.lookup_slots(keys, valid))
        assert ours.pending_candidates() == ref.pending_candidates()
        plan = ours.plan_admissions()
        assert plan == ref.plan_admissions()
        assert ours.commit_admissions(plan) == ref.commit_admissions(plan)
        if rnd == 6:
            top = ref.top_keys(3)
            ours.set_resident(top)
            ref.set_resident(top)
            ours.reset_stats()
            ref.reset_stats()
        if rnd == 9:
            ours.invalidate()
            ref.invalidate()
        np.testing.assert_array_equal(ours.top_keys(), ref.top_keys())
        np.testing.assert_array_equal(ours.resident_keys(),
                                      ref.resident_keys())
        np.testing.assert_array_equal(ours.counts_for(keys),
                                      ref.counts_for(keys))
        assert ours.stats() == ref.stats()
        assert ours.hit_rate == ref.hit_rate


@pytest.mark.parametrize("h", [1, 5, 16])
def test_sorted_member_positions_matches_jax(h):
    rng = np.random.RandomState(h)
    sent = 1000
    keys = np.full((h,), sent, np.int32)
    real = np.sort(rng.choice(500, size=max(h - 2, 1), replace=False))
    keys[:len(real)] = real
    queries = rng.randint(-5, sent + 3, size=(3, 4, 7)).astype(np.int32)
    queries[0, 0, :len(real)] = real[:7]
    pos, hit = embedding_ops.sorted_member_positions(
        torch.from_numpy(keys), torch.from_numpy(queries))
    jpos, jhit = jax_ops.sorted_member_positions(jnp.asarray(keys),
                                                 jnp.asarray(queries))
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(pos.numpy()[hit.numpy()],
                                  np.asarray(jpos)[np.asarray(jhit)])


# ----------------------------------------------------------- the forward
def _admitted_pair(weighted, invalid, seed=3):
    """A JAX and a port layer with the same weights after observing the
    same batch and admitting (admit=True), and the batch."""
    cats = _cats(np.random.RandomState(seed), weighted=weighted,
                 invalid=invalid)
    jl = _jax_layer(hot_rows=HOT)
    params = jl.set_weights(_weights())
    jl.observe_hot_ids(_jax_cats(cats))
    params, _ = jl.sync_hot_rows(params, None, admit=True)
    pl = _layer(hot_rows=HOT)
    pl.set_weights(_weights())
    pl.observe_hot_ids(cats)
    pl.sync_hot_rows(None, admit=True)
    return jl, params, pl, cats


@pytest.mark.parametrize("weighted,invalid", [(False, None), (True, None),
                                              (False, "bucket"),
                                              (True, "bucket")])
def test_hot_forward_matches_jax(weighted, invalid):
    jl, params, pl, cats = _admitted_pair(weighted, invalid)
    for b in pl._hot_buckets:
        ids, rows = pl._hot_entry(b)
        np.testing.assert_array_equal(ids.numpy(),
                                      np.asarray(params["hot"][b]["ids"]))
        np.testing.assert_array_equal(rows.numpy(),
                                      np.asarray(params["hot"][b]["rows"]))
        assert pl.hot_stats()[b] == jl.hot_stats()[b]
    want = jl.apply(params, _jax_cats(cats))
    got = pl(cats)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.numpy(), b, f"output {i}", dict(rtol=1e-5, atol=1e-6))
    assert pl.hot_resident_rows().keys() == jl.hot_resident_rows(
        params).keys()


def test_hot_forward_hits_read_the_hot_shard():
    """Resident rows are served from the hot rows: moving the hot rows
    moves the hits' outputs, moving the canonical table moves only the
    misses'."""
    layer = _layer([(32, 4, "sum")], hot_rows=4)
    layer.set_weights(_weights([(32, 4, "sum")], 3))
    b = layer._hot_buckets[0]
    layer.sync_hot_rows(None, new_keys={b: np.array([0, 1])})
    cats = [np.array([[0, 1], [2, 3]], np.int32)]
    base = layer(cats)[0]
    with torch.no_grad():
        layer._hot_entry(b)[1].add_(1.0)
    out = layer(cats)[0]
    assert (out[0] - base[0]).abs().max() > 0.5
    torch.testing.assert_close(out[1], base[1])
    with torch.no_grad():
        layer._hot_entry(b)[1].sub_(1.0)
        layer.tp[b].add_(1.0)
    out2 = layer(cats)[0]
    torch.testing.assert_close(out2[0], base[0])
    assert (out2[1] - base[1]).abs().max() > 0.5


def test_empty_hot_set_is_identity():
    """Before any admission every lookup misses: the hot layer's outputs
    are the hot-less layer's (bit for bit on the sum tables; the mean
    table folds its scale into the weights, as the JAX package's split
    does)."""
    cats = _cats(np.random.RandomState(2), invalid="outside")
    l0, l1 = _layer(), _layer(hot_rows=HOT)
    l0.set_weights(_weights())
    l1.set_weights(_weights())
    for b in l1._hot_buckets:
        ids, rows = l1._hot_entry(b)
        assert bool((ids == l1._hot_sentinel(b)).all())
        assert bool((rows == 0).all())
    for (v, w, c), a, b in zip(SPECS, l0(cats), l1(cats)):
        if c == "sum":
            assert torch.equal(a, b)
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_tapped_forward_without_hot_taps_raises():
    layer = _layer(hot_rows=HOT)
    cats = _cats(np.random.RandomState(0))
    taps = layer.make_taps(cats)
    assert "hot" in taps
    layer(cats)
    layer(cats, taps=taps)
    assert len(taps["hot"]) == len(taps["tp"])
    with pytest.raises(ValueError, match=r"taps\['hot'\]"):
        layer(cats, taps={"tp": [], "row": []})


def test_observe_hot_ids_ignores_out_of_range_ids():
    layer = _layer(hot_rows=HOT)
    layer.observe_hot_ids([np.full((BATCH, 2), v + 1000, np.int32)
                           for v, _, _ in SPECS])
    assert all(s["tracked"] == 0 and s["hits"] == 0 and s["misses"] == 0
               for s in layer.hot_stats().values())
    layer.observe_hot_ids([np.zeros((BATCH, 2), np.int32) for _ in SPECS])
    assert all(s["tracked"] > 0 for s in layer.hot_stats().values())


def test_hot_keys_from_counts_matches_jax():
    specs = [(32, 4, "sum"), (40, 4, "sum")]
    counts = [np.zeros((40,), np.int64), np.zeros((45,), np.int64)]
    counts[0][[3, 7, 9, 20]] = [50, 40, 30, 5]
    counts[0][35] = 1000               # past input_dim 32: never admitted
    counts[1][[1, 2, 39]] = [7, 60, 8]
    got = _layer(specs, hot_rows=4).hot_keys_from_counts(counts)
    want = _jax_layer(specs, hot_rows=4).hot_keys_from_counts(counts)
    assert got.keys() == want.keys()
    for b in got:
        np.testing.assert_array_equal(got[b], want[b])


# ------------------------------------------------------------ the steps
STEP_CASES = {
    "adagrad": ("adagrad", False, None),
    "adagrad-weighted": ("adagrad", True, None),
    "adagrad-invalid": ("adagrad", False, "bucket"),
    "sgd": ("sgd", False, None),
    "sgd-weighted": ("sgd", True, "bucket"),
    "adam": ("adam", False, None),
    "adam-weighted": ("adam", True, "bucket"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_hot_steps_match_jax(case):
    """Three steps (admission before the second) against the JAX
    package's hot step: losses, the membership, the hot rows and their
    state, the canonical tables and their state, the overlaid dump."""
    optimizer, weighted, invalid = STEP_CASES[case]
    batches = _batches(weighted, invalid)
    j_losses, params, j_state, jl = _run_jax(optimizer, batches, HOT)
    losses, model, state = _run_port(optimizer, batches, HOT)
    emb = model.embedding
    np.testing.assert_allclose(losses, j_losses, **LOSS_TOL)
    assert emb._hot_buckets == jl._hot_buckets
    for pos_h, b in enumerate(emb._hot_buckets):
        ids, rows = emb._hot_entry(b)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(
            params["embedding"]["hot"][b]["ids"]))
        _close(rows.numpy(), params["embedding"]["hot"][b]["rows"],
               f"hot rows {b}")
        for i, (got, want) in enumerate(zip(state["emb"]["hot"][pos_h],
                                            j_state["emb"]["hot"][pos_h])):
            if torch.is_tensor(got):
                _close(got.numpy(), want, f"hot state {b}.{i}")
            else:
                assert got == int(want)
    for b, entry in enumerate(state["emb"]["tp"]):
        _close(emb.tp[b].detach().numpy(),
               np.asarray(params["embedding"]["tp"][b])[0], f"table {b}")
        for i, (got, want) in enumerate(zip(entry, j_state["emb"]["tp"][b])):
            if torch.is_tensor(got):
                _close(got.numpy(), np.asarray(want)[0], f"state {b}.{i}")
    for t, (a, b) in enumerate(zip(emb.get_weights(),
                                   jl.get_weights(params["embedding"]))):
        _close(a, b, f"dump {t}")


@pytest.mark.parametrize("case", ["adagrad", "sgd-weighted", "adam"])
def test_hot_steps_match_the_hotless_step(case):
    """The port's hot step against its own hot-less step, with the same
    bars, on batches with ids past their buckets: the split changes where
    rows train, not what they become. (An invalid id that the lookup
    clamps onto a resident row, as a negative id onto row 0, reads the
    canonical copy there, which stops training while the row is
    resident: by design, here and in the JAX package.)"""
    optimizer, weighted, _ = STEP_CASES[case]
    batches = _batches(weighted, "past")
    l0, m0, _ = _run_port(optimizer, batches, 0)
    l1, m1, _ = _run_port(optimizer, batches, HOT)
    emb = m1.embedding
    assert any(s["resident"] for s in emb.hot_stats().values())
    for b in emb._hot_buckets:
        last = max(emb.plan.tp_buckets[b].rows_max, 1) - 1
        assert last not in emb._hot_entry(b)[0].tolist()
    np.testing.assert_allclose(l1, l0, **LOSS_TOL)
    for t, (a, b) in enumerate(zip(m1.embedding.get_weights(),
                                   m0.embedding.get_weights())):
        _close(a, b, f"table {t}")


def test_lazy_adam_leaves_a_hits_canonical_row_untouched():
    """Hit lanes cross as the sentinel, not as id 0 at weight 0: lazy
    adam's moments decay on every touched row, so a zero-weight touch of
    a real row would move it. Row 0 trains first, then only id 5 (hot)
    and id 7: row 0 stays bit-equal to the hot-less run's."""
    specs = [(32, 8, "sum")]

    def drive(hot):
        model = _Model(specs, hot_rows=hot)
        emb = model.embedding
        emb.set_weights(_weights(specs, 4))
        init_fn, step_fn = pt_training.make_sparse_train_step(model, "adam",
                                                              lr=LR)
        state = init_fn(model)
        _, state, _ = step_fn(model, state, np.zeros((2, 1)),
                              [np.array([[0], [0]], np.int32)], np.ones(2))
        if hot:
            b = emb._hot_buckets[0]
            state["emb"] = emb.sync_hot_rows(state["emb"],
                                             new_keys={b: np.array([5])})
        for _ in range(4):
            _, state, _ = step_fn(model, state, np.zeros((2, 1)),
                                  [np.array([[5], [7]], np.int32)],
                                  np.ones(2))
        return emb.get_weights()[0]
    w_base, w_hot = drive(0), drive(4)
    np.testing.assert_array_equal(w_base[0], w_hot[0])
    np.testing.assert_allclose(w_hot, w_base, rtol=1e-5, atol=1e-6)


def test_sync_then_get_weights_equals_the_overlay():
    """Before a sync the canonical rows of resident ids are stale and
    `get_weights` overlays the hot rows; `sync_hot_rows` writes them
    back, after which the canonical tables are that dump. Admission gathers
    rows and state rows from the canonical arrays."""
    _, model, state = _run_port("adagrad", _batches(False, None), HOT)
    emb = model.embedding
    overlay = emb.get_weights()
    stale = [t.detach().clone() for t in emb.tp]
    state["emb"] = emb.sync_hot_rows(state["emb"])
    assert any(not torch.equal(a, b.detach())
               for a, b in zip(stale, emb.tp)), "no hot row trained"
    keys = {b: emb._hot_trackers[b].resident_keys()
            for b in emb._hot_buckets}
    hot_rows = [emb._hot_entry(b)[1].clone() for b in emb._hot_buckets]
    hot_state = [s[0].clone() for s in state["emb"]["hot"]]
    # with the hot sets emptied, the dump is the canonical tables alone
    emb._reset_hot()
    for a, b in zip(overlay, emb.get_weights()):
        np.testing.assert_array_equal(a, b)
    # admitting the same keys again gathers the same rows and state rows
    state["emb"] = emb.sync_hot_rows(state["emb"], new_keys=keys)
    for pos_h, b in enumerate(emb._hot_buckets):
        assert torch.equal(emb._hot_entry(b)[1], hot_rows[pos_h])
        assert torch.equal(state["emb"]["hot"][pos_h][0], hot_state[pos_h])
    for a, b in zip(overlay, emb.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_hot_key_rows_inverts_hot_keys_of():
    """The layer's decoding of a hot bucket's flat keys into (table, row)
    over its placements covers every resident key once, and
    `_hot_keys_of` maps those rows back to the same keys."""
    _, model, _ = _run_port("adagrad", _batches(False, None), HOT)
    emb = model.embedding
    resident = emb.hot_resident_rows()
    assert resident
    for b, (keys, _) in resident.items():
        rows, covered = {}, np.zeros(keys.shape, np.int64)
        for gtid, pl_, m, local in emb._hot_key_rows(b, keys):
            assert pl_.bucket == b
            assert (local >= 0).all() and (local < pl_.rows).all()
            covered += m
            rows.setdefault(gtid, []).extend(local.tolist())
        np.testing.assert_array_equal(covered, 1)
        assert sorted(emb._hot_keys_of(rows)[b]) == sorted(keys.tolist())


def test_hot_update_refuses_an_optimizer_without_a_dense_rows_rule():
    """The hot shards take ``opt.dense_rows``, built by
    `make_sparse_optimizer` from the same lr and hyperparameters; an
    optimizer without one is refused, never applied as a zero step."""
    _, model, state = _run_port("sgd", _batches(False, None), HOT)
    opt = sparse_update.make_sparse_optimizer("sgd", LR)
    assert opt.dense_rows is not None
    with pytest.raises(ValueError, match="dense-rows rule"):
        model.embedding._hot_update(state["emb"]["hot"], [], [], None,
                                    opt._replace(dense_rows=None))


def test_fit_hot_sync_every_matches_jax():
    """`fit(hot_sync_every=2)` over 5 steps (observing every step,
    admitting before steps 2 and 4, a last sync after) against the JAX
    package's `fit`: losses, the trackers' stats and the dump."""
    data = _batches(False, "bucket", seed=11) + _batches(False, None,
                                                         seed=12)[:2]

    def batch(step):
        cats, labels = data[step]
        return np.zeros((BATCH, 1), np.float32), cats, labels
    jm = _JaxModel(hot_rows=HOT)
    params = {"embedding": jm.embedding.set_weights(_weights())}
    params, _, j_hist = jax_training.fit(
        jm, params, lambda s: (jnp.asarray(batch(s)[0]),
                               _jax_cats(batch(s)[1]),
                               jnp.asarray(batch(s)[2])),
        steps=5, optimizer="adagrad", lr=LR, log_every=0, hot_sync_every=2)
    model = _Model(hot_rows=HOT)
    model.embedding.set_weights(_weights())
    _, state, hist = pt_training.fit(model, batch, steps=5,
                                     optimizer="adagrad", lr=LR,
                                     log_every=0, hot_sync_every=2)
    np.testing.assert_allclose(hist["loss"], j_hist["loss"], **LOSS_TOL)
    assert hist["hot_stats"] == j_hist["hot_stats"]
    assert any(s["resident"] for s in hist["hot_stats"].values())
    for t, (a, b) in enumerate(zip(
            model.embedding.get_weights(),
            jm.embedding.get_weights(params["embedding"]))):
        _close(a, b, f"table {t}")
    # the last sync left the canonical tables equal to the overlay
    for b in model.embedding._hot_buckets:
        ids, rows = model.embedding._hot_entry(b)
        mine, local = model.embedding._hot_local(b, ids)
        assert torch.equal(model.embedding.tp[b][local], rows[mine])


def test_fit_with_hot_rows_from_an_iterable_observes_host_arrays():
    """Iterable data runs through the ingest pipeline; the observed ids are
    the batches' host arrays, and the run equals the callable one."""
    data = _batches(False, None, seed=13)
    batches = [(np.zeros((BATCH, 1), np.float32), c, lab) for c, lab in data]

    def run(source):
        model = _Model(hot_rows=HOT)
        model.embedding.set_weights(_weights())
        _, _, hist = pt_training.fit(model, source, steps=STEPS,
                                     optimizer="sgd", lr=LR, log_every=0,
                                     hot_sync_every=1)
        return hist
    a, b = run(batches), run(lambda s: batches[s])
    assert a["loss"] == b["loss"] and a["hot_stats"] == b["hot_stats"]


# ------------------------------------------------- weights, files, serving
def test_convert_round_trip_of_a_hot_tree():
    """A hot-sharded JAX tree and adagrad state (after admitted steps)
    through `params_from_jax` / `opt_state_from_jax` and back:
    `params_to_numpy` / `opt_state_to_numpy` give the JAX trees, and the
    loaded layer's forward is the JAX layer's."""
    _, params, j_state, jl = _run_jax("adagrad", _batches(True, None), HOT)
    model = _Model(hot_rows=HOT)
    model.load_state_dict(convert.params_from_jax(_np(params), model))
    tree = convert.params_to_numpy(model)
    want = _np(params)
    assert set(tree["embedding"]) == set(want["embedding"])
    for b, entry in enumerate(want["embedding"]["hot"]):
        got = tree["embedding"]["hot"][b]
        if entry is None:
            assert got is None
            continue
        for k in ("ids", "rows"):
            np.testing.assert_array_equal(got[k], entry[k])
    for a, b in zip(tree["embedding"]["tp"], want["embedding"]["tp"]):
        np.testing.assert_array_equal(a, b)
    state = convert.opt_state_from_jax(_np(j_state), model)
    back = convert.opt_state_to_numpy(state, model)
    for got, ref in zip(back["emb"]["hot"], _np(j_state)["emb"]["hot"]):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    cats = _cats(np.random.RandomState(9), weighted=True)
    for a, b in zip(model.embedding(cats),
                    jl.apply(params["embedding"], _jax_cats(cats))):
        _close(a.numpy(), b, "forward", dict(rtol=1e-5, atol=1e-6))
    # the tree and the layer must agree on the hot shards
    with pytest.raises(ValueError, match="hot"):
        convert.params_from_jax(_np(params), _Model())


def test_resume_files_carry_the_hot_state(tmp_path):
    """A resume file of a hot model (its state dict, with the hot
    membership and rows, and the optimizer state with the hot shards')
    restores a fresh model that trains on bit for bit."""
    batches = _batches(False, None, seed=21)
    losses, model, state = _run_port("adam", batches[:2], HOT)
    checkpoint.save_checkpoint(str(tmp_path), {
        "params": model.state_dict(), "opt_state": state}, step=2)
    fresh = _Model(hot_rows=HOT)
    init_fn, step_fn = pt_training.make_sparse_train_step(fresh, "adam",
                                                          lr=LR)
    restored = checkpoint.restore_checkpoint(
        str(tmp_path), {"params": fresh.state_dict(),
                        "opt_state": init_fn(fresh)}, step=2)
    f_state = restored["opt_state"]
    _, step_a = pt_training.make_sparse_train_step(model, "adam", lr=LR)
    cats, labels = batches[2]
    _, state, la = step_a(model, state, np.zeros((BATCH, 1)), cats, labels)
    _, f_state, lb = step_fn(fresh, f_state, np.zeros((BATCH, 1)), cats,
                             labels)
    assert float(la) == float(lb)
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert state["emb"]["hot"][0][2] == f_state["emb"]["hot"][0][2]


def test_engine_serves_through_the_split():
    """An `InferenceEngine` over a hot layer with resident rows serves the
    layer's forward (the JAX layer's on the same hot set) at a request
    size it pads."""
    jl, params, pl, _ = _admitted_pair(True, None, seed=4)
    cats = _cats(np.random.RandomState(5), invalid="bucket")
    cats = [c[:13] for c in cats]
    got = InferenceEngine(pl, device="cpu").predict(cats)
    want = jl.apply(params, _jax_cats(cats))
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.numpy(), b, f"output {i}", dict(rtol=1e-5, atol=1e-6))


def test_dense_step_refuses_a_hot_layer():
    model = _Model(hot_rows=HOT)
    step = pt_training.make_train_step(
        lambda m, n, c, lab: m.loss_fn(n, c, lab), pt_training.sgd(LR))
    with pytest.raises(ValueError, match="hot_rows"):
        step(model, {}, np.zeros((BATCH, 1)), _cats(np.random.RandomState(0)),
             np.zeros(BATCH, np.float32))
