"""The port's sorted-stream ops against the JAX package's `pallas_tiled`.

The plain versions of `gather_sorted` and of the stream updates (which the
wrappers take on CPU tensors) against the Pallas kernels they replace, run
in interpret mode as the JAX package's own tests run them, on the same
numpy-seeded inputs: the gathers at rtol 1e-5 / atol 1e-6 and the raw-stream
updates at rtol 1e-4 / atol 1e-5 (the JAX package's own bars in
tests/test_pallas_tiled.py: the one-hot matmul sums duplicates in another
order); the lookups' forward and gradients against ``jax.grad``; the sort
artifacts against the JAX package's; and a presorted stream bit-identical
to a fresh sort.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu.ops import embedding_ops as jax_eo  # noqa: E402
from distributed_embeddings_tpu.ops import pallas_tiled as jax_tiled  # noqa: E402
from distributed_embeddings_tpu_torch.ops import cuda_tiled  # noqa: E402
from distributed_embeddings_tpu_torch.ops import embedding_ops as pt_eo  # noqa: E402
from distributed_embeddings_tpu_torch.ops import sparse_update as pt_su  # noqa: E402

GATHER_TOL = dict(rtol=1e-5, atol=1e-6)
UPDATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _raw_ids(rng, vocab, n, invalid_share):
    """Ids with a hot id (duplicates) and a share of negative ids and ids
    >= V."""
    ids = rng.randint(0, vocab, size=n)
    ids[rng.rand(n) < 0.3] = rng.randint(0, vocab)
    bad = rng.rand(n) < invalid_share
    ids[bad] = np.where(rng.rand(n) < 0.5, -1 - rng.randint(0, 3, n),
                        vocab + rng.randint(0, 4, n))[bad]
    return ids.astype(np.int32)


@pytest.mark.parametrize("vocab,n,width", [(50, 300, 8), (700, 129, 16),
                                           (9, 40, 6), (300, 0, 4)])
def test_sorted_gathers_match_jax(vocab, n, width):
    """tiled_gather_sorted(_weighted) on an ascending stream that holds
    negative keys and keys >= V (zero rows), and the empty stream."""
    rng = np.random.RandomState(vocab + n)
    table = rng.randn(vocab, width).astype(np.float32)
    sid = np.sort(rng.randint(-2, vocab + 3, size=n)).astype(np.int32)
    w = rng.rand(n).astype(np.float32)
    want = jax_tiled.tiled_gather_sorted(jnp.asarray(table), jnp.asarray(sid),
                                         interpret=True)
    got = cuda_tiled.tiled_gather_sorted(_t(table), _t(sid))
    assert got.shape == (n, width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATHER_TOL)
    want_w = jax_tiled.tiled_gather_sorted_weighted(
        jnp.asarray(table), jnp.asarray(sid), jnp.asarray(w), interpret=True)
    got_w = cuda_tiled.tiled_gather_sorted_weighted(_t(table), _t(sid), _t(w))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                               **GATHER_TOL)
    out = (sid < 0) | (sid >= vocab)
    assert not got.numpy()[out].any() and not got_w.numpy()[out].any()


@pytest.mark.parametrize("vocab,n,width", [(50, 300, 8), (700, 129, 16),
                                           (9, 40, 6), (300, 0, 4)])
@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_sorted_perm_form(vocab, n, width, key_dtype, weighted):
    """`gather_sorted_plain` with `perm` (rows at their places in the
    stream, weights in stream order) on the sort of ids in any order, ids
    out of range included: bit for bit the sorted gather with the weights
    permuted before it and the rows unpermuted after it, and the inv
    form (by output row), and against the
    JAX package's ``jnp.take(tiled_gather_sorted_weighted(table, sid,
    w[perm]), inv)`` at GATHER_TOL."""
    rng = np.random.RandomState(vocab + n + width)
    table = rng.randn(vocab, width).astype(np.float32)
    ids = _raw_ids(rng, vocab, n, 0.2)
    w = rng.rand(n).astype(np.float32) if weighted else None
    sid, perm, inv = cuda_tiled._sort_with_inv(_t(ids), vocab, None)
    sid = sid.to(key_dtype)
    tw = None if w is None else _t(w)
    got = cuda_tiled.gather_sorted_plain(_t(table), sid, tw, perm=perm)
    old = cuda_tiled.gather_sorted_plain(
        _t(table), sid, None if tw is None else tw.index_select(0, perm))
    assert torch.equal(got, old.index_select(0, inv))
    assert torch.equal(got, cuda_tiled.gather_sorted(_t(table), sid, tw,
                                                     perm=perm))
    jsid, jperm, jinv = jax_tiled._sort_with_inv(jnp.asarray(ids), vocab,
                                                 None)
    jw = jnp.asarray(w if w is not None else np.ones(n, np.float32))
    want = jnp.take(jax_tiled.tiled_gather_sorted_weighted(
        jnp.asarray(table), jsid, jnp.take(jw, jperm), interpret=True),
        jinv, axis=0) if n else np.zeros((0, width), np.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATHER_TOL)


@pytest.mark.parametrize("bad", [
    dict(perm=torch.zeros(5, dtype=torch.int32)),
    dict(perm=torch.zeros(4, dtype=torch.int64)),
    dict(perm=torch.zeros(10, dtype=torch.int64)[::2]),
    dict(perm=torch.zeros(5, dtype=torch.float32)),
    dict(perm=torch.zeros((5, 1), dtype=torch.int64)),
])
def test_gather_sorted_refuses_a_bad_perm(bad):
    with pytest.raises(ValueError):
        cuda_tiled.gather_sorted(torch.zeros(6, 4),
                                 torch.zeros(5, dtype=torch.int64), **bad)


@pytest.mark.parametrize("vocab,n,width", [(50, 300, 8), (700, 129, 16),
                                           (300, 0, 4)])
def test_tiled_gather_and_sort_artifacts_match_jax(vocab, n, width):
    """tiled_gather on ids in any order (fresh sort, then with the sort
    as a presorted triple and pair); the sort triple equals the JAX
    package's, and `canonical_id_sort` equals the JAX `canonical_id_sort`."""
    rng = np.random.RandomState(n)
    table = rng.randn(vocab, width).astype(np.float32)
    ids = _raw_ids(rng, vocab, n, 0.2)
    want = np.asarray(jax_tiled.tiled_gather(jnp.asarray(table),
                                             jnp.asarray(ids),
                                             interpret=True))
    got = cuda_tiled.tiled_gather(_t(table), _t(ids))
    np.testing.assert_allclose(got.numpy(), want, **GATHER_TOL)
    triple = cuda_tiled._sort_with_inv(_t(ids), vocab, None)
    jtriple = jax_tiled._sort_with_inv(jnp.asarray(ids), vocab, None)
    for a, b in zip(triple, jtriple):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for presorted in (triple, triple[:2]):
        again = cuda_tiled.tiled_gather(_t(table), _t(ids),
                                        presorted=presorted)
        assert torch.equal(again, got)
    gs = pt_eo.canonical_id_sort(_t(ids), vocab, want_inv=True)
    jgs = jax_eo.canonical_id_sort(jnp.asarray(ids), vocab, want_inv=True)
    for field in ("sid", "perm", "seg_start", "inv"):
        # [:n]: the JAX seg_start of an empty stream holds one start
        np.testing.assert_array_equal(getattr(gs, field).numpy(),
                                      np.asarray(getattr(jgs, field))[:n])


def _lookup_case(seed, vocab, batch, hot, width):
    rng = np.random.RandomState(seed)
    table = rng.randn(vocab, width).astype(np.float32)
    ids = rng.randint(-2, vocab + 2, size=(batch, hot)).astype(np.int32)
    weights = rng.rand(batch, hot).astype(np.float32)
    weights[:, 1::3] = 0.0                    # padded slots
    cot = rng.randn(batch, width).astype(np.float32)
    return table, ids, weights, cot


LOOKUPS = {"tiled": (jax_tiled.tiled_embedding_lookup,
                     cuda_tiled.tiled_embedding_lookup),
           "fused": (jax_tiled.fused_lookup_combine,
                     cuda_tiled.fused_lookup_combine)}


@pytest.mark.parametrize("path", sorted(LOOKUPS))
@pytest.mark.parametrize("combiner,weighted", [("sum", False), ("mean", False),
                                               ("sum", True), ("mean", True)])
@pytest.mark.parametrize("presorted", [False, True])
def test_lookups_and_gradients_match_jax(path, combiner, weighted, presorted):
    """Forward (rtol 1e-5), d/d table (rtol 1e-5) and d/d weights (rtol
    1e-4) against ``jax.grad`` of the JAX lookup, ids out of range on both
    sides; `presorted` passes the canonical sort of the flattened ids, as
    the tapped forward does (negative ids then read row V-1)."""
    vocab, batch, hot, width = 40, 12, 5, 8
    table, ids, weights, cot = _lookup_case(hot + weighted, vocab, batch,
                                            hot, width)
    jfn, pfn = LOOKUPS[path]
    if not weighted:
        weights = np.ones_like(weights)
    jps = pps = None
    if presorted:
        jgs = jax_eo.canonical_id_sort(jnp.asarray(ids), vocab, want_inv=True)
        jps = (jgs.sid, jgs.perm, jgs.inv)
        pgs = pt_eo.canonical_id_sort(_t(ids), vocab, want_inv=True)
        pps = (pgs.sid, pgs.perm, pgs.inv)

    def jloss(t, w):
        out = jfn(t, jnp.asarray(ids), w, combiner, interpret=True,
                  presorted=jps)
        return jnp.sum(out * cot), out

    (_, want_out), (want_t, want_w) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(table),
                                             jnp.asarray(weights))
    t = _t(table.copy()).requires_grad_()
    w = _t(weights.copy()).requires_grad_()
    out = pfn(t, _t(ids), w, combiner, presorted=pps)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-6)
    dt, dw = torch.autograd.grad((out * _t(cot)).sum(), [t, w])
    np.testing.assert_allclose(dt.numpy(), np.asarray(want_t), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_w), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("path", sorted(LOOKUPS))
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_lookups_take_a_presorted_pair_or_triple(path, combiner):
    """A presorted (sid, perm) gives the forward and both gradients of a
    presorted (sid, perm, inv) bit for bit (no lookup reads inv), and
    matches the JAX lookup given its triple at the tolerances of
    `test_lookups_and_gradients_match_jax`."""
    vocab, batch, hot, width = 40, 12, 5, 8
    table, ids, weights, cot = _lookup_case(7, vocab, batch, hot, width)
    jfn, pfn = LOOKUPS[path]
    gs = pt_eo.canonical_id_sort(_t(ids), vocab, want_inv=True)
    got = []
    for presorted in ((gs.sid, gs.perm, gs.inv), (gs.sid, gs.perm)):
        t = _t(table.copy()).requires_grad_()
        w = _t(weights.copy()).requires_grad_()
        out = pfn(t, _t(ids), w, combiner, presorted=presorted)
        got.append((out.detach(),) + torch.autograd.grad(
            (out * _t(cot)).sum(), [t, w]))
    for a, b in zip(*got):
        assert torch.equal(a, b)
    jgs = jax_eo.canonical_id_sort(jnp.asarray(ids), vocab, want_inv=True)

    def jloss(t, w):
        out = jfn(t, jnp.asarray(ids), w, combiner, interpret=True,
                  presorted=(jgs.sid, jgs.perm, jgs.inv))
        return jnp.sum(out * cot), out

    (_, want_out), (want_t, want_w) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(table),
                                             jnp.asarray(weights))
    out, dt, dw = got[1]
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(want_t), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_w), rtol=1e-4,
                               atol=1e-5)


def test_lookup_without_weights_equals_all_ones():
    table, ids, _, _ = _lookup_case(0, 30, 9, 4, 16)
    for _, pfn in LOOKUPS.values():
        for combiner in ("sum", "mean"):
            a = pfn(_t(table), _t(ids), None, combiner)
            b = pfn(_t(table), _t(ids), torch.ones(ids.shape), combiner)
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        cuda_tiled.fused_lookup_combine(_t(table), _t(ids), None, "max")


def _jax_update(kind, state, count, ids, contribs, lr, presorted=None):
    ids, contribs = jnp.asarray(ids), jnp.asarray(contribs)
    if kind == "sgd":
        return (jax_tiled.tiled_sgd(state[0], ids, contribs, lr,
                                    interpret=True, presorted=presorted),
                ), count
    if kind == "adagrad":
        return jax_tiled.tiled_adagrad(state[0], state[1], ids, contribs, lr,
                                       eps=1e-7, interpret=True,
                                       presorted=presorted), count
    t, mu, nu, count = jax_tiled.tiled_adam(state[0], state[1], state[2],
                                            count, ids, contribs, lr,
                                            interpret=True,
                                            presorted=presorted)
    return (t, mu, nu), count


def _port_update(kind, state, count, ids, contribs, lr, presorted=None):
    if kind == "sgd":
        return (cuda_tiled.tiled_sgd(state[0], ids, contribs, lr,
                                     presorted=presorted),), count
    if kind == "adagrad":
        return cuda_tiled.tiled_adagrad(state[0], state[1], ids, contribs,
                                        lr, eps=1e-7,
                                        presorted=presorted), count
    t, mu, nu, count = cuda_tiled.tiled_adam(state[0], state[1], state[2],
                                             count, ids, contribs, lr,
                                             presorted=presorted)
    return (t, mu, nu), count


def _initial_state(rng, kind, vocab, width):
    table = (rng.randn(vocab, width) * 0.1).astype(np.float32)
    extra = {"sgd": [], "adagrad": [np.full((vocab, width), 0.1, np.float32)],
             "adam": [np.zeros((vocab, width), np.float32)] * 2}[kind]
    return [table] + extra


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("invalid_share", [0.0, 0.5])
def test_raw_stream_updates_match_jax(kind, invalid_share):
    """tiled_sgd / tiled_adagrad / tiled_adam over two accumulating steps
    (adam: touched-only moment decay), each with a presorted (sid, perm)
    twin that must be bit-identical to the fresh sort."""
    rng = np.random.RandomState(7 if invalid_share else 8)
    vocab, width, n = 60, 8, 500
    state0 = _initial_state(rng, kind, vocab, width)
    jstate = [jnp.asarray(x) for x in state0]
    pstate = [_t(x.copy()) for x in state0]
    twin = [_t(x.copy()) for x in state0]
    jcount = jnp.zeros((), jnp.int32)
    pcount = twin_count = 0
    for _ in range(2):
        ids = _raw_ids(rng, vocab, n, invalid_share)
        contribs = rng.randn(n, width).astype(np.float32)
        jstate, jcount = _jax_update(kind, jstate, jcount, ids, contribs,
                                     0.05)
        pstate, pcount = _port_update(kind, pstate, pcount, _t(ids),
                                      _t(contribs), 0.05)
        gs = pt_eo.canonical_id_sort(_t(ids), vocab)
        twin, twin_count = _port_update(kind, twin, twin_count, _t(ids),
                                        _t(contribs), 0.05,
                                        presorted=(gs.sid, gs.perm))
    for got, want, again in zip(pstate, jstate, twin):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **UPDATE_TOL)
        assert torch.equal(got, again)
    assert pcount == twin_count == (int(jcount) if kind == "adam" else 0)


def test_raw_stream_updates_on_an_empty_stream():
    """Nothing moves; adam's count still rises, as in the JAX package."""
    table = torch.randn(10, 4)
    ids = torch.zeros(0, dtype=torch.int32)
    contribs = torch.zeros(0, 4)
    before = table.clone()
    assert cuda_tiled.tiled_sgd(table, ids, contribs, 0.1) is table
    mu, nu = torch.zeros(10, 4), torch.zeros(10, 4)
    *_, count = cuda_tiled.tiled_adam(table, mu, nu, 3, ids, contribs, 0.1)
    jcount = jax_tiled.tiled_adam(jnp.asarray(before.numpy()),
                                  jnp.zeros((10, 4)), jnp.zeros((10, 4)),
                                  jnp.asarray(3), jnp.asarray(ids.numpy()),
                                  jnp.zeros((0, 4)), 0.1, interpret=True)[3]
    assert count == int(jcount) == 4
    assert torch.equal(table, before) and not mu.any() and not nu.any()


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_tiled_strategy_equals_the_dedup_route(kind):
    """Both routes sum each segment in sorted order and round the rule
    alike: strategy 'tiled' gives the tables of strategy 'sort' bit for
    bit."""
    rng = np.random.RandomState(11)
    vocab, width, n = 80, 16, 600
    state0 = _initial_state(rng, kind, vocab, width)
    opts = {s: pt_su.make_sparse_optimizer(kind, 0.05, strategy=s)
            for s in ("tiled", "sort")}
    states = {s: (_t(state0[0].copy()),
                  tuple(_t(x.copy()) for x in state0[1:])
                  + ((0,) if kind == "adam" else ()))
              for s in opts}
    for _ in range(2):
        grad = pt_su.SparseRowGrad(_t(_raw_ids(rng, vocab, n, 0.2)),
                                   _t(rng.randn(n, width).astype(np.float32)))
        for s, opt in opts.items():
            states[s] = opt.update(states[s][0], states[s][1], grad)
    (t1, s1), (t2, s2) = states["tiled"], states["sort"]
    assert torch.equal(t1, t2)
    for a, b in zip(s1, s2):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("vocab,n", [(50, 300), (7, 40), (300, 1), (5, 0)])
def test_dedup_sum_presorted_is_bit_identical(vocab, n):
    rng = np.random.RandomState(vocab)
    ids = _t(_raw_ids(rng, vocab, n, 0.2))
    contribs = _t(rng.randn(n, 8).astype(np.float32))
    rep, sums = pt_su.dedup_sum(ids, contribs, vocab)
    gs = pt_eo.canonical_id_sort(ids, vocab)
    rep2, sums2 = pt_su.dedup_sum(ids, contribs, vocab, presorted=gs)
    assert rep.dtype == rep2.dtype
    assert torch.equal(rep, rep2) and torch.equal(sums, sums2)


def test_mismatched_presorted_sorts_afresh():
    """A sort of another stream length (one group's sort offered for a
    concatenated bucket stream) is ignored, as in the JAX package."""
    rng = np.random.RandomState(2)
    ids = _raw_ids(rng, 30, 100, 0.1)
    grad = pt_su.SparseRowGrad(_t(ids), _t(rng.randn(100, 4)
                                           .astype(np.float32)))
    other = pt_eo.canonical_id_sort(_t(ids[:60]), 30)
    for strategy in ("sort", "tiled"):
        a = pt_su.sparse_sgd(torch.zeros(30, 4), grad, 0.1, strategy)
        b = pt_su.sparse_sgd(torch.zeros(30, 4), grad, 0.1, strategy,
                             presorted=other)
        assert torch.equal(a, b)
