"""The port's sparse-update ops against the JAX package's.

`dedup_sum` against the JAX `dedup_sum` (rep equal, sums within rtol 1e-6:
both add each segment in sorted order); the row kernels' plain versions
(which the wrappers take on CPU tensors) against the Pallas kernels they
replace, run in interpret mode as the JAX package's own tests run them,
over three accumulating steps; and the gradient of `fused_embedding_lookup`
against ``jax.grad`` of the JAX function. Inputs are numpy-seeded and carry
duplicates, negative ids and ids >= V.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu.ops import pallas_lookup as jax_lookup  # noqa: E402
from distributed_embeddings_tpu.ops import pallas_scatter as jax_scatter  # noqa: E402
from distributed_embeddings_tpu.ops import pallas_tiled as jax_tiled  # noqa: E402
from distributed_embeddings_tpu.ops import sparse_update as jax_su  # noqa: E402
from distributed_embeddings_tpu_torch.ops import cuda_lookup, cuda_sparse  # noqa: E402
from distributed_embeddings_tpu_torch.ops import cuda_tiled, embedding_ops  # noqa: E402
from distributed_embeddings_tpu_torch.ops import sparse_update as pt_su  # noqa: E402

ROW_TOL = dict(rtol=1e-6, atol=1e-7)
STEPS = 3


def _stream(rng, vocab, n, width, hot_share=0.3):
    """ids with duplicates (a hot id), negatives and ids >= V; contribs."""
    ids = rng.randint(0, vocab, size=n)
    ids[rng.rand(n) < hot_share] = rng.randint(0, vocab)
    ids[::11] = -1 - rng.randint(0, 3)
    ids[5::13] = vocab + rng.randint(0, 4)
    contribs = rng.randn(n, width).astype(np.float32)
    return ids.astype(np.int32), contribs


@pytest.mark.parametrize("vocab,n,width", [(50, 300, 8), (1000, 257, 16),
                                           (7, 40, 6), (300, 1, 4)])
def test_dedup_sum_matches_jax(vocab, n, width):
    rng = np.random.RandomState(vocab + n)
    ids, contribs = _stream(rng, vocab, n, width)
    want_rep, want_sums = jax_su.dedup_sum(jnp.asarray(ids),
                                           jnp.asarray(contribs), vocab)
    rep, sums = pt_su.dedup_sum(torch.from_numpy(ids),
                                torch.from_numpy(contribs), vocab)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(want_rep))
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums),
                               rtol=1e-6, atol=0)
    assert bool((rep[1:] > rep[:-1]).all())          # strictly increasing
    unused = rep.numpy() >= vocab + 1
    assert not sums.numpy()[unused].any()            # zero in unused slots


def test_segment_sum_plain_adds_in_sorted_order():
    """The plain version is `index_add_` of contribs[perm] by segment: on
    the CPU, bit-equal to a sequential sum in sorted order."""
    rng = np.random.RandomState(3)
    ids, contribs = _stream(rng, 20, 200, 8)
    keys = np.where((ids < 0) | (ids > 20), 20, ids)
    perm = np.argsort(keys, kind="stable")
    sid = keys[perm]
    want = np.zeros_like(contribs)
    s = -1
    for j in range(len(sid)):
        s += j == 0 or sid[j] != sid[j - 1]
        want[s] = want[s] + contribs[perm[j]]
    _, sums = pt_su.dedup_sum(torch.from_numpy(ids),
                              torch.from_numpy(contribs), 20)
    np.testing.assert_array_equal(sums.numpy(), want)



@pytest.mark.parametrize("plain", ["segment_sum_sorted_plain",
                                   "ordered_segment_sums"])
def test_long_segment_sums_are_sequential_in_sorted_order(plain):
    """The order the card's segment walk keeps, pinned at a long segment:
    both plain versions the kernels are held against (`cuda_sparse`'s, and
    `cuda_tiled`'s for the stream updates) give each segment, the
    20,000-row one among short ones, bit for bit the float32 sequential
    sum of its rows in sorted order (``np.add.accumulate``), and zeros past
    the last segment. A pairwise sum of the long segment differs, so the
    pin tells the orders apart."""
    rng = np.random.RandomState(11)
    n, width = 20_400, 8
    ids = rng.randint(0, 40, size=n)
    ids[rng.permutation(n)[:20_000]] = 7
    contribs = rng.randn(n, width).astype(np.float32)
    perm = np.argsort(ids, kind="stable")
    sid = torch.from_numpy(ids[perm])
    starts, _ = embedding_ops.segment_bounds(embedding_ops.segment_starts(sid))
    fn = (cuda_sparse.segment_sum_sorted_plain if plain ==
          "segment_sum_sorted_plain" else cuda_tiled._ordered_segment_sums)
    got = fn(torch.from_numpy(contribs), torch.from_numpy(perm), starts)
    bounds = starts.numpy()
    segments = int((bounds[1:] > bounds[:-1]).sum())
    for s in range(segments):
        rows = contribs[perm[bounds[s]:bounds[s + 1]]]
        np.testing.assert_array_equal(got[s].numpy(),
                                      np.add.accumulate(rows, axis=0)[-1])
        if len(rows) >= 20_000:
            pairwise = np.ascontiguousarray(rows.T).sum(axis=1)
            assert not np.array_equal(pairwise,
                                      np.add.accumulate(rows, axis=0)[-1])
    assert not got[segments:].any()


@pytest.mark.parametrize("long_rows", [32, 64, 256])
def test_walk_scratch_holds_every_long_segment(long_rows):
    """The segment walk's scratch: two counters (the worklist's count, the
    long pass's next entry), then one entry for each segment longer than
    `long_rows` that any n-row stream can hold, and never none (so the
    worklist is a valid pointer at n = 0)."""
    rng = np.random.RandomState(long_rows)
    for n in [0, 1, long_rows, long_rows + 1, 2 * long_rows + 2, 20_000]:
        size = cuda_sparse.walk_scratch_len(n, long_rows)
        assert size == 2 + max(1, n // (long_rows + 1))
        # as many long segments as fit: all of length long_rows + 1
        assert n // (long_rows + 1) <= size - 2
        for _ in range(20):
            cuts = np.sort(rng.randint(0, n + 1, size=rng.randint(0, 40)))
            lengths = np.diff(np.concatenate([[0], cuts, [n]]))
            assert lengths.sum() == n
            assert (lengths > long_rows).sum() <= size - 2


def _rows_inputs(rng, vocab, width):
    ids, contribs = _stream(rng, vocab, 3 * vocab, width)
    rep, sums = jax_su.dedup_sum(jnp.asarray(ids), jnp.asarray(contribs),
                                 vocab)
    return np.array(rep), np.array(sums)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROW_TOL)


@pytest.mark.parametrize("width", [8, 16, 6])
def test_sgd_rows_match_tiled_and_scatter(width):
    vocab, lr = 96, 0.05
    rng = np.random.RandomState(width)
    table0 = rng.randn(vocab, width).astype(np.float32)
    pt_t = torch.from_numpy(table0.copy())
    tiled, scat = jnp.asarray(table0), jnp.asarray(table0)
    pt_s = torch.from_numpy(table0.copy())
    for _ in range(STEPS):
        rep, sums = _rows_inputs(rng, vocab, width)
        tiled = jax_tiled.tiled_sgd_rows(tiled, jnp.asarray(rep),
                                         jnp.asarray(sums), lr,
                                         interpret=True)
        cuda_sparse.sgd_rows(pt_t, torch.from_numpy(rep),
                             torch.from_numpy(sums), lr)
        # scatter_add_sorted_unique is sgd_rows at lr = -1
        scat = jax_scatter.scatter_add_sorted_unique(
            scat, jnp.asarray(rep), jnp.asarray(sums), interpret=True)
        cuda_sparse.sgd_rows(pt_s, torch.from_numpy(rep),
                             torch.from_numpy(sums), -1.0)
    _close(pt_t, tiled)
    _close(pt_s, scat)


@pytest.mark.parametrize("width", [8, 16, 6])
def test_sgd_rows_skip_invalid_ids_anywhere_like_scatter(width):
    """`sgd_rows` at lr = -1 against `scatter_add_sorted_unique` on unique
    ids in random order with ids >= V and negative ids between them: the
    contract is unique ids, sorted only preferred, invalid ones dropped
    wherever they lie (not dedup's layout, a valid prefix)."""
    vocab, n = 96, 80
    rng = np.random.RandomState(20 + width)
    table0 = rng.randn(vocab, width).astype(np.float32)
    ids = rng.permutation(vocab)[:n].astype(np.int32)
    ids[rng.rand(n) < 0.2] = vocab + rng.randint(0, 5)
    ids[rng.rand(n) < 0.2] = -1 - rng.randint(0, 5)
    assert (ids >= vocab).any() and (ids < 0).any()
    assert not (ids[:-1] <= ids[1:]).all()
    delta = rng.randn(n, width).astype(np.float32)
    want = jax_scatter.scatter_add_sorted_unique(
        jnp.asarray(table0), jnp.asarray(ids), jnp.asarray(delta),
        interpret=True)
    got = cuda_sparse.sgd_rows(torch.from_numpy(table0.copy()),
                               torch.from_numpy(ids),
                               torch.from_numpy(delta), -1.0)
    _close(got, want)


@pytest.mark.parametrize("width", [8, 16, 6])
def test_adagrad_rows_match_tiled_and_scatter(width):
    vocab, lr, eps = 96, 0.05, 1e-7
    rng = np.random.RandomState(10 + width)
    table0 = rng.randn(vocab, width).astype(np.float32)
    acc0 = np.full((vocab, width), 0.1, np.float32)
    jt, ja = jnp.asarray(table0), jnp.asarray(acc0)
    st, sa = jnp.asarray(table0), jnp.asarray(acc0)
    pt_t, pt_a = torch.from_numpy(table0.copy()), torch.from_numpy(acc0.copy())
    for _ in range(STEPS):
        rep, sums = _rows_inputs(rng, vocab, width)
        jt, ja = jax_tiled.tiled_adagrad_rows(
            jt, ja, jnp.asarray(rep), jnp.asarray(sums), lr, eps=eps,
            interpret=True)
        st, sa = jax_scatter.adagrad_rows_sorted_unique(
            st, sa, jnp.asarray(rep), jnp.asarray(sums), lr, eps,
            interpret=True)
        cuda_sparse.adagrad_rows(pt_t, pt_a, torch.from_numpy(rep),
                                 torch.from_numpy(sums), lr, eps)
    for got, want in ((pt_t, jt), (pt_a, ja), (pt_t, st), (pt_a, sa)):
        _close(got, want)


@pytest.mark.parametrize("width", [8, 16, 6])
def test_adam_rows_match_tiled(width):
    vocab, lr = 96, 0.05
    rng = np.random.RandomState(20 + width)
    table0 = rng.randn(vocab, width).astype(np.float32)
    zeros = np.zeros((vocab, width), np.float32)
    jt, jmu, jnu = (jnp.asarray(table0), jnp.asarray(zeros),
                    jnp.asarray(zeros))
    count = jnp.zeros((), jnp.int32)
    pt_t = torch.from_numpy(table0.copy())
    pt_mu, pt_nu = torch.zeros(vocab, width), torch.zeros(vocab, width)
    for step in range(1, STEPS + 1):
        rep, sums = _rows_inputs(rng, vocab, width)
        if step == 2:
            # a touched row with a zero total still decays its moments
            sums[np.flatnonzero(rep < vocab)[0]] = 0.0
        jt, jmu, jnu, count = jax_tiled.tiled_adam_rows(
            jt, jmu, jnu, count, jnp.asarray(rep), jnp.asarray(sums), lr,
            interpret=True)
        c1, c2 = pt_su.bias_corrections(step, 0.9, 0.999)
        cuda_sparse.adam_rows(pt_t, pt_mu, pt_nu, torch.from_numpy(rep),
                              torch.from_numpy(sums), lr, 0.9, 0.999, 1e-8,
                              c1, c2)
    assert int(count) == STEPS
    for got, want in ((pt_t, jt), (pt_mu, jmu), (pt_nu, jnu)):
        _close(got, want)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_sparse_optimizers_match_jax_sort_strategy(optimizer):
    """make_sparse_optimizer end to end (dedup + rows) against the JAX
    package's ``sort`` strategy over three steps."""
    vocab, width, lr = 200, 16, 0.03
    rng = np.random.RandomState(7)
    table0 = rng.randn(vocab, width).astype(np.float32)
    hp = {"eps": 1e-7} if optimizer == "adagrad" else {}
    jopt = jax_su.make_sparse_optimizer(optimizer, lr, strategy="sort", **hp)
    popt = pt_su.make_sparse_optimizer(optimizer, lr, strategy="sort", **hp)
    jt, pt_t = jnp.asarray(table0), torch.from_numpy(table0.copy())
    js, ps = jopt.init(jt), popt.init(pt_t)
    for _ in range(STEPS):
        ids, contribs = _stream(rng, vocab, 500, width)
        jt, js = jopt.update(jt, js, jax_su.SparseRowGrad(
            jnp.asarray(ids), jnp.asarray(contribs)))
        pt_t, ps = popt.update(pt_t, ps, pt_su.SparseRowGrad(
            torch.from_numpy(ids), torch.from_numpy(contribs)))
    _close(pt_t, jt)
    for got, want in zip(ps, js):
        if torch.is_tensor(got):
            _close(got, want)
        else:
            assert got == int(want) == STEPS


def test_unported_strategies_raise():
    """Every strategy of the JAX package builds (``"dense"`` since the
    dense strategy was ported); an unknown one raises."""
    for kind in ("sgd", "adagrad", "adam"):
        for strategy in pt_su.STRATEGIES:
            assert pt_su.make_sparse_optimizer(
                kind, 0.1, strategy=strategy).kind == kind
    with pytest.raises(ValueError):
        pt_su.make_sparse_optimizer("adagrad", 0.1, strategy="nope")


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("strategy", ["dense", "auto"])
def test_dense_strategy_matches_jax(optimizer, strategy):
    """``strategy="dense"`` (and ``"auto"`` on a table under
    DENSE_ELEMS_MAX, which takes it for adagrad and adam in both packages)
    against the JAX package's, over three steps on streams with
    duplicates, negative ids and ids >= V: sgd's dense route is the plain
    scatter of the raw stream in both; sgd's ``"auto"`` is the port's
    deduplicated route against the JAX package's plain scatter, the
    difference its own last-ulp tolerance allows."""
    vocab, width, lr = 120, 8, 0.03
    assert pt_su._pick("auto", vocab, width) == "dense" == jax_su._pick(
        "auto", vocab, width)
    rng = np.random.RandomState(11)
    table0 = rng.randn(vocab, width).astype(np.float32)
    hp = {"eps": 1e-7} if optimizer == "adagrad" else {}
    jopt = jax_su.make_sparse_optimizer(optimizer, lr, strategy=strategy,
                                        **hp)
    popt = pt_su.make_sparse_optimizer(optimizer, lr, strategy=strategy,
                                       **hp)
    jt, pt_t = jnp.asarray(table0), torch.from_numpy(table0.copy())
    js, ps = jopt.init(jt), popt.init(pt_t)
    before = table0.copy()
    for _ in range(STEPS):
        ids, contribs = _stream(rng, vocab, 400, width)
        jt, js = jopt.update(jt, js, jax_su.SparseRowGrad(
            jnp.asarray(ids), jnp.asarray(contribs)))
        pt_t, ps = popt.update(pt_t, ps, pt_su.SparseRowGrad(
            torch.from_numpy(ids), torch.from_numpy(contribs)))
    _close(pt_t, jt)
    for got, want in zip(ps, js):
        if torch.is_tensor(got):
            _close(got, want)
        else:
            assert got == int(want) == STEPS
    # rows no stream touched keep their values (lazy adam too)
    assert (pt_t.numpy() != before).any()


def test_dense_sum_drops_invalid_ids_and_counts():
    rng = np.random.RandomState(2)
    ids, contribs = _stream(rng, 30, 200, 4)
    g, counts = pt_su._dense_sum(torch.from_numpy(ids),
                                 torch.from_numpy(contribs), 30)
    jg, jcounts = jax_su._dense_sum(jnp.asarray(ids), jnp.asarray(contribs),
                                    30)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    valid = ids[(ids >= 0) & (ids < 30)]
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(valid, minlength=30))


def test_pick_matches_jax():
    """`_pick` equals the JAX package's over a grid of shapes, both sides
    of DENSE_ELEMS_MAX, for every strategy."""
    assert pt_su.DENSE_ELEMS_MAX == jax_su.DENSE_ELEMS_MAX == 16 * 2**20
    for rows in (1, 1000, 60_160, 2**20, 2**21, 2**21 + 1, 10**7, 10**8):
        for width in (1, 8, 16, 128):
            for strategy in ("auto", "sort", "dense", "tiled", "pallas"):
                assert (pt_su._pick(strategy, rows, width)
                        == jax_su._pick(strategy, rows, width)), (
                    strategy, rows, width)


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_update_consumes_sort_matches_jax(kind):
    """Whether the update takes the forward's sort, as the JAX package
    decides it, except sgd's ``"auto"``, whose deduplicated route (the
    port's choice) consumes it where the JAX package's scatter does not."""
    for rows, width in ((100, 8), (2**22, 16)):
        for strategy in ("auto", "sort", "dense", "tiled"):
            got = pt_su.update_consumes_sort(kind, strategy, rows, width)
            want = jax_su.update_consumes_sort(kind, strategy, rows, width)
            if kind == "sgd" and strategy == "auto":
                assert got and not want
            else:
                assert got == want, (kind, strategy, rows, width)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("width", [8, 16])
def test_fused_lookup_gradient_matches_jax(combiner, width):
    """d(loss)/d(table) and d(loss)/d(weights) of `fused_embedding_lookup`
    against ``jax.grad`` of the JAX function (interpret mode), with ids
    out of range on both sides."""
    rng = np.random.RandomState(width)
    vocab, batch, hot = 40, 12, 5
    table = rng.randn(vocab, width).astype(np.float32)
    ids = rng.randint(-2, vocab + 2, size=(batch, hot)).astype(np.int32)
    weights = rng.rand(batch, hot).astype(np.float32)
    cot = rng.randn(batch, width).astype(np.float32)

    def jloss(t, w):
        out = jax_lookup.fused_embedding_lookup(t, jnp.asarray(ids), w,
                                                combiner, interpret=True)
        return jnp.sum(out * cot)

    want_t, want_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                                    jnp.asarray(weights))
    t = torch.from_numpy(table).requires_grad_()
    w = torch.from_numpy(weights).requires_grad_()
    out = cuda_lookup.fused_embedding_lookup(t, torch.from_numpy(ids), w,
                                             combiner)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_t),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-6)
