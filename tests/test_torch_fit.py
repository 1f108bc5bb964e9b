"""The port's `fit`, `evaluate`, streaming AUC and dense step against the
JAX package's.

A small DLRM (five tables of 7..1,000 rows, width 16) built in both
packages, its weights carried across with `convert.params_from_jax`, and
the same numpy-seeded batches (`ClickGenerator`, bit-equal in both) in
each. Tolerances: the AUC histograms exactly (0/1 counts); `auc_exact`
within 1e-12; AUCs within 1e-4 (a logit whose sigmoid sits within an ulp of
a bin edge may fall in the neighbouring bin); losses rtol 1e-5; tables and
MLPs rtol 1e-5 / atol 1e-6 after 3 dense steps (the MLPs run through two
BLAS libraries), adam at atol 1e-4 * lr (its step moves an element by
about lr whatever the size of its gradient, so an element whose gradient
is tiny or a sum that cancels carries the two libraries' low digits as a
share of lr); pipelined and serial `fit` bit-identical.
Mirrors tests/test_fit.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.models import dlrm as jax_dlrm  # noqa: E402
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu.utils import metrics as jax_metrics  # noqa: E402
from distributed_embeddings_tpu_torch import convert  # noqa: E402
from distributed_embeddings_tpu_torch import training as pt_training  # noqa: E402
from distributed_embeddings_tpu_torch.models import dlrm as pt_dlrm  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402
from distributed_embeddings_tpu_torch.utils import metrics as pt_metrics  # noqa: E402

SIZES = [40, 7, 300, 25, 1000]
KW = dict(embedding_dim=16, bottom_mlp_dims=(32, 16), top_mlp_dims=(32, 1),
          num_numerical_features=5)
BATCH = 64
STEPS = 3
LR = 0.05
LOSS_TOL = dict(rtol=1e-5, atol=0)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
AUC_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gen(seed=3):
    return pt_synth.ClickGenerator(SIZES, 5, BATCH, seed=seed)


def _models(seed=5):
    jm = jax_dlrm.DLRM(SIZES, **KW)
    params = jm.init(jax.random.PRNGKey(seed))
    pm = pt_dlrm.DLRM(SIZES, device="cpu", **KW)
    pm.load_state_dict(convert.params_from_jax(_np(params), pm))
    return jm, params, pm


def _assert_params_close(pm, jax_params, tol=STATE_TOL):
    want = convert.params_from_jax(_np(jax_params), pm)
    got = pm.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


def _quiet(*_):
    pass


# ----------------------------------------------------------- the metrics
@pytest.mark.parametrize("from_logits", [True, False])
def test_streaming_auc_histograms_equal_jax(from_logits):
    rng = np.random.RandomState(0)
    jm, pm = (jax_metrics.StreamingAUC(from_logits=from_logits),
              pt_metrics.StreamingAUC(from_logits=from_logits))
    js, ps = jm.init(), pm.init("cpu")
    for _ in range(4):
        labels = rng.randint(0, 2, 500).astype(np.float32)
        scores = (rng.randn(500).astype(np.float32) * 3 if from_logits
                  else rng.rand(500).astype(np.float32))
        js = jm.update(js, jnp.asarray(labels), jnp.asarray(scores))
        ps = pm.update(ps, torch.from_numpy(labels), torch.from_numpy(scores))
    np.testing.assert_array_equal(ps.tp.numpy(), np.asarray(js.tp))
    np.testing.assert_array_equal(ps.fp.numpy(), np.asarray(js.fp))
    assert pm.result(ps) == jm.result(js)


def test_streaming_auc_degenerate_labels():
    pm = pt_metrics.StreamingAUC(bins=16)
    state = pm.update(pm.init("cpu"), np.ones(8, np.float32),
                      np.linspace(-2, 2, 8).astype(np.float32))
    assert pm.result(state) == 0.0 == pt_metrics.auc_exact(
        np.ones(8), np.arange(8.0))


@pytest.mark.parametrize("ties", [False, True])
def test_auc_exact_matches_jax(ties):
    rng = np.random.RandomState(1)
    labels = rng.randint(0, 2, 2000)
    scores = rng.randn(2000)
    if ties:
        scores = np.round(scores, 1)
    assert abs(pt_metrics.auc_exact(labels, scores)
               - jax_metrics.auc_exact(labels, scores)) <= 1e-12


# ------------------------------------------------------------- evaluate
def test_evaluate_matches_jax():
    jm, params, pm = _models()
    gen = _gen()
    data = lambda j: gen.batch(500 + j)  # noqa: E731
    want = jax_training.evaluate(jm, params, data, steps=4)
    got = pt_training.evaluate(pm, data, steps=4)
    assert abs(got - want) <= AUC_TOL
    # an iterable through the pipeline, pipelined and inline: the same AUC
    for pipelined in (True, False):
        it = (data(j) for j in range(4))
        assert pt_training.evaluate(pm, it, steps=4,
                                    pipelined=pipelined) == got


def test_evaluate_auc_range():
    _, _, pm = _models(seed=1)
    auc = pt_training.evaluate(pm, _gen(seed=7), steps=4)
    assert 0.0 <= auc <= 1.0


def test_evaluate_reads_no_more_than_its_steps():
    """`evaluate` takes islice(data, steps): a shared source keeps the
    rest."""
    _, _, pm = _models()
    gen = _gen()
    source = iter([gen.batch(j) for j in range(5)])
    pt_training.evaluate(pm, source, steps=2)
    assert len(list(source)) == 3


# ------------------------------------------------------------------ fit
def test_fit_sparse_with_eval_matches_jax():
    jm, params, pm = _models()
    gen = _gen()
    eval_data = lambda j: gen.batch(10_000 + j)  # noqa: E731
    kw = dict(optimizer="adagrad", lr=LR, eval_data=eval_data,
              eval_every=2, eval_steps=3, log_every=0, log_fn=_quiet)
    jparams, _, jhist = jax_training.fit(
        jm, params, [gen.batch(s) for s in range(4)], 4, **kw)
    _, _, phist = pt_training.fit(pm, [gen.batch(s) for s in range(4)], 4,
                                  **kw)
    np.testing.assert_allclose(phist["loss"], jhist["loss"], **LOSS_TOL)
    assert len(phist["eval_auc"]) == len(jhist["eval_auc"]) == 2
    np.testing.assert_allclose(phist["eval_auc"], jhist["eval_auc"],
                               rtol=0, atol=AUC_TOL)
    assert set(phist["ingest_stages"]) == {"read", "stage"}
    _assert_params_close(pm, jparams, dict(rtol=1e-4, atol=1e-6))


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_fit_dense_matches_jax(optimizer):
    """fit(sparse=False): every parameter, tables included, takes its
    gradient from autodiff and the optax twin's update."""
    jm, params, pm = _models()
    gen = _gen()
    batches = [gen.batch(s) for s in range(STEPS)]
    kw = dict(optimizer=optimizer, lr=LR, sparse=False, log_every=0,
              log_fn=_quiet)
    jparams, _, jhist = jax_training.fit(jm, params, batches, STEPS, **kw)
    tables = [t.detach().clone() for t in pm.embedding.tp]
    _, state, phist = pt_training.fit(pm, batches, STEPS, **kw)
    np.testing.assert_allclose(phist["loss"], jhist["loss"], **LOSS_TOL)
    _assert_params_close(pm, jparams, dict(
        rtol=STATE_TOL["rtol"],
        atol=1e-4 * LR if optimizer == "adam" else STATE_TOL["atol"]))
    # the tables trained, and went back to no grad
    assert all(not torch.equal(a, b) and not b.requires_grad
               for a, b in zip(tables, pm.embedding.tp))
    if optimizer == "adagrad":
        assert set(state["sum_of_squares"]) == set(dict(
            pm.named_parameters()))


def test_fit_sparse_and_dense_paths():
    """Both paths learn four batches of the click stream, cycled (their
    losses fall), and callbacks see every step."""
    gen = _gen(seed=11)
    for sparse in (True, False):
        _, _, pm = _models()
        seen = []

        class Cb:
            def on_step(self, step, model, loss):
                seen.append(step)

        _, _, hist = pt_training.fit(
            pm, lambda s: gen.batch(s % 4), 25, "adagrad", lr=0.3,
            sparse=sparse,
            callbacks=(pt_training.BroadcastGlobalVariablesCallback(), Cb()),
            log_every=0)
        first, last = np.mean(hist["loss"][:5]), np.mean(hist["loss"][-5:])
        assert last < first, (sparse, hist["loss"])
        assert seen == list(range(25))


@pytest.mark.parametrize("sparse", [True, False])
def test_fit_pipelined_matches_serial(sparse):
    """The same batches in the same order: losses, eval AUCs, tables and
    optimizer state bit-identical with and without the worker threads."""
    gen = _gen(seed=2)
    runs = []
    for pipelined in (True, False):
        _, _, pm = _models()
        _, state, hist = pt_training.fit(
            pm, (gen.batch(s) for s in range(6)), 6, "adam", lr=LR,
            sparse=sparse, pipelined=pipelined, pipeline_depth=1,
            eval_data=lambda j: gen.batch(900 + j), eval_every=3,
            eval_steps=2, log_every=0, log_fn=_quiet)
        runs.append((hist, {k: v.clone() for k, v in pm.state_dict().items()},
                     state))
    (h1, m1, _), (h2, m2, _) = runs
    assert h1["loss"] == h2["loss"] and h1["eval_auc"] == h2["eval_auc"]
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(v["count"] == 6 for v in h1["ingest_stages"].values())


def test_fit_reads_no_more_than_its_steps():
    _, _, pm = _models()
    gen = _gen()
    source = iter([gen.batch(j) for j in range(6)])
    pt_training.fit(pm, source, 4, "sgd", log_every=0)
    assert len(list(source)) == 2


def test_make_train_step_and_apply_updates():
    """The dense step by hand: `make_train_step` over a `DenseOptimizer`
    and a `DistributedOptimizer` give the same model; `apply_updates`
    adds in place."""
    gen = _gen()
    models = []
    for wrap in (False, True):
        _, _, pm = _models()
        opt = pt_training.adagrad(LR)
        if wrap:
            opt = pt_training.DistributedOptimizer(opt)
        step = pt_training.make_train_step(
            lambda m, *b: m.loss_fn(*b), opt, donate=True)
        state = opt.init(dict(pm.named_parameters()))
        for s in range(2):
            pm, state, loss = step(pm, state, *gen.batch(s))
        models.append(pm.state_dict())
    assert all(torch.equal(models[0][k], models[1][k]) for k in models[0])
    params = {"a": torch.ones(3)}
    out = pt_training.apply_updates(params, {"a": torch.full((3,), 0.5)})
    assert out is params and torch.equal(params["a"], torch.full((3,), 1.5))
