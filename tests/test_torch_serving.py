"""The port's InferenceEngine and MicroBatcher against the JAX package's.

Cut-down Tiny V3 (tables at most 1,000 rows; widths, hotness and sharing as
published), weights carried across from the JAX package, requests padded to
the warmed shapes. Logits agree within rtol/atol 1e-5: the MLPs run through
different CPU BLAS libraries. Both engines get ``example=`` in warmup: the
JAX engine's default warmup block is one column wide for `SyntheticModel`
(ROADMAP Queue C).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu.serving.batcher import MicroBatcher as JaxBatcher  # noqa: E402
from distributed_embeddings_tpu.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_embeddings_tpu_torch import convert  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402
from distributed_embeddings_tpu_torch.serving.batcher import MicroBatcher  # noqa: E402
from distributed_embeddings_tpu_torch.serving.engine import InferenceEngine  # noqa: E402

TOL = 1e-5
SIZES = [16, 64]


def _cut(cfg):
    return cfg._replace(embedding_configs=[
        e._replace(num_rows=min(e.num_rows, 1000))
        for e in cfg.embedding_configs])


@pytest.fixture(scope="module")
def engines():
    jm = jax_synth.SyntheticModel(_cut(jax_synth.SYNTHETIC_MODELS["tiny"]))
    params = jm.init(jax.random.PRNGKey(0))
    pm = pt_synth.SyntheticModel(_cut(pt_synth.SYNTHETIC_MODELS["tiny"]),
                                 device="cpu")
    state = convert.params_from_jax(jax.tree.map(np.asarray, params), pm)
    num, cats, _ = pt_synth.InputGenerator(
        _cut(pt_synth.SYNTHETIC_MODELS["tiny"]), 64, alpha=1.05,
        num_batches=1, seed=0)[0]
    num, cats = num.numpy(), [c.numpy() for c in cats]
    je = JaxEngine(jm, params)
    je.warmup(SIZES, example=(num, cats))
    pe = InferenceEngine(pm, params=state, device="cpu")
    pe.warmup(SIZES, example=(num, cats))
    return je, pe, num, cats


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rows", [1, 10, 33, 64])
def test_predict_matches_jax_engine(engines, rows):
    je, pe, num, cats = engines
    batch = (num[:rows], [c[:rows] for c in cats])
    got = pe.predict(batch)
    assert tuple(got.shape) == (rows, 1)
    _close(got, je.predict(batch))
    assert pe._target_batch(rows) == je._target_batch(rows)


def test_batcher_flush_matches_jax_batcher(engines):
    je, pe, num, cats = engines
    spans = [(0, 5), (5, 12), (12, 40), (40, 64)]
    jb, pb = JaxBatcher(je), MicroBatcher(pe)
    handles = []
    for lo, hi in spans:
        req = (num[lo:hi], [c[lo:hi] for c in cats])
        handles.append((jb.submit(req), pb.submit(req)))
    jres, pres = jb.flush(), pb.flush()
    for hj, hp in handles:
        _close(pres[hp], jres[hj])
    assert pb.batches == jb.batches
    assert pb.summary()["batch_occupancy"] == jb.summary()["batch_occupancy"]


def test_port_warmup_needs_no_example(engines):
    """The port's SyntheticModel carries num_numerical_features, so the
    default warmup batch has the model's real numerical width."""
    _, pe, num, cats = engines
    pe2 = InferenceEngine(pe._model, device="cpu")
    assert pe2.warmup([8]) == [8]
    _close(pe2.predict((num[:3], [c[:3] for c in cats])),
           pe.predict((num[:3], [c[:3] for c in cats])))


def test_engine_counts_rows_and_strips_checkpoints(engines):
    _, pe, num, cats = engines
    before = (pe.n_predicts, pe.rows_served, pe.rows_padded)
    pe.predict((num[:10], [c[:10] for c in cats]))
    assert (pe.n_predicts, pe.rows_served, pe.rows_padded) == (
        before[0] + 1, before[1] + 10, before[2] + 6)
    snap = pe._metrics.snapshot()["counters"]
    assert snap["serve/rows_served"] == pe.rows_served
    state = pe._model.state_dict()
    pe.set_params({"params": state, "opt_state": None})
