"""The port's InferenceEngine and MicroBatcher against the JAX package's.

Cut-down Tiny V3 (tables at most 1,000 rows; widths, hotness and sharing as
published), weights carried across from the JAX package, requests padded to
the warmed shapes. Logits agree within rtol/atol 1e-5: the MLPs run through
different CPU BLAS libraries. Both engines get ``example=`` in warmup: the
JAX engine's default warmup block is one column wide for `SyntheticModel`
(ROADMAP Queue C). The fleet's instruments: the batcher's ``replica=``
labels (by default the engine's), `queued_rows` against the JAX batcher's,
and the ``serve/cache_hit_rate`` gauge and `summary()`'s hit rate over a
cached engine (tests/test_serving.py's offloaded tables) against the JAX
batcher over the JAX cached engine.
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


# ------------------------------------------------ the fleet's instruments
def test_batcher_replica_labels_and_queued_rows(engines):
    """Two replicas' batchers on one registry: ``replica=`` (by default
    the engine's) keeps their families apart and leaves the unlabeled one
    untouched; `queued_rows` counts the true rows queued, as the JAX
    batcher does, and drops to 0 on flush."""
    from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
    je, pe, num, cats = engines
    reg = MetricRegistry()
    reps = {name: InferenceEngine(pe._model, device="cpu", registry=reg,
                                  replica=name) for name in ("ra", "rb")}
    for e in reps.values():
        e.warmup(SIZES, example=(num, cats))
    batchers = {n: MicroBatcher(e, registry=reg) for n, e in reps.items()}
    assert batchers["ra"].replica == "ra"
    jb = JaxBatcher(je)
    spans = [(0, 3), (3, 8), (8, 10), (10, 17)]
    for name, b in batchers.items():
        for lo, hi in spans[:4 if name == "ra" else 1]:
            req = (num[lo:hi], [c[lo:hi] for c in cats])
            b.submit(req)
            if name == "ra":
                jb.submit(req)
    assert batchers["ra"].queued_rows == jb.queued_rows == 17
    assert batchers["ra"].queue_depth == 4
    for b in batchers.values():
        b.flush()
    jb.flush()
    assert batchers["ra"].queued_rows == 0 and batchers["ra"].queue_depth_max == 4
    assert reg.histogram("serve/request_seconds", replica="ra").count == 4
    assert reg.histogram("serve/request_seconds", replica="rb").count == 1
    assert reg.counter("serve/requests", replica="ra").value == 4
    assert reg.counter("serve/batches", replica="rb").value == 1
    assert reg.counter("serve/predicts", replica="rb").value == 1
    assert reg.histogram("serve/request_seconds").count == 0
    assert reg.gauge("serve/cache_hit_rate", replica="ra").value == 0.0
    assert batchers["ra"].summary()["hit_rate"] == jb.summary()["hit_rate"]


def test_batcher_records_the_cache_hit_rate():
    """Over a cached engine the flush sets ``serve/cache_hit_rate`` to the
    engine's hit rate and `summary()` carries it, equal to the JAX
    batcher's over the JAX cached engine on the same requests."""
    from distributed_embeddings_tpu.serving import (
        InferenceEngine as JaxCachedEngine)
    from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
    from test_serving import SPECS, _zipf
    from test_torch_serving_cache import BATCH, _assert_bit_equal, _pair
    layer, jl, params = _pair()
    reg = MetricRegistry()
    eng = InferenceEngine(layer, device="cpu", cache_capacity=256,
                          promote_threshold=1, registry=reg, replica="c0")
    jeng = JaxCachedEngine(jl, params, cache_capacity=256,
                           promote_threshold=1)
    eng.warmup([BATCH])
    jeng.warmup([BATCH])
    pb, jb = MicroBatcher(eng, max_batch=BATCH, registry=reg), JaxBatcher(
        jeng, max_batch=BATCH)
    rng = np.random.RandomState(5)
    for _ in range(3):
        handles = []
        for n in (3, 5, 2, 7, 4):
            req = [_zipf(rng, v, n) for v, _, _ in SPECS]
            handles.append((pb.submit(req), jb.submit(req)))
        pres, jres = pb.flush(), jb.flush()
        for hp, hj in handles:
            _assert_bit_equal(pres[hp], jres[hj], "batched request")
    hits, misses = eng.cache_stats()["hits"], eng.cache_stats()["misses"]
    assert hits > 0
    assert reg.gauge("serve/cache_hit_rate", replica="c0").value == \
        hits / (hits + misses)
    assert pb.summary()["hit_rate"] == jb.summary()["hit_rate"]
    assert pb.batches == jb.batches == 6
