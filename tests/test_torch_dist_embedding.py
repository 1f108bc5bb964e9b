"""The port's DistributedEmbedding and models against the JAX package's.

Tiny V3 with every table cut to at most 1,000 rows: widths, hotness, the
table count and the sharing stay as published. The JAX package initializes
the parameters; `convert.params_from_jax` carries them across; both packages
draw the same ids from the same numpy seed. Outputs agree within 1e-5 (the
K-term sums and the MLP products run in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu.layers import dist_model_parallel as jax_dmp  # noqa: E402
from distributed_embeddings_tpu.layers.embedding import Embedding as JaxEmbedding  # noqa: E402
from distributed_embeddings_tpu.models import dlrm as jax_dlrm  # noqa: E402
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu.ops import embedding_ops as jax_ops  # noqa: E402
from distributed_embeddings_tpu_torch import convert  # noqa: E402
from distributed_embeddings_tpu_torch.layers import dist_model_parallel as pt_dmp  # noqa: E402
from distributed_embeddings_tpu_torch.layers.embedding import Embedding as PtEmbedding  # noqa: E402
from distributed_embeddings_tpu_torch.models import dlrm as pt_dlrm  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402
from distributed_embeddings_tpu_torch.ops import cuda_lookup  # noqa: E402
from distributed_embeddings_tpu_torch.ops import embedding_ops as pt_ops  # noqa: E402

TOL = 1e-5
MAX_ROWS = 1000
BATCH = 32


def _cut(cfg):
    return cfg._replace(embedding_configs=[
        e._replace(num_rows=min(e.num_rows, MAX_ROWS))
        for e in cfg.embedding_configs])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def tiny():
    """(jax model, jax params, port model on CPU, numerical, cats)."""
    jm = jax_synth.SyntheticModel(_cut(jax_synth.SYNTHETIC_MODELS["tiny"]))
    params = jm.init(jax.random.PRNGKey(0))
    pm = pt_synth.SyntheticModel(_cut(pt_synth.SYNTHETIC_MODELS["tiny"]),
                                 device="cpu")
    pm.load_state_dict(convert.params_from_jax(_np(params), pm))
    jnum, jcats, _ = jax_synth.InputGenerator(
        _cut(jax_synth.SYNTHETIC_MODELS["tiny"]), BATCH, alpha=1.05,
        num_batches=1, seed=0)[0]
    num, cats, _ = pt_synth.InputGenerator(
        _cut(pt_synth.SYNTHETIC_MODELS["tiny"]), BATCH, alpha=1.05,
        num_batches=1, seed=0)[0]
    np.testing.assert_array_equal(num.numpy(), np.asarray(jnum))
    for a, b in zip(cats, jcats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return jm, params, pm, num, cats


def test_tiny_embedding_outputs_match(tiny):
    jm, params, pm, _, cats = tiny
    want = jm.embedding.apply(params["embedding"],
                              [jnp.asarray(c.numpy()) for c in cats])
    got = pm.embedding(cats)
    assert len(got) == len(want) == 58
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_tiny_logits_match(tiny):
    jm, params, pm, num, cats = tiny
    want = jm.apply(params, jnp.asarray(num.numpy()),
                    [jnp.asarray(c.numpy()) for c in cats])
    with torch.inference_mode():
        got = pm(num, cats)
    assert tuple(got.shape) == (BATCH, 1)
    _close(got, want)


def test_tiny_weighted_inputs_match(tiny):
    """(ids, weights) inputs with zero-weighted padding slots."""
    jm, params, pm, _, cats = tiny
    rng = np.random.RandomState(11)
    jin, pin = [], []
    for i, c in enumerate(cats):
        ids = c.numpy()
        if i % 3 == 0:
            w = (rng.rand(*ids.shape) > 0.25).astype(np.float32) * 0.5
            jin.append((jnp.asarray(ids), jnp.asarray(w)))
            pin.append((torch.from_numpy(ids), torch.from_numpy(w)))
        else:
            jin.append(jnp.asarray(ids))
            pin.append(c)
    want = jm.embedding.apply(params["embedding"], jin)
    for g, w in zip(pm.embedding(pin), want):
        _close(g, w)


def test_get_and_set_weights_match(tiny):
    jm, params, pm, _, _ = tiny
    want = jm.embedding.get_weights(params["embedding"])
    got = pm.embedding.get_weights()
    assert len(got) == len(want) == 55
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    fresh = pt_synth.SyntheticModel(_cut(pt_synth.SYNTHETIC_MODELS["tiny"]),
                                    device="cpu",
                                    generator=torch.Generator().manual_seed(7))
    fresh.embedding.set_weights(want)
    for a, b in zip(fresh.embedding.tp, pm.embedding.tp):
        assert torch.equal(a, b)


def test_params_round_trip(tiny):
    _, params, pm, _, _ = tiny
    back = convert.params_to_numpy(pm)
    flat_j = jax.tree_util.tree_leaves(_np(params))
    flat_p = jax.tree_util.tree_leaves(back)
    assert len(flat_p) == len(flat_j)
    for a, b in zip(flat_p, flat_j):
        np.testing.assert_array_equal(a, b)


def test_tiny_runs_through_the_kernel_wrapper_per_group(tiny, monkeypatch):
    """Every combined group calls the kernel's wrapper once per forward
    (on the CPU the wrapper takes the plain version)."""
    _, _, pm, _, cats = tiny
    calls = []
    real = cuda_lookup.lookup_combine
    monkeypatch.setattr(cuda_lookup, "lookup_combine",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    pm.embedding(cats)
    assert calls == [(BATCH * 31, 1), (BATCH, 10), (BATCH * 24, 1),
                     (BATCH * 2, 10)]


def _mean_layers(hotness_inputs=True):
    tables, tmap, hot = pt_synth.expand_embedding_configs(
        _cut(pt_synth.SYNTHETIC_MODELS["tiny"]))
    return tables, tmap, (hot if hotness_inputs else None)


@pytest.mark.parametrize("weighted", [False, True])
def test_mean_combiner_variant(weighted):
    tables, tmap, hot = _mean_layers()
    jl = jax_dmp.DistributedEmbedding(
        [JaxEmbedding(r, w, combiner="mean") for r, w in tables],
        input_table_map=tmap, input_max_hotness=hot)
    pl_ = pt_dmp.DistributedEmbedding(
        [PtEmbedding(r, w, combiner="mean", device="meta")
         for r, w in tables],
        input_table_map=tmap, input_max_hotness=hot, device="cpu")
    params = jl.init(jax.random.PRNGKey(3))
    pl_.load_state_dict(convert.params_from_jax(_np(params), pl_))
    rng = np.random.RandomState(12)
    jin, pin = [], []
    for t, h in zip(tmap, hot):
        ids = rng.randint(0, tables[t][0], size=(16, h)).astype(np.int32)
        if weighted:
            w = (rng.rand(16, h) > 0.3).astype(np.float32)
            jin.append((jnp.asarray(ids), jnp.asarray(w)))
            pin.append((torch.from_numpy(ids), torch.from_numpy(w)))
        else:
            jin.append(jnp.asarray(ids))
            pin.append(torch.from_numpy(ids))
    want = jl.apply(params, jin)
    for g, w in zip(pl_(pin), want):
        _close(g, w)


def test_ragged_sparse_and_passthrough_inputs():
    """RaggedIds and SparseIds inputs on combined tables, and 1-D / 2-D
    inputs on combiner-None (passthrough) tables."""
    specs = [(50, 8, "sum"), (70, 8, "sum"), (40, 16, None), (30, 16, None)]
    hot = [4, 3, 1, 2]
    jl = jax_dmp.DistributedEmbedding(
        [JaxEmbedding(r, w, combiner=c) for r, w, c in specs],
        input_max_hotness=hot)
    pl_ = pt_dmp.DistributedEmbedding(
        [PtEmbedding(r, w, combiner=c, device="meta") for r, w, c in specs],
        input_max_hotness=hot, device="cpu")
    params = jl.init(jax.random.PRNGKey(4))
    pl_.load_state_dict(convert.params_from_jax(_np(params), pl_))
    rng = np.random.RandomState(13)
    lengths = np.array([2, 0, 4, 1, 3, 4], np.int32)
    values = rng.randint(0, 50, size=int(lengths.sum())).astype(np.int32)
    splits = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    indices = np.array([[0, 0], [1, 2], [2, 0], [2, 1], [4, 2], [5, 0]],
                       np.int64)
    svals = rng.randint(0, 70, size=len(indices)).astype(np.int32)
    ids1 = rng.randint(0, 40, size=6).astype(np.int32)
    ids2 = rng.randint(0, 30, size=(6, 2)).astype(np.int32)
    want = jl.apply(params, [
        jax_ops.RaggedIds(jnp.asarray(values), jnp.asarray(splits)),
        jax_ops.SparseIds(jnp.asarray(indices), jnp.asarray(svals), (6, 3)),
        jnp.asarray(ids1), jnp.asarray(ids2)])
    got = pl_([
        pt_ops.RaggedIds(torch.from_numpy(values), torch.from_numpy(splits)),
        pt_ops.SparseIds(torch.from_numpy(indices), torch.from_numpy(svals),
                         (6, 3)),
        torch.from_numpy(ids1), torch.from_numpy(ids2)])
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_dlrm_logits_match():
    sizes = [40, 7, 300, 25, 1000]
    jm = jax_dlrm.DLRM(sizes, embedding_dim=16, bottom_mlp_dims=(32, 16),
                       top_mlp_dims=(32, 1), num_numerical_features=5)
    pm = pt_dlrm.DLRM(sizes, embedding_dim=16, bottom_mlp_dims=(32, 16),
                      top_mlp_dims=(32, 1), num_numerical_features=5,
                      device="cpu")
    params = jm.init(jax.random.PRNGKey(5))
    pm.load_state_dict(convert.params_from_jax(_np(params), pm))
    rng = np.random.RandomState(14)
    num = rng.rand(24, 5).astype(np.float32)
    cats = [rng.randint(0, v, size=24).astype(np.int32) for v in sizes]
    want = jm.apply(params, jnp.asarray(num), [jnp.asarray(c) for c in cats])
    with torch.inference_mode():
        got = pm(torch.from_numpy(num), [torch.from_numpy(c) for c in cats])
    _close(got, want)
