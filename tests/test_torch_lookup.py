"""The port's lookup ops on the CPU against the JAX package's.

`ops.cuda_lookup` (plain version on CPU tensors) is held against the Pallas
kernels it replaces, run in interpret mode as tests/test_pallas_lookup.py
runs them, and `ops.embedding_ops` against its JAX counterpart. Inputs come
from a numpy seed. Tolerance rtol 1e-5 / atol 1e-6: the two sides sum the K
terms in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu.layers import embedding as jax_embedding  # noqa: E402
from distributed_embeddings_tpu.ops import embedding_ops as jax_ops  # noqa: E402
from distributed_embeddings_tpu.ops import pallas_lookup  # noqa: E402
from distributed_embeddings_tpu_torch.layers import embedding as pt_embedding  # noqa: E402
from distributed_embeddings_tpu_torch.ops import cuda_lookup  # noqa: E402
from distributed_embeddings_tpu_torch.ops import embedding_ops as pt_ops  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _case(batch, hot, vocab, width, seed=0, oob=False):
    rng = np.random.RandomState(seed)
    table = rng.uniform(-1, 1, (vocab, width)).astype(np.float32)
    lo, hi = (-3, vocab + 3) if oob else (0, vocab)
    ids = rng.randint(lo, hi, size=(batch, hot)).astype(np.int32)
    weights = (rng.rand(batch, hot) > 0.3).astype(np.float32) * rng.rand(
        batch, hot).astype(np.float32)
    return table, ids, weights


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("vocab,width", [(300, 8), (9000, 128), (9000, 16)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fused_lookup_vs_pallas(vocab, width, combiner, weighted):
    """V <= 8192 reaches the one-hot kernel, V > 8192 at W=128 the DMA
    kernel, V > 8192 at W=16 the JAX package's XLA route."""
    table, ids, weights = _case(24, 5, vocab, width, oob=True)
    w = weights if weighted else None
    want = pallas_lookup.fused_embedding_lookup(
        jnp.asarray(table), jnp.asarray(ids),
        None if w is None else jnp.asarray(w), combiner, interpret=True)
    got = cuda_lookup.fused_embedding_lookup(
        torch.from_numpy(table), torch.from_numpy(ids).long(),
        None if w is None else torch.from_numpy(w), combiner)
    assert got.dtype == torch.float32 and got.shape == (24, width)
    _close(got, want)


@pytest.mark.parametrize("width,hot", [(8, 1), (16, 10), (128, 3)])
def test_kernel_contract_vs_onehot_kernel(width, hot):
    table, ids, weights = _case(40, hot, 700, width, seed=1)
    want = pallas_lookup._onehot_lookup(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(weights),
        tile_b=16, tile_v=128, interpret=True)
    got = cuda_lookup.lookup_combine(torch.from_numpy(table),
                                     torch.from_numpy(ids),
                                     torch.from_numpy(weights))
    _close(got, want)


@pytest.mark.parametrize("width,hot,id_dtype", [(16, 1, np.int32),
                                                (16, 10, np.int64),
                                                (128, 4, np.int32)])
def test_kernel_contract_vs_dma_gather_kernel(width, hot, id_dtype):
    table, ids, weights = _case(20, hot, 9000, width, seed=2)
    want = pallas_lookup._dma_gather_lookup(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(weights),
        interpret=True)
    got = cuda_lookup.lookup_combine(
        torch.from_numpy(table), torch.from_numpy(ids.astype(id_dtype)),
        torch.from_numpy(weights))
    _close(got, want)


def test_plain_clamps_out_of_range_and_negative_ids():
    table, _, _ = _case(1, 1, 50, 8)
    ids = np.array([[-7, 0, 49, 50, 10**6]], np.int64)
    got = cuda_lookup.lookup_combine(torch.from_numpy(table),
                                     torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(
        got[0], table[0] + table[0] + table[49] + table[49] + table[49])


def test_unweighted_hotness_one_is_a_plain_gather():
    table, ids, _ = _case(64, 1, 500, 16, seed=3)
    got = cuda_lookup.lookup_combine(torch.from_numpy(table),
                                     torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), table[ids[:, 0]])


@pytest.mark.parametrize("combiner", [None, "sum", "mean"])
def test_embedding_lookup_dense(combiner):
    table, ids, _ = _case(12, 4, 100, 8, seed=4)
    want = jax_ops.embedding_lookup(jnp.asarray(table), jnp.asarray(ids),
                                    combiner)
    got = pt_ops.embedding_lookup(torch.from_numpy(table),
                                  torch.from_numpy(ids), combiner)
    _close(got, want)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_lookup_ragged(combiner):
    rng = np.random.RandomState(5)
    table = rng.randn(60, 16).astype(np.float32)
    lengths = np.array([3, 0, 1, 5, 2], np.int32)
    nnz = int(lengths.sum())
    values = rng.randint(0, 60, size=nnz + 3).astype(np.int32)  # 3 padded
    splits = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    want = jax_ops.embedding_lookup(
        jnp.asarray(table),
        jax_ops.RaggedIds(jnp.asarray(values), jnp.asarray(splits)), combiner)
    got = pt_ops.embedding_lookup(
        torch.from_numpy(table),
        pt_ops.RaggedIds(torch.from_numpy(values), torch.from_numpy(splits)),
        combiner)
    _close(got, want)
    pad_j = jax_ops.ragged_to_padded(
        jax_ops.RaggedIds(jnp.asarray(values), jnp.asarray(splits)), 5)
    pad_t = pt_ops.ragged_to_padded(
        pt_ops.RaggedIds(torch.from_numpy(values), torch.from_numpy(splits)),
        5)
    for a, b in zip(pad_t, pad_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_lookup_sparse(combiner):
    rng = np.random.RandomState(6)
    table = rng.randn(40, 8).astype(np.float32)
    indices = np.array([[0, 0], [0, 2], [2, 1], [3, 0], [3, 1], [3, 3]],
                       np.int64)
    values = rng.randint(0, 40, size=len(indices)).astype(np.int64)
    want = jax_ops.embedding_lookup(
        jnp.asarray(table),
        jax_ops.SparseIds(jnp.asarray(indices), jnp.asarray(values), (5, 4)),
        combiner)
    got = pt_ops.embedding_lookup(
        torch.from_numpy(table),
        pt_ops.SparseIds(torch.from_numpy(indices), torch.from_numpy(values),
                         (5, 4)),
        combiner)
    _close(got, want)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_lookup_weighted(combiner):
    table, ids, weights = _case(16, 6, 80, 16, seed=7)
    want = jax_ops.embedding_lookup_weighted(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(weights), combiner)
    got = pt_ops.embedding_lookup_weighted(
        torch.from_numpy(table), torch.from_numpy(ids).long(),
        torch.from_numpy(weights), combiner)
    _close(got, want)


@pytest.mark.parametrize("combiner,shape", [("sum", (9, 4)), ("mean", (9, 4)),
                                            (None, (9,)), ("sum", (3, 2, 5))])
def test_embedding_layer(combiner, shape):
    """The combined multi-hot path of the layer goes through the kernel's
    wrapper; the JAX layer takes its XLA route on the CPU."""
    table, _, _ = _case(1, 1, 120, 8, seed=8)
    ids = np.random.RandomState(9).randint(0, 120, size=shape).astype(np.int32)
    jl = jax_embedding.Embedding(120, 8, combiner=combiner)
    want = jl({"embeddings": jnp.asarray(table)}, jnp.asarray(ids))
    pl_ = pt_embedding.Embedding(120, 8, combiner=combiner, device="cpu")
    with torch.no_grad():
        pl_.embeddings.copy_(torch.from_numpy(table))
    launches = dict(cuda_lookup.launches)
    got = pl_(torch.from_numpy(ids))
    assert cuda_lookup.launches == launches      # no kernel on the CPU
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
