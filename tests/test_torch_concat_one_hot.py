"""The port's ConcatOneHotEmbedding against the JAX package's, mirroring
tests/test_misc_api.py's two cases (the forward equal to separate tables,
the gradient routed to the right rows), its weights carried across by
`convert`, and `_overrides_forward` treating it as gather semantics as
the JAX function does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.layers import dist_model_parallel as jax_dmp
from distributed_embeddings_tpu.layers.embedding import (
    ConcatOneHotEmbedding as JaxConcatOneHotEmbedding,
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu_torch import convert
from distributed_embeddings_tpu_torch.layers import dist_model_parallel
from distributed_embeddings_tpu_torch.layers.embedding import (
    ConcatOneHotEmbedding, Embedding)


def _ported(sizes, width, params):
    layer = ConcatOneHotEmbedding(sizes, width, device="cpu")
    layer.load_state_dict(convert.params_from_jax(
        {"params": np.asarray(params["params"])}, layer))
    return layer


def test_matches_separate_tables_and_the_jax_layer():
    sizes, width = [7, 13, 5], 4
    ref = JaxConcatOneHotEmbedding(sizes, width)
    params = ref.init(jax.random.PRNGKey(0))
    layer = _ported(sizes, width, params)
    assert tuple(layer.params.shape) == (sum(sizes), width)
    rng = np.random.RandomState(0)
    ids = np.stack([rng.randint(0, v, size=6) for v in sizes], axis=1)
    out = layer(ids)
    assert tuple(out.shape) == (6, len(sizes), width)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(ref(params, jnp.asarray(ids))))
    offs = np.concatenate([[0], np.cumsum(sizes)])
    table = layer.params.detach().numpy()
    for f, v in enumerate(sizes):
        np.testing.assert_array_equal(out[:, f].numpy(),
                                      table[offs[f]:offs[f + 1]][ids[:, f]])
    back = convert.params_to_numpy(layer)
    np.testing.assert_array_equal(back["params"], np.asarray(params["params"]))
    # int32 and tensor ids alike
    np.testing.assert_array_equal(
        layer(torch.from_numpy(ids.astype(np.int32))).numpy(), out.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_gradient_routes_to_the_right_rows(seed):
    """The gradient of a fused gather lands on each feature's own rows
    (the JAX test's case, then random ids against jax.grad)."""
    layer = ConcatOneHotEmbedding([3, 3], 2, device="cpu")
    layer.params.data.fill_(1.0)
    layer.params.requires_grad_(True)
    (g,) = torch.autograd.grad(layer(np.array([[1, 2]])).sum(),
                               [layer.params])
    expect = np.zeros((6, 2), np.float32)
    expect[1] = 1.0
    expect[3 + 2] = 1.0
    np.testing.assert_array_equal(g.numpy(), expect)

    sizes, width = [4, 9, 6], 3
    ref = JaxConcatOneHotEmbedding(sizes, width)
    params = ref.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    ids = np.stack([rng.randint(0, v, size=10) for v in sizes], axis=1)
    cot = rng.randn(10, len(sizes), width).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(ref(p, jnp.asarray(ids)) * cot))(
        params)["params"]
    layer = _ported(sizes, width, params)
    layer.params.requires_grad_(True)
    (got,) = torch.autograd.grad((layer(ids) * torch.from_numpy(cot)).sum(),
                                 [layer.params])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_overrides_forward_matches_jax():
    """ConcatOneHotEmbedding and Embedding keep gather semantics; a class
    with its own forward does not, unless it declares
    ``det_gather_semantics``, in both packages."""
    class Custom(Embedding):
        def forward(self, inputs):
            return super().forward(inputs) * 2

    class Declared(Custom):
        det_gather_semantics = True

    class JaxCustom(JaxEmbedding):
        def __call__(self, params, inputs):
            return super().__call__(params, inputs) * 2

    class JaxDeclared(JaxCustom):
        det_gather_semantics = True

    pairs = [(ConcatOneHotEmbedding, JaxConcatOneHotEmbedding),
             (Embedding, JaxEmbedding), (Custom, JaxCustom),
             (Declared, JaxDeclared), (None, None)]
    for ours, ref in pairs:
        assert (dist_model_parallel._overrides_forward(ours)
                == jax_dmp._overrides_forward(ref)), ours
    assert not dist_model_parallel._overrides_forward(ConcatOneHotEmbedding)
    assert dist_model_parallel._overrides_forward(Custom)
