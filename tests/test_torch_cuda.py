"""The CUDA kernel against its plain version, on the card.

Marked ``cuda``: each test skips without a CUDA device. Run on the machine
with the card (no jax there, so without the repository's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from distributed_embeddings_tpu_torch.ops import cuda_lookup  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("width", [8, 16, 6, 128, 256])
@pytest.mark.parametrize("hot", [1, 10])
@pytest.mark.parametrize("id_dtype", ["int32", "int64"])
@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_matches_plain(gen, width, hot, id_dtype, weighted):
    vocab, rows = 3000, 1000
    table = torch.empty((vocab, width), device="cuda").uniform_(
        -0.05, 0.05, generator=gen)
    ids = torch.randint(-2, vocab + 2, (rows, hot), device="cuda",
                        generator=gen).to(getattr(torch, id_dtype))
    w = (torch.rand((rows, hot), device="cuda", generator=gen)
         if weighted else None)
    launches = cuda_lookup.launches
    got = cuda_lookup.lookup_combine(table, ids, w)
    want = cuda_lookup.lookup_combine_plain(table, ids, w)
    torch.cuda.synchronize()
    assert cuda_lookup.launches == launches + 1
    if hot == 1 and not weighted:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_empty_batch_launches_nothing(gen):
    table = torch.zeros((10, 8), device="cuda")
    ids = torch.zeros((0, 3), dtype=torch.int32, device="cuda")
    launches = cuda_lookup.launches
    assert cuda_lookup.lookup_combine(table, ids).shape == (0, 8)
    assert cuda_lookup.launches == launches
