"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Run on the machine
with the card (no jax there, so without the repository's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from distributed_embeddings_tpu_torch.ops import cuda_lookup, cuda_sparse  # noqa: E402
from distributed_embeddings_tpu_torch.ops import sparse_update  # noqa: E402

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


def _stream(gen, vocab, n, width):
    """A gradient stream with duplicates, negative ids and ids >= V."""
    ids = torch.randint(0, vocab, (n,), device="cuda", generator=gen)
    ids[::7] = ids[0]
    ids[::11] = -3
    ids[5::13] = vocab + 2
    contribs = torch.randn((n, width), device="cuda", generator=gen)
    return ids.int(), contribs


@pytest.mark.parametrize("width", [8, 16, 6, 128, 256])
def test_segment_sum_matches_plain_bit_for_bit(gen, width):
    ids, contribs = _stream(gen, 500, 4000, width)
    launches = cuda_sparse.launches["segment_sum_sorted"]
    rep, sums = sparse_update.dedup_sum(ids, contribs, 500)
    assert cuda_sparse.launches["segment_sum_sorted"] == launches + 1
    rep_cpu, sums_cpu = sparse_update.dedup_sum(ids.cpu(), contribs.cpu(),
                                                500)
    assert torch.equal(rep.cpu(), rep_cpu)
    assert torch.equal(sums.cpu(), sums_cpu)


@pytest.mark.parametrize("width", [8, 16, 6, 128, 256])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("rep_dtype", ["int32", "int64"])
def test_row_kernels_match_plain_bit_for_bit(gen, width, kind, rep_dtype):
    vocab = 700
    table = torch.empty((vocab, width), device="cuda").uniform_(
        -0.05, 0.05, generator=gen)
    init = 0.1 if kind == "adagrad" else 0.0
    states = [torch.full_like(table, init)
              for _ in range({"sgd": 0, "adagrad": 1, "adam": 2}[kind])]
    ref = [t.clone() for t in [table] + states]
    for step in range(1, 4):
        ids, contribs = _stream(gen, vocab, 3000, width)
        rep, sums = sparse_update.dedup_sum(ids, contribs, vocab)
        rep = rep.to(getattr(torch, rep_dtype))
        launches = cuda_sparse.launches[f"{kind}_rows"]
        if kind == "sgd":
            cuda_sparse.sgd_rows(table, rep, sums, 0.05)
            cuda_sparse.sgd_rows_plain(ref[0], rep, sums, 0.05)
        elif kind == "adagrad":
            cuda_sparse.adagrad_rows(table, states[0], rep, sums, 0.05, 1e-7)
            cuda_sparse.adagrad_rows_plain(ref[0], ref[1], rep, sums, 0.05,
                                           1e-7)
        else:
            c1, c2 = sparse_update.bias_corrections(step, 0.9, 0.999)
            args = (rep, sums, 0.05, 0.9, 0.999, 1e-8, c1, c2)
            cuda_sparse.adam_rows(table, *states, *args)
            cuda_sparse.adam_rows_plain(*ref, *args)
        torch.cuda.synchronize()
        assert cuda_sparse.launches[f"{kind}_rows"] == launches + 1
    for got, want in zip([table] + states, ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_train_step_matches_cpu_trainer(gen, optimizer):
    """Cut-down Tiny: three steps on the card against a CPU trainer built
    from the same weights (plain versions by construction)."""
    from distributed_embeddings_tpu_torch.models import synthetic
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    cfg = synthetic.SYNTHETIC_MODELS["tiny"]
    cfg = cfg._replace(embedding_configs=[
        e._replace(num_rows=min(e.num_rows, 1000))
        for e in cfg.embedding_configs])
    cards = synthetic.SyntheticModel(cfg, device="cuda")
    cpu = synthetic.SyntheticModel(cfg, device="cpu")
    cpu.load_state_dict(cards.state_dict())
    steps = [make_sparse_train_step(m, optimizer, lr=0.001)
             for m in (cards, cpu)]
    states = [init(m) for (init, _), m in zip(steps, (cards, cpu))]
    for num, cats, labels in synthetic.InputGenerator(cfg, 256, alpha=1.05,
                                                      num_batches=3, seed=0):
        losses = []
        for i, m in enumerate((cards, cpu)):
            _, states[i], loss = steps[i][1](m, states[i], num, cats, labels)
            losses.append(float(loss))
        assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for a, b in zip(cards.embedding.tp, cpu.embedding.tp):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                   atol=1e-2 * 0.001 if optimizer == "adam"
                                   else 1e-6)
