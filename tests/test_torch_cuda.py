"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Run on the machine
with the card (no jax there, so without the repository's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_embeddings_tpu_torch.ops import cuda_lookup, cuda_sparse  # noqa: E402
from distributed_embeddings_tpu_torch.ops import sparse_update  # noqa: E402
from distributed_embeddings_tpu_torch.tools import cuda_feature_probe  # noqa: E402

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


# ------------------------------------------------ sorted-stream kernels
from distributed_embeddings_tpu_torch.ops import cuda_tiled  # noqa: E402
from distributed_embeddings_tpu_torch.ops import embedding_ops  # noqa: E402


@pytest.mark.parametrize("width", [8, 16, 6, 128, 256])
@pytest.mark.parametrize("key_dtype", ["int32", "int64"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_sorted_matches_plain_bit_for_bit(gen, width, key_dtype,
                                                 weighted):
    vocab, n = 900, 5000
    table = torch.empty((vocab, width), device="cuda").uniform_(
        -0.05, 0.05, generator=gen)
    sid, _ = torch.sort(torch.randint(-3, vocab + 4, (n,), device="cuda",
                                      generator=gen))
    sid = sid.to(getattr(torch, key_dtype))
    w = (torch.rand((n,), device="cuda", generator=gen) if weighted
         else None)
    launches = cuda_tiled.launches["gather_sorted"]
    got = cuda_tiled.gather_sorted(table, sid, w)
    want = cuda_tiled.gather_sorted_plain(table, sid, w)
    torch.cuda.synchronize()
    assert cuda_tiled.launches["gather_sorted"] == launches + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("width", [8, 16, 6, 128, 256])
@pytest.mark.parametrize("key_dtype", ["int32", "int64"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_sorted_perm_matches_plain_bit_for_bit(gen, width, key_dtype,
                                                      weighted):
    """The perm form (each row stored at its place in the stream, weights
    in stream order) on the sort of a random stream with keys < 0 and
    >= V, one launch a call; the inv form (by output row) gives the same
    rows."""
    vocab, n = 900, 5000
    table = torch.empty((vocab, width), device="cuda").uniform_(
        -0.05, 0.05, generator=gen)
    ids = torch.randint(-3, vocab + 4, (n,), device="cuda", generator=gen)
    sid, perm = torch.sort(ids, stable=True)
    sid = sid.to(getattr(torch, key_dtype))
    w = (torch.rand((n,), device="cuda", generator=gen) if weighted
         else None)
    launches = cuda_tiled.launches["gather_sorted"]
    got = cuda_tiled.gather_sorted(table, sid, w, perm=perm)
    want = cuda_tiled.gather_sorted_plain(table, sid, w, perm=perm)
    torch.cuda.synchronize()
    assert cuda_tiled.launches["gather_sorted"] == launches + 1
    assert torch.equal(got, want)
    valid = (ids >= 0) & (ids < vocab)
    assert torch.equal(got[valid], (table[ids[valid]] if w is None
                                    else table[ids[valid]] * w[valid, None]))
    assert not got[~valid].any()


def test_gather_sorted_perm_on_an_empty_stream(gen):
    table = torch.ones((10, 8), device="cuda")
    empty = torch.zeros(0, dtype=torch.int64, device="cuda")
    launches = cuda_tiled.launches["gather_sorted"]
    got = cuda_tiled.gather_sorted(table, empty, torch.zeros(0, device="cuda"),
                                   perm=empty)
    assert got.shape == (0, 8)
    assert cuda_tiled.launches["gather_sorted"] == launches


@pytest.mark.parametrize("width", [8, 16, 6, 128, 256])
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_stream_kernels_match_plain_bit_for_bit(gen, width, kind):
    """Three accumulating steps on duplicate-heavy streams with ids out of
    range, the kernel and its plain version on the card."""
    vocab = 600
    table = torch.empty((vocab, width), device="cuda").uniform_(
        -0.05, 0.05, generator=gen)
    init = 0.1 if kind == "adagrad" else 0.0
    states = [torch.full_like(table, init)
              for _ in range({"sgd": 0, "adagrad": 1, "adam": 2}[kind])]
    ref = [t.clone() for t in [table] + states]
    kernel = getattr(cuda_tiled, f"{kind}_stream")
    plain = getattr(cuda_tiled, f"{kind}_stream_plain")
    for step in range(1, 4):
        ids, contribs = _stream(gen, vocab, 3000, width)
        gs = embedding_ops.canonical_id_sort(ids, vocab)
        starts, _ = embedding_ops.segment_bounds(gs.seg_start)
        args = (contribs, gs.sid, gs.perm, starts, 0.05)
        if kind == "adagrad":
            args += (1e-7,)
        elif kind == "adam":
            c1, c2 = sparse_update.bias_corrections(step, 0.9, 0.999)
            args += (0.9, 0.999, 1e-8, c1, c2)
        launches = cuda_tiled.launches[f"{kind}_stream"]
        kernel(table, *states, *args)
        plain(*ref, *args)
        torch.cuda.synchronize()
        assert cuda_tiled.launches[f"{kind}_stream"] == launches + 1
    for got, want in zip([table] + states, ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("path", ["tiled", "fused"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_sorted_lookups_and_backward_match_the_cpu(gen, path, combiner):
    """Forward and both gradients of the sorted lookups on the card against
    the same calls on CPU copies (plain versions): the table gradient of
    a sum bit for bit (the stream sgd at lr -1 sums in sorted order on
    both), everything else at rtol 1e-5 (the hotness sums, einsums and the
    mean's weight sums run in the libraries' own order)."""
    fn = {"tiled": cuda_tiled.tiled_embedding_lookup,
          "fused": cuda_tiled.fused_lookup_combine}[path]
    vocab, batch, hot, width = 500, 700, 10, 16
    table = torch.empty((vocab, width), device="cuda").uniform_(
        -0.05, 0.05, generator=gen)
    ids = torch.randint(-2, vocab + 2, (batch, hot), device="cuda",
                        generator=gen).int()
    weights = torch.rand((batch, hot), device="cuda", generator=gen)
    cot = torch.randn((batch, width), device="cuda", generator=gen)
    outs = []
    for dev in ("cuda", "cpu"):
        t = table.to(dev).requires_grad_()
        w = weights.to(dev).requires_grad_()
        out = fn(t, ids.to(dev), w, combiner)
        dt, dw = torch.autograd.grad((out * cot.to(dev)).sum(), [t, w])
        outs.append([x.detach().cpu() for x in (out, dt, dw)])
    (out, dt, dw), (out_c, dt_c, dw_c) = outs
    if combiner == "sum":
        assert torch.equal(dt, dt_c)
    torch.testing.assert_close(dt, dt_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out, out_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, dw_c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rung", [r.name for r in cuda_feature_probe.RUNGS])
def test_feature_ladder_rung_matches_plain_bit_for_bit(gen, rung):
    """Every rung of the feature ladder on the card: each kernel bit-equal
    to its plain version on the JAX rung's inputs and on the distinct-row
    inputs (rungs 1-7), launched once per input set."""
    (entry,) = [r for r in cuda_feature_probe.RUNGS if r.name == rung]
    counts = dict(cuda_feature_probe.launches)
    err, _ = entry.run(torch.device("cuda"))
    torch.cuda.synchronize()
    assert err == 0.0
    if entry.library in cuda_feature_probe.launches:
        assert (cuda_feature_probe.launches[entry.library]
                == counts[entry.library] + 2)


# ------------------------------------------------------ the segment walk
# The shared walk of `segment_sum_sorted` and the stream kernels
# (csrc/segment_walk.cuh): segments of at most T = `cuda_sparse.long_rows()`
# rows are summed by their thread group, longer ones by the long pass.
WALK_SHAPES = ["one_segment", "around_threshold", "more_long_than_workers",
               "long_invalid_keys", "empty"]
WALK_WIDTHS = [1, 3, 8, 16, 128, 132, 256]


def _walk_stream(shape, vocab):
    """(sid, perm, starts) on the card of a sorted stream whose segment
    lengths are chosen around T: one segment covering all N; lengths T-1,
    T and T+1 among short ones; more segments longer than T than the long
    pass has blocks; long segments keyed -2 and V+1 (the stream kernels
    skip them unread) beside a long valid one; N = 0. Keys are drawn
    shuffled (numpy, seeded), so perm is no identity."""
    t = cuda_sparse.long_rows()
    workers = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.RandomState(5)
    if shape == "one_segment":
        keys, lengths = [7], [4 * t + 3]
    elif shape == "around_threshold":
        keys = list(range(60))
        lengths = [t - 1, t, t + 1] + list(rng.randint(1, 9, size=57))
    elif shape == "more_long_than_workers":
        keys = list(range(2 * workers + 5))
        lengths = list(t + 1 + rng.randint(0, 2 * t, size=len(keys)))
    elif shape == "long_invalid_keys":
        keys = [-2, 3, 4, 9, vocab + 1]
        lengths = [t + 5, 2, t + 1, 3 * t, 2 * t + 3]
    else:
        keys, lengths = [], []
    ids = rng.permutation(np.repeat(np.array(keys, dtype=np.int64),
                                    np.array(lengths, dtype=np.int64)))
    dtype = torch.int64 if shape in ("one_segment", "more_long_than_workers") \
        else torch.int32
    sid, perm = torch.sort(torch.from_numpy(ids).to("cuda", dtype),
                           stable=True)
    starts, _ = embedding_ops.segment_bounds(embedding_ops.segment_starts(sid))
    return sid, perm, starts


@pytest.mark.parametrize("width", WALK_WIDTHS)
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_segment_walk_sum_matches_plain_bit_for_bit(gen, shape, width):
    """`segment_sum_sorted` on every segment shape: bit-equal to its plain
    version on CPU copies (both add each segment in sorted order), zeros in
    the slots past the last segment; one counted launch a call (none for
    N = 0)."""
    _, perm, starts = _walk_stream(shape, 600)
    n = perm.shape[0]
    contribs = torch.randn((n, width), device="cuda", generator=gen)
    launches = cuda_sparse.launches["segment_sum_sorted"]
    got = cuda_sparse.segment_sum_sorted(contribs, perm, starts)
    torch.cuda.synchronize()
    assert cuda_sparse.launches["segment_sum_sorted"] == launches + (n > 0)
    want = cuda_sparse.segment_sum_sorted_plain(contribs.cpu(), perm.cpu(),
                                                starts.cpu())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("width", WALK_WIDTHS)
@pytest.mark.parametrize("shape", WALK_SHAPES)
@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_segment_walk_streams_match_plain_bit_for_bit(gen, kind, shape,
                                                      width):
    """The stream kernels on every segment shape: table and state bit-equal
    to the plain versions (sums on the CPU in sorted order); segments keyed
    outside [0, V) leave every row alone; one counted launch a call (none
    for N = 0)."""
    vocab = 600
    sid, perm, starts = _walk_stream(shape, vocab)
    n = sid.shape[0]
    contribs = torch.randn((n, width), device="cuda", generator=gen)
    table = torch.empty((vocab, width), device="cuda").uniform_(
        -0.05, 0.05, generator=gen)
    init = 0.1 if kind == "adagrad" else 0.0
    states = [torch.full_like(table, init)
              for _ in range({"sgd": 0, "adagrad": 1, "adam": 2}[kind])]
    ref = [t.clone() for t in [table] + states]
    args = (contribs, sid, perm, starts, 0.05)
    if kind == "adagrad":
        args += (1e-7,)
    elif kind == "adam":
        args += (0.9, 0.999, 1e-8) + sparse_update.bias_corrections(1, 0.9,
                                                                    0.999)
    launches = cuda_tiled.launches[f"{kind}_stream"]
    getattr(cuda_tiled, f"{kind}_stream")(table, *states, *args)
    torch.cuda.synchronize()
    assert cuda_tiled.launches[f"{kind}_stream"] == launches + (n > 0)
    getattr(cuda_tiled, f"{kind}_stream_plain")(*ref, *args)
    for got, want in zip([table] + states, ref):
        assert torch.equal(got, want)


def test_stager_stages_in_a_thread_and_the_consumer_takes(gen):
    """The ingest pipeline's split: `DeviceStager.stage` in a worker thread
    (more batches than pinned slots, so each slot is refilled), `take` in
    this one, after a kernel queued on its stream: every batch arrives
    whole, and the staged buffer is tied to the consumer's stream."""
    import threading

    from distributed_embeddings_tpu_torch.parallel.staging import (
        PINNED_SLOTS, DeviceStager)
    stager = DeviceStager("cuda")
    rng = np.random.RandomState(0)
    batches = [(rng.rand(4096, 13).astype(np.float32),
                [rng.randint(0, 1 << 20, (4096, 3)).astype(np.int64)])
               for _ in range(PINNED_SLOTS + 2)]
    staged = []
    worker = threading.Thread(
        target=lambda: staged.extend(stager.stage(b) for b in batches))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and len(staged) == len(batches)
    busy = torch.randn(4096, 4096, device="cuda", generator=gen)
    for want, item in zip(batches, staged):
        busy = busy @ busy / 64.0          # work ahead on the stream
        num, (ids,) = item.take()
        assert num.device.type == ids.device.type == "cuda"
        assert torch.equal(num.cpu(), torch.from_numpy(want[0]))
        assert torch.equal(ids.cpu(), torch.from_numpy(want[1][0]))
