"""The port's IntegerLookup (the native C++ map and its numpy twin) against
the JAX package's, case for case with tests/test_integer_lookup.py: the
same numpy keys go through both packages' layers, and the indices,
vocabularies, counts, free slots and sizes must be exactly equal."""

import os

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.layers.embedding import (
    IntegerLookup as JaxIntegerLookup)
from distributed_embeddings_tpu_torch.layers.embedding import IntegerLookup
from distributed_embeddings_tpu_torch.native import loader

BACKENDS = [True, False]


def _pair(max_tokens, use_native):
    """The port's layer and the JAX package's, on the same backend."""
    return (IntegerLookup(max_tokens, use_native=use_native),
            JaxIntegerLookup(max_tokens, use_native=use_native))


def _same_state(ours, ref):
    assert ours.get_vocabulary() == ref.get_vocabulary()
    assert ours.size == ref.size
    np.testing.assert_array_equal(ours.counts(), ref.counts())
    np.testing.assert_array_equal(ours.free_slots(), ref.free_slots())


@pytest.mark.parametrize("use_native", BACKENDS)
def test_backend_is_the_one_asked_for(use_native):
    layer = IntegerLookup(10, use_native=use_native)
    assert layer.native is use_native
    assert IntegerLookup(10).native


@pytest.mark.parametrize("use_native", BACKENDS)
def test_build_and_lookup(use_native):
    ours, ref = _pair(10, use_native)
    keys = np.array([[42, 7], [42, 99], [7, 7]], dtype=np.int64)
    out = ours(keys)
    assert isinstance(out, np.ndarray) and out.dtype == np.int64
    assert out.shape == keys.shape
    assert out[0, 0] == out[1, 0]
    assert out[0, 1] == out[2, 0] == out[2, 1]
    assert out[0, 0] != out[0, 1]
    assert (out > 0).all()
    np.testing.assert_array_equal(out, ref(keys))
    _same_state(ours, ref)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_oov_when_full(use_native):
    ours, ref = _pair(2, use_native)
    keys = np.array([10, 20, 30, 40], dtype=np.int64)
    out = ours(keys)
    assert out.tolist() == [1, 2, 0, 0]
    np.testing.assert_array_equal(out, ref(keys))
    _same_state(ours, ref)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_get_vocabulary(use_native):
    ours, ref = _pair(10, use_native)
    keys = np.array([5, 3, 5, 8], dtype=np.int64)
    ours(keys)
    ref(keys)
    assert ours.get_vocabulary() == [-1, 5, 3, 8]
    _same_state(ours, ref)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_query_only_lookup(use_native):
    ours, ref = _pair(10, use_native)
    for layer in (ours, ref):
        layer(np.array([5, 3], dtype=np.int64))
    probe = np.array([3, 999], dtype=np.int64)
    out = ours.lookup(probe)
    assert out.tolist() == [2, 0]
    np.testing.assert_array_equal(out, ref.lookup(probe))
    assert ours.size == 3               # the query bound nothing
    _same_state(ours, ref)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_tensor_in_tensor_out(use_native):
    """A tensor gives an int64 tensor on its device; a list gives numpy."""
    layer = IntegerLookup(10, use_native=use_native)
    out = layer(torch.tensor([[9, 9], [4, 2]]))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int64
    assert out.device.type == "cpu"
    assert out.tolist() == [[1, 1], [2, 3]]
    assert layer([4, 5]).tolist() == [2, 4]
    assert layer.lookup(torch.tensor([2, 6])).tolist() == [3, 0]


def test_native_matches_numpy():
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 50, size=500).astype(np.int64)
    a = IntegerLookup(max_tokens=30, use_native=True)
    b = IntegerLookup(max_tokens=30, use_native=False)
    ref = JaxIntegerLookup(max_tokens=30, use_native=True)
    for k in (keys, keys[::-1]):
        want = ref(k)
        np.testing.assert_array_equal(a(k), want)
        np.testing.assert_array_equal(b(k), want)
    _same_state(a, ref)
    _same_state(b, ref)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_erase_and_free_slot_reuse(use_native):
    """erase releases a key's index to a free list that later insertions
    reuse (LIFO) before minting new indices; erased keys read as OOV;
    counts reset so a reused index never inherits its tenant's count."""
    ours, ref = _pair(6, use_native)
    for layer in (ours, ref):
        assert layer(np.array([10, 20, 30], np.int64)).tolist() == [1, 2, 3]
    dead = np.array([20, 99], np.int64)
    freed = ours.erase(dead)
    assert freed.tolist() == [2, 0]
    np.testing.assert_array_equal(freed, ref.erase(dead))
    assert ours.free_slots().tolist() == [2]
    assert ours.lookup(np.array([20]))[0] == 0
    assert ours.size == 3
    assert ours.get_vocabulary() == [-1, 10, None, 30]
    _same_state(ours, ref)
    new = np.array([40, 50], np.int64)
    assert ours(new).tolist() == [2, 4]
    ref(new)
    assert ours.free_slots().tolist() == []
    assert ours.get_vocabulary() == [-1, 10, 40, 30, 50]
    assert ours.counts()[2] == 1
    _same_state(ours, ref)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_erase_capacity_recovers(use_native):
    ours, ref = _pair(2, use_native)
    for layer in (ours, ref):
        assert layer(np.array([10, 20, 30], np.int64)).tolist() == [1, 2, 0]
        layer.erase(np.array([10], np.int64))
        assert layer(np.array([30], np.int64)).tolist() == [1]
    _same_state(ours, ref)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_reserved_sentinel_keys_map_to_oov(use_native):
    ours, ref = _pair(8, use_native)
    lo = np.iinfo(np.int64).min
    keys = np.array([lo, lo + 1, 5], np.int64)
    assert ours(keys).tolist() == [0, 0, 1]
    ref(keys)
    assert ours.lookup(keys).tolist() == [0, 0, 1]
    assert ours.erase(keys[:2]).tolist() == [0, 0]
    ref.erase(keys[:2])
    assert ours.size == 2
    assert ours.get_vocabulary() == [-1, 5]
    more = np.array([lo, 6, 7], np.int64)
    ours(more)
    ref(more)
    assert ours.lookup(np.array([5, 6, 7])).tolist() == [1, 2, 3]
    _same_state(ours, ref)


@pytest.mark.parametrize("use_native", BACKENDS)
def test_erase_matches_under_churn(use_native):
    """Random insert/erase churn, deep enough to trigger the native map's
    tombstone rehash: indices, free lists, vocabulary, counts and queries
    equal to the JAX package's numpy twin, round by round."""
    ours = IntegerLookup(max_tokens=200, use_native=use_native)
    ref = JaxIntegerLookup(max_tokens=200, use_native=False)
    rng = np.random.RandomState(0)
    for _ in range(30):
        keys = rng.randint(0, 400, size=300).astype(np.int64)
        np.testing.assert_array_equal(ours(keys), ref(keys))
        dead = rng.choice(400, size=40, replace=False).astype(np.int64)
        np.testing.assert_array_equal(ours.erase(dead), ref.erase(dead))
        probe = rng.randint(0, 500, size=64).astype(np.int64)
        np.testing.assert_array_equal(ours.lookup(probe), ref.lookup(probe))
        _same_state(ours, ref)


def test_parallel_large_batch_matches_sequential():
    """200,000-key batches cross the native map's multi-thread cutover
    (64k keys): its parallel probe and ordered insert give the sequential
    numpy twin's indices, insertion order and counts, and OOV past
    capacity alike."""
    nat = IntegerLookup(max_tokens=50_000, use_native=True)
    twin = IntegerLookup(max_tokens=50_000, use_native=False)
    ref = JaxIntegerLookup(max_tokens=50_000, use_native=False)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, hint, size=200_000).astype(np.int64)
               for hint in (30_000, 45_000)]
    batches.append(rng.randint(50_000, 120_000,
                               size=200_000).astype(np.int64))
    for keys in batches:
        want = ref(keys)
        np.testing.assert_array_equal(nat(keys), want)
        np.testing.assert_array_equal(twin(keys), want)
    _same_state(nat, ref)
    _same_state(twin, ref)
    assert nat.size == 50_001


def test_pool_survives_fork():
    """The map's worker pool respawns in a forked child, which inherits
    none of its threads (fork-start data loaders do exactly this)."""
    nat = IntegerLookup(max_tokens=500_000, use_native=True)
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 400_000, size=200_000).astype(np.int64)
    expect = nat(keys)
    pid = os.fork()
    if pid == 0:
        ok = np.array_equal(nat(keys), expect)
        os._exit(0 if ok else 1)
    _, status = os.waitpid(pid, 0)
    assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0, status


def test_calls_counted():
    """Each translation and query of a batch adds one to the counter;
    the numpy twin adds none."""
    nat = IntegerLookup(8, use_native=True)
    twin = IntegerLookup(8, use_native=False)
    before = loader.calls["integer_lookup"]
    nat(np.array([1, 2]))
    nat.lookup(np.array([1]))
    twin(np.array([1, 2]))
    assert loader.calls["integer_lookup"] == before + 2


def test_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises the compiler's error; there
    is no fallback to the numpy twin and no environment switch."""
    for name in loader.SOURCES:
        (tmp_path / name).write_text(
            "this is not C++\n" if name == "hashmap.cpp" else
            open(os.path.join(loader.NATIVE_DIR, name)).read())
    monkeypatch.setattr(loader, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "_LIB", None)
    monkeypatch.setenv("DET_DISABLE_NATIVE", "1")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        IntegerLookup(10)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        IntegerLookup(10, use_native=True)
    assert not IntegerLookup(10, use_native=False).native


@pytest.mark.parametrize("use_native", BACKENDS)
def test_counts_feed_hot_keys_from_counts(use_native):
    """counts() in the shape `DistributedEmbedding.hot_keys_from_counts`
    takes ([max_tokens + 1], index 0 the OOV slot, cut to the table's
    rows there), giving the JAX package's admitted keys."""
    from distributed_embeddings_tpu.layers.dist_model_parallel import (
        DistributedEmbedding as JaxDistributedEmbedding)
    from distributed_embeddings_tpu.layers.embedding import (
        Embedding as JaxEmbedding)
    from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
        DistributedEmbedding)
    from distributed_embeddings_tpu_torch.layers.embedding import Embedding
    lookups = [_pair(16, use_native) for _ in range(2)]
    rng = np.random.RandomState(5)
    for ours, ref in lookups:
        keys = rng.zipf(1.5, size=64).astype(np.int64) * 1000
        np.testing.assert_array_equal(ours(keys), ref(keys))
    ours, ref = lookups[0]
    ours(np.array([100, 100, 100, 200, 200, 300]))
    ref(np.array([100, 100, 100, 200, 200, 300]))
    c = ours.counts()
    assert c.shape == (17,)
    np.testing.assert_array_equal(c, ref.counts())
    counts = [o.counts() for o, _ in lookups]
    specs = [(16, 4), (16, 4)]
    got = DistributedEmbedding(
        [Embedding(v, w, combiner="sum", device="meta") for v, w in specs],
        device="cpu", hot_rows=4).hot_keys_from_counts(counts)
    want = JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner="sum") for v, w in specs],
        hot_rows=4).hot_keys_from_counts([r.counts() for _, r in lookups])
    assert got.keys() == want.keys() and got
    for b in got:
        np.testing.assert_array_equal(got[b], want[b])


@pytest.mark.parametrize("use_native", BACKENDS)
def test_threads_share_one_layer(use_native):
    """Ingest workers call one layer from several threads: 12 threads
    (more than the cores), a short switch interval, and afterwards every
    key has one index across all threads' outputs, the vocabulary holds
    each distinct key once, the counts sum to every key translated, and
    the counter moved by one a call."""
    import sys
    import threading
    layer = IntegerLookup(5_000, use_native=use_native)
    rng = np.random.RandomState(7)
    work = [[rng.randint(0, 3_000, size=700).astype(np.int64)
             for _ in range(6)] for _ in range(12)]
    outs = [[] for _ in work]
    before = loader.calls["integer_lookup"]

    def run(i):
        for keys in work[i]:
            outs[i].append((keys, layer(keys)))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(work))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    index = {}
    for per_thread in outs:
        assert len(per_thread) == 6
        for keys, ids in per_thread:
            for k, v in zip(keys.tolist(), ids.tolist()):
                assert index.setdefault(k, v) == v
    assert sorted(index.values()) == list(range(1, len(index) + 1))
    assert layer.size == len(index) + 1
    assert int(layer.counts().sum()) == sum(k.size for w in work for k in w)
    if use_native:
        assert loader.calls["integer_lookup"] - before == 12 * 6
