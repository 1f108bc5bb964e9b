"""The port's native host library (native/*.cpp, built by native/loader.py)
against the JAX package: the offloaded buckets' row optimizers
(`host_apply_rows_inplace`, C++) against the JAX function and against
their numpy twin (`host_apply_rows_plain`), the same refusals; the
native prefetcher behind `RawBinaryDataset(use_native_prefetch=True)`
against the JAX reader and ``os.pread``; the library built from the
port's own sources into build/torch_ext/, and a failed build raising in
every consumer."""

import ctypes
import errno
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from distributed_embeddings_tpu.models import data as jax_data
from distributed_embeddings_tpu.ops import sparse_update as jax_sparse
from distributed_embeddings_tpu_torch.models import data as pt_data
from distributed_embeddings_tpu_torch.native import loader
from distributed_embeddings_tpu_torch.ops import kernel_build, sparse_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_NATIVE = os.path.join(REPO, "distributed_embeddings_tpu_torch", "native")
KINDS = ["sgd", "adagrad", "adam"]
# the JAX test's bar for the C++ rules against numpy
# (tests/test_host_apply.py)
HOST_TOL = dict(rtol=1e-6, atol=1e-6)


def _rows(seed, v=64, w=8, n=32):
    """tests/test_host_apply.py's inputs: the JAX package's
    prepare_safe_grad of random ids, and a random table."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, v, n).astype(np.int32)
    contribs = rng.randn(n, w).astype(np.float32)
    rep, sums, valid = (np.asarray(x) for x in jax_sparse.prepare_safe_grad(
        jnp.asarray(ids), jnp.asarray(contribs), v))
    table = rng.randn(v, w).astype(np.float32)
    return table, rep, sums, valid


def _state(kind, table, seed=3):
    rng = np.random.RandomState(seed)
    if kind == "sgd":
        return ()
    if kind == "adagrad":
        return (np.abs(rng.randn(*table.shape)).astype(np.float32) + 0.1,)
    return (rng.randn(*table.shape).astype(np.float32) * 0.01,
            np.abs(rng.randn(*table.shape)).astype(np.float32) * 0.01, 3)


def _copies(table, state):
    return table.copy(), tuple(np.copy(s) if np.ndim(s) else s
                               for s in state)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS + ["set"])
def test_cpp_apply_matches_jax(kind, seed):
    table, rep, sums, valid = _rows(seed)
    st = _state("sgd" if kind == "set" else kind, table)
    hp = {"adagrad": {"eps": 1e-7}, "adam": {"b1": 0.8, "eps": 1e-6}}.get(
        kind, {})
    ours, ref = _copies(table, st), _copies(table, st)
    before = loader.calls["host_apply"]
    sparse_update.host_apply_rows_inplace(kind, *ours, rep, sums, valid,
                                          0.05, **hp)
    assert loader.calls["host_apply"] == before + (kind != "set")
    jax_sparse.host_apply_rows_inplace(kind, *ref, rep, sums, valid, 0.05,
                                       **hp)
    np.testing.assert_array_equal(ours[0], ref[0])
    for a, b in zip(ours[1], ref[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    untouched = np.setdiff1d(np.arange(table.shape[0]), rep[valid > 0])
    np.testing.assert_array_equal(ours[0][untouched], table[untouched])


@pytest.mark.parametrize("kind", KINDS)
def test_cpp_apply_matches_numpy_twin(kind):
    """The C++ loops against the numpy rules: within the JAX test's rtol
    and atol of 1e-6, and in fact bit for bit (each product and sum
    rounded alone on both sides)."""
    table, rep, sums, valid = _rows(0, v=300, w=16, n=200)
    st = _state(kind, table)
    cpp, twin = _copies(table, st), _copies(table, st)
    sparse_update.host_apply_rows_inplace(kind, *cpp, rep, sums, valid, 0.05)
    sparse_update.host_apply_rows_plain(kind, *twin, rep, sums, valid, 0.05)
    for a, b in zip((cpp[0], *cpp[1]), (twin[0], *twin[1])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **HOST_TOL)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(cpp[0], table)


@pytest.mark.parametrize("apply", [sparse_update.host_apply_rows_inplace,
                                   sparse_update.host_apply_rows_plain])
def test_apply_refusals(apply):
    """Both forms refuse what the JAX function refuses: a table or state
    that is not float32, or not C-contiguous, and an unknown rule."""
    table, rep, sums, valid = _rows(11)
    with pytest.raises(TypeError, match="float32"):
        apply("sgd", table.astype(np.float16), (), rep, sums, valid, 0.05)
    with pytest.raises(ValueError, match="C-contiguous"):
        apply("sgd", np.asfortranarray(table), (), rep, sums, valid, 0.1)
    with pytest.raises(ValueError, match="C-contiguous"):
        apply("adagrad", table, (np.zeros_like(table)[:, ::2],), rep,
              sums[:, ::2].copy(), valid, 0.1)
    with pytest.raises(NotImplementedError):
        apply("rmsprop", table, (), rep, sums, valid, 0.05)


# ------------------------------------------------------------ prefetcher
BATCH = 32
N_NUM = 4
TABLE_SIZES = [100, 40000, 7]


def _write(root, n_rows, split="train", seed=0):
    rng = np.random.RandomState(seed)
    base = os.path.join(root, split)
    os.makedirs(base, exist_ok=True)
    rng.randint(0, 2, n_rows).astype(np.bool_).tofile(
        os.path.join(base, "label.bin"))
    rng.rand(n_rows, N_NUM).astype(np.float16).tofile(
        os.path.join(base, "numerical.bin"))
    for i, size in enumerate(TABLE_SIZES):
        dtype = pt_data.get_categorical_feature_type(size)
        rng.randint(0, size, n_rows).astype(dtype).tofile(
            os.path.join(base, f"cat_{i}.bin"))


def _kw(**kw):
    return dict(dict(batch_size=BATCH, numerical_features=N_NUM,
                     categorical_features=list(range(len(TABLE_SIZES))),
                     categorical_feature_sizes=TABLE_SIZES), **kw)


def _same_batch(got, want):
    gn, gc, gl = got
    wn, wc, wl = want
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gl, wl)
    assert gn.dtype == wn.dtype and gl.dtype == wl.dtype
    assert len(gc) == len(wc)
    for a, b in zip(gc, wc):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 3, 10])
def test_native_prefetch_matches_jax_and_pread(tmp_path, depth):
    """Every batch equal to the JAX package's native reader in order, and,
    in order, out of order and over a wrap of `raw_batches`, to its
    os.pread reader and the port's; the last, short batch (the
    files' rows are not a whole number of batches) equal to both os.pread
    readers'. Each read goes through the prefetcher's counter."""
    n_full = 6
    _write(tmp_path, BATCH * n_full + 7)
    ours = pt_data.RawBinaryDataset(str(tmp_path), prefetch_depth=depth,
                                    **_kw())
    plain = pt_data.RawBinaryDataset(str(tmp_path),
                                     use_native_prefetch=False, **_kw())
    jax_native = jax_data.RawBinaryDataset(str(tmp_path), **_kw())
    jax_pread = jax_data.RawBinaryDataset(str(tmp_path),
                                          use_native_prefetch=False, **_kw())
    assert len(ours) == len(plain) == len(jax_pread) == n_full + 1
    before = loader.calls["prefetch"]
    # the JAX package's native reader takes its batches in order only
    for idx in range(n_full):
        _same_batch(ours[idx], jax_native[idx])
    order = list(range(n_full + 1)) + [2, 3, 0, 5, 4, n_full]
    for idx in order:
        got = ours[idx]
        _same_batch(got, plain[idx])
        _same_batch(got, jax_pread[idx])
    assert loader.calls["prefetch"] - before >= (n_full + len(order)) * 5
    assert plain._prefetcher is None
    raw = list(ours.raw_batches(2 * len(ours)))
    want = list(plain.raw_batches(2 * len(plain)))
    assert len(raw) == len(want)
    for a, b in zip(raw, want):
        _same_batch(ours.preprocess(a), plain.preprocess(b))
    ours.close()
    ours.close()
    assert ours._prefetcher is None


def test_native_prefetch_dp_slice_and_valid(tmp_path):
    """The prefetcher under the dp slicing and the valid split, against
    the JAX reader."""
    _write(tmp_path, BATCH * 3, split="test", seed=4)
    kw = _kw(valid=True, offset=8, local_batch_size=8, dp_input=True)
    ours = pt_data.RawBinaryDataset(str(tmp_path), **kw)
    ref = jax_data.RawBinaryDataset(str(tmp_path), **kw)
    for i in range(len(ours)):
        _same_batch(ours[i], ref[i])


def test_native_prefetch_missing_file_raises(tmp_path):
    _write(tmp_path, BATCH * 2)
    os.remove(os.path.join(tmp_path, "train", "cat_1.bin"))
    with pytest.raises(FileNotFoundError):
        pt_data.RawBinaryDataset(str(tmp_path), **_kw())


def _load_then(monkeypatch, act):
    """`loader.load` as the dataset calls it, after the files' existence
    check and before the prefetcher opens them, with `act()` run first."""
    real = loader.load

    def load():
        act()
        return real()
    monkeypatch.setattr(loader, "load", load)


def test_native_prefetch_refuses_a_file_it_cannot_open(tmp_path,
                                                       monkeypatch):
    """A file gone between the dataset's check and the prefetcher's open:
    the prefetcher refuses it, and the dataset raises OSError naming it."""
    _write(tmp_path, BATCH * 2)
    path = os.path.join(tmp_path, "train", "cat_2.bin")
    _load_then(monkeypatch, lambda: os.remove(path))
    with pytest.raises(OSError) as err:
        pt_data.RawBinaryDataset(str(tmp_path), **_kw())
    assert err.value.errno == errno.ENOENT
    assert err.value.filename == path


@pytest.mark.parametrize("depth", [1, 4])
def test_native_prefetch_raises_on_a_failed_read(tmp_path, monkeypatch,
                                                 depth):
    """A file whose reads fail (a directory in its place when the
    prefetcher opens it: pread gives EISDIR) raises OSError at the batch
    that reads it, through the synchronous read and the read-ahead window;
    the dataset still closes."""
    _write(tmp_path, BATCH * 3)
    path = os.path.join(tmp_path, "train", "cat_0.bin")

    def to_directory():
        os.remove(path)
        os.mkdir(path)
    _load_then(monkeypatch, to_directory)
    ds = pt_data.RawBinaryDataset(str(tmp_path), prefetch_depth=depth,
                                  **_kw())
    with pytest.raises(OSError) as err:
        ds[0]
    assert err.value.errno == errno.EISDIR
    assert err.value.filename == path
    ds.close()
    assert ds._prefetcher is None


@pytest.mark.parametrize("depth", [1, 4])
def test_native_prefetch_raises_on_a_file_truncated_after_build(tmp_path,
                                                                depth):
    """A file cut short after the dataset was built: the batches it still
    holds read as the os.pread reader's, the first past its end raises
    OSError (a short read) instead of returning unwritten memory."""
    _write(tmp_path, BATCH * 4)
    ds = pt_data.RawBinaryDataset(str(tmp_path), prefetch_depth=depth,
                                  **_kw())
    plain = pt_data.RawBinaryDataset(str(tmp_path),
                                     use_native_prefetch=False, **_kw())
    want = plain[0]
    path = os.path.join(tmp_path, "train", "numerical.bin")
    os.truncate(path, BATCH * N_NUM * 2 + 10)
    _same_batch(ds[0], want)
    with pytest.raises(OSError, match="shrank") as err:
        ds[1]
    assert err.value.errno == errno.EIO
    assert err.value.filename == path
    ds.close()
    plain.close()


def test_prefetcher_reports_bytes_and_errors(tmp_path):
    """The C interface itself: pf_create returns NULL with the failing
    file's index and errno; pf_read and pf_wait return the bytes read,
    fewer at the file's end, or -errno."""
    lib = loader.load()
    good = tmp_path / "good.bin"
    good.write_bytes(bytes(range(100)))
    err = (ctypes.c_int64 * 2)()

    def create(*paths):
        names = (ctypes.c_char_p * len(paths))(*map(os.fsencode, paths))
        return lib.pf_create(names, len(paths), 2, err)
    assert not create(good, tmp_path / "missing.bin")
    assert (err[0], err[1]) == (1, errno.ENOENT)
    pf = create(good, tmp_path)
    assert pf and err[0] == -1
    buf = np.zeros(64, np.uint8)
    assert lib.pf_read(pf, 0, 10, 64, buf.ctypes.data) == 64
    np.testing.assert_array_equal(buf, np.arange(10, 74))
    assert lib.pf_read(pf, 0, 80, 64, buf.ctypes.data) == 20
    req = lib.pf_submit(pf, 0, 200, 8, buf.ctypes.data)
    assert lib.pf_wait(pf, req) == 0
    assert lib.pf_read(pf, 1, 0, 8, buf.ctypes.data) == -errno.EISDIR
    lib.pf_destroy(pf)


# ------------------------------------------------------------- the build
def test_library_builds_from_the_ports_sources():
    """The library is the port's: built from distributed_embeddings_tpu_
    torch/native/*.cpp (not the JAX package's native/) into
    build/torch_ext/, named by a hash of its sources and flags; no shared
    object lies in the port's package (the build writes none there)."""
    assert os.path.realpath(loader.NATIVE_DIR) == os.path.realpath(
        PORT_NATIVE)
    for name in loader.SOURCES:
        assert os.path.isfile(os.path.join(PORT_NATIVE, name))
    path = loader.library_path()
    assert os.path.dirname(path) == kernel_build.BUILD_DIR
    assert os.path.realpath(loader.load()._name) == os.path.realpath(path)
    assert os.path.isfile(path)
    assert "-ffp-contract=off" in loader.CXX_FLAGS
    shipped = [os.path.join(d, f) for d, _, files in os.walk(
        os.path.join(REPO, "distributed_embeddings_tpu_torch"))
        for f in files if f.endswith(".so")]
    assert shipped == []
    assert loader.gxx_version()


def test_build_failure_raises_in_every_consumer(tmp_path, monkeypatch):
    """A source that does not compile: the prefetcher and the C++ apply
    raise the compiler's error (no os.pread or numpy fallback); the
    os.pread reader and the numpy twin still run."""
    for name in loader.SOURCES:
        (tmp_path / name).write_text(
            "not C++\n" if name == "io.cpp" else
            open(os.path.join(PORT_NATIVE, name)).read())
    monkeypatch.setattr(loader, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(loader, "_LIB", None)
    data = tmp_path / "data"
    _write(data, BATCH * 2)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pt_data.RawBinaryDataset(str(data), **_kw())
    assert len(pt_data.RawBinaryDataset(str(data), use_native_prefetch=False,
                                        **_kw())) == 2
    table, rep, sums, valid = _rows(0)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        sparse_update.host_apply_rows_inplace("sgd", table, (), rep, sums,
                                              valid, 0.1)
    sparse_update.host_apply_rows_plain("sgd", table, (), rep, sums, valid,
                                        0.1)


def test_offloaded_step_applies_through_cpp():
    """A sparse step of a layer with an offloaded bucket (on the CPU)
    applies its host rows through the C++ loops: the counter moves by one
    a step."""
    from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
        DistributedEmbedding)
    from distributed_embeddings_tpu_torch.layers.embedding import Embedding
    from distributed_embeddings_tpu_torch.ops.sparse_update import (
        SparseRowGrad, make_sparse_optimizer)
    layer = DistributedEmbedding(
        [Embedding(50, 4, combiner="sum", device="meta") for _ in range(2)],
        device="cpu", gpu_embedding_size=60)
    assert layer.offloaded_buckets
    opt = make_sparse_optimizer("sgd", 0.1)
    b = layer.offloaded_buckets[0]
    before = loader.calls["host_apply"]
    table = layer.tp[b].data.clone()
    ids = torch.tensor([1, 3, 3, 7], dtype=torch.int32)
    grad = SparseRowGrad(ids, torch.ones((4, 4)))
    layer._host_bucket_update(b, grad, (), opt)
    assert loader.calls["host_apply"] == before + 1
    moved = (layer.tp[b].data != table).any(dim=1).nonzero().flatten()
    assert moved.tolist() == [1, 3, 7]
