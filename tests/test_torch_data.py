"""The port's datasets and click generator against the JAX package's.

Files in the split-binary Criteo layout written by the test; the port's
`RawBinaryDataset` must return arrays bit-equal to the JAX package's (its
``os.pread`` reader: both packages read the same bytes) for the train and
valid splits, an mp table subset, dp slices, the `read_raw` /
`preprocess` split and `raw_batches` through the port's pipeline.
`DummyDataset` shapes; `ClickGenerator` batches bit-equal to the JAX
package's for a seed and step. Mirrors tests/test_data.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_embeddings_tpu.models import data as jax_data  # noqa: E402
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu_torch.models import data as pt_data  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402
from distributed_embeddings_tpu_torch.utils.pipeline import (  # noqa: E402
    IngestPipeline)

BATCH = 32
N_BATCHES = 5
N_NUM = 4
TABLE_SIZES = [100, 40000, 7]


def write_split_binary(root, n_rows, seed=0, split="train"):
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


def _pair(root, **kw):
    kw = dict(dict(batch_size=BATCH, numerical_features=N_NUM,
                   categorical_features=list(range(len(TABLE_SIZES))),
                   categorical_feature_sizes=TABLE_SIZES), **kw)
    return (pt_data.RawBinaryDataset(str(root), **kw),
            jax_data.RawBinaryDataset(str(root), use_native_prefetch=False,
                                      **kw))


def _assert_batch_equal(got, want):
    gn, gc, gl = got
    wn, wc, wl = want
    assert (gn is None) == (wn is None)
    if wn is not None:
        assert gn.dtype == wn.dtype
        np.testing.assert_array_equal(gn, wn)
    assert gl.dtype == wl.dtype
    np.testing.assert_array_equal(gl, wl)
    assert len(gc) == len(wc)
    for a, b in zip(gc, wc):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_categorical_feature_type_matches_jax():
    for size in (1, 126, 127, 128, 32766, 32767, 40000, 2**31 - 2):
        assert (pt_data.get_categorical_feature_type(size)
                == jax_data.get_categorical_feature_type(size))
    with pytest.raises(RuntimeError):
        pt_data.get_categorical_feature_type(2**31)


@pytest.mark.parametrize("valid", [False, True])
def test_raw_binary_equals_jax(tmp_path, valid):
    write_split_binary(tmp_path, BATCH * N_BATCHES,
                       split="test" if valid else "train")
    ds, ref = _pair(tmp_path, valid=valid)
    assert len(ds) == len(ref) == N_BATCHES
    for b in range(N_BATCHES):
        _assert_batch_equal(ds[b], ref[b])
    with pytest.raises(IndexError):
        ds[N_BATCHES]


def test_raw_binary_partial_last_batch(tmp_path):
    write_split_binary(tmp_path, BATCH * N_BATCHES - 5)
    for drop in (False, True):
        ds, ref = _pair(tmp_path, drop_last_batch=drop)
        assert len(ds) == len(ref) == N_BATCHES - int(drop)
        _assert_batch_equal(ds[len(ds) - 1], ref[len(ref) - 1])


def test_raw_binary_mp_input_reads_own_tables(tmp_path):
    write_split_binary(tmp_path, BATCH * N_BATCHES)
    ds, ref = _pair(tmp_path, categorical_features=[2])
    _assert_batch_equal(ds[1], ref[1])
    assert len(ds[1][1]) == 1


@pytest.mark.parametrize("dp_input,valid", [(True, False), (False, False),
                                            (True, True)])
def test_raw_binary_dp_batch_shard(tmp_path, dp_input, valid):
    write_split_binary(tmp_path, BATCH * N_BATCHES,
                       split="test" if valid else "train")
    ds, ref = _pair(tmp_path, categorical_features=[0, 1], dp_input=dp_input,
                    offset=8, local_batch_size=8, valid=valid)
    for b in (0, 3):
        _assert_batch_equal(ds[b], ref[b])


def test_raw_binary_no_numerical(tmp_path):
    write_split_binary(tmp_path, BATCH * N_BATCHES)
    ds, ref = _pair(tmp_path, numerical_features=0)
    _assert_batch_equal(ds[2], ref[2])


def test_read_raw_preprocess_split(tmp_path):
    write_split_binary(tmp_path, BATCH * N_BATCHES)
    ds, ref = _pair(tmp_path)
    for b in range(N_BATCHES):
        raw = ds.read_raw(b)
        for got, want in zip(raw, ref.read_raw(b)):
            np.testing.assert_array_equal(got, want)
        _assert_batch_equal(ds.preprocess(raw), ref[b])


def test_raw_batches_through_pipeline(tmp_path):
    write_split_binary(tmp_path, BATCH * N_BATCHES)
    ds, ref = _pair(tmp_path)
    steps = N_BATCHES + 2        # wraps, like the train loop's i % len
    pipe = IngestPipeline(ds.raw_batches(steps),
                          [("preprocess", ds.preprocess)])
    out = list(pipe)
    assert len(out) == steps
    for i, got in enumerate(out):
        _assert_batch_equal(got, ref[i % N_BATCHES])
    ds.close()
    ds.close()


def test_dummy_dataset_shapes():
    ds = pt_data.DummyDataset(16, N_NUM, TABLE_SIZES, num_batches=2,
                              hotness=[1, 3, 2])
    ref = jax_data.DummyDataset(16, N_NUM, TABLE_SIZES, num_batches=2,
                                hotness=[1, 3, 2])
    numerical, cats, labels = ds[0]
    assert numerical.shape == (16, N_NUM)
    assert [c.shape for c in cats] == [(16, 1), (16, 3), (16, 2)]
    assert labels.shape == (16, 1)
    _assert_batch_equal(ds[1], ref[1])
    assert len(ds) == 2
    with pytest.raises(IndexError):
        ds[2]
    flat = pt_data.DummyDataset(4, 2, TABLE_SIZES)
    assert [c.shape for c in flat[0][1]] == [(4,)] * 3 and len(flat) == 100


@pytest.mark.parametrize("alpha", [1.05, 0.0])
def test_click_generator_equals_jax(alpha):
    sizes = [100 + 137 * i for i in range(6)]
    gen = pt_synth.ClickGenerator(sizes, 13, 256, alpha=alpha, seed=4)
    ref = jax_synth.ClickGenerator(sizes, 13, 256, alpha=alpha, seed=4)
    for a, b in zip(gen.scores + [gen.w_num], ref.scores + [ref.w_num]):
        np.testing.assert_array_equal(a, b)
    for step in (0, 7, 1_000_000):
        x, cats, labels = gen(step)
        rx, rcats, rlabels = ref.batch(step)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(labels, rlabels)
        assert labels.dtype == rlabels.dtype == np.float32
        for c, rc in zip(cats, rcats):
            assert c.dtype == rc.dtype
            np.testing.assert_array_equal(c, rc)
