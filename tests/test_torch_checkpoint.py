"""The port's checkpoints against the JAX package's `utils/checkpoint`.

The portable forms cross-load both ways, bit for bit: global weights
(``.npz`` and a directory of ``.npy`` files, memory-mapped into
`set_weights`), and stream files (container v2) with f32, int8 and fp8
payloads, whose per-array and header crcs agree between the packages. A v1
file loads with one warning and raises the legacy count; a flipped byte is a
`StreamIntegrityError`; an unknown payload dtype a ValueError. Atomic
publication and the sweep of orphaned tmp files. Resume: a small DLRM (f32
adagrad, int8 sgd) trained 2 steps, saved, trained 2 more; a fresh model
restored from the save and trained the same 2 steps ends bit-equal to the
uninterrupted one (tables, scales, optimizer state, MLPs), as the JAX
package's `tests/test_training_checkpoint.py:52` holds its Orbax resume.
"""

import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.ops import wire as jax_wire  # noqa: E402
from distributed_embeddings_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from distributed_embeddings_tpu_torch import training  # noqa: E402
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.models.dlrm import DLRM  # noqa: E402
from distributed_embeddings_tpu_torch.ops import wire  # noqa: E402
from distributed_embeddings_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

SIZES = [(96, 8), (50, 8), (1000, 16), (2000, 16)]


def _weights(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(v, w).astype(np.float32) for v, w in SIZES]


def _raw(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("npz", [True, False])
def test_global_weights_cross_load_both_ways(tmp_path, npz):
    """`save_global_weights` of either package, `load_global_weights` (the
    directory form memory-mapped) and `set_weights` of the other: every
    table bit-identical, at f32 and through an int8 layer's encode."""
    weights = _weights()
    port = DistributedEmbedding([Embedding(v, w, device="meta")
                                 for v, w in SIZES], device="cpu")
    port.set_weights(weights)
    ref = JaxDistributedEmbedding([JaxEmbedding(v, w) for v, w in SIZES])
    out = ckpt.save_global_weights(str(tmp_path / "port"),
                                   port.get_weights(), npz=npz)
    loaded = jax_ckpt.load_global_weights(out)
    got = ref.get_weights(ref.set_weights(loaded))
    for a, b in zip(weights, got):
        assert _raw(a) == _raw(b)
    out = jax_ckpt.save_global_weights(str(tmp_path / "jax"), got, npz=npz)
    loaded = ckpt.load_global_weights(out)
    if not npz:
        assert all(isinstance(a, np.memmap) for a in loaded)
        loaded = [os.path.join(out, f"table_{i}.npy")
                  for i in range(len(SIZES))]
    port.set_weights(loaded)
    for a, b in zip(weights, port.get_weights()):
        assert _raw(a) == _raw(b)
    # a quantized layer takes the same files: its encode is the JAX
    # package's, so the decoded dumps agree bit for bit
    q = DistributedEmbedding([Embedding(v, w, device="meta")
                              for v, w in SIZES], device="cpu",
                             storage_dtype="int8")
    q.set_weights(loaded)
    qref = JaxDistributedEmbedding([JaxEmbedding(v, w) for v, w in SIZES],
                                   storage_dtype="int8")
    for a, b in zip(q.get_weights(),
                    qref.get_weights(qref.set_weights(weights))):
        assert _raw(a) == _raw(b)


def _stream(dtype, seed=0):
    """A delta's (meta, arrays) with one bucket's touched rows at `dtype`
    (the JAX package's numpy encoder: fp8 as ml_dtypes' float8) and one
    dp table whole."""
    rng = np.random.RandomState(seed)
    rows = rng.randn(37, 16).astype(np.float32)
    arrays = {"tp0_keys": np.sort(rng.choice(1000, 37, replace=False))
              .astype(np.int64),
              "dp0_full": rng.randn(5, 4).astype(np.float32)}
    payload, scale = jax_wire.encode_rows_np(rows, dtype)
    arrays["tp0_rows"] = payload
    if scale is not None:
        arrays["tp0_scale"] = scale
    meta = {"version": 7, "base_version": 6, "kind": "delta",
            "published_at": 1.5, "sig": [[1000, 16]], "dtype": dtype}
    return meta, arrays, rows


@pytest.mark.parametrize("dtype", ["f32", "int8", "fp8"])
def test_row_delta_files_cross_load_both_ways(tmp_path, dtype):
    """A stream file written by either package loads, verified, in the
    other: equal crcs and header crc, the same bytes, the same decoded
    rows; the file's size is the byte model's rows plus the container."""
    meta, arrays, rows = _stream(dtype)
    port_arrays = {k: (np.ascontiguousarray(v).view(np.uint8)
                       if k == "tp0_rows" and dtype == "fp8" else v)
                   for k, v in arrays.items()}
    p_path = ckpt.save_row_delta(str(tmp_path / "port"), meta, port_arrays)
    j_path = jax_ckpt.save_row_delta(str(tmp_path / "jax"), meta, arrays)
    j_meta, j_arrays = jax_ckpt.load_row_delta(p_path)
    p_meta, p_arrays = ckpt.load_row_delta(j_path)
    assert j_meta["crc"] == p_meta["crc"]
    assert j_meta["header_crc"] == p_meta["header_crc"]
    assert ckpt.load_row_delta_meta(p_path) == j_meta
    assert jax_ckpt.load_row_delta_meta(j_path) == p_meta
    for name in arrays:
        assert _raw(j_arrays[name]) == _raw(p_arrays[name]) == _raw(
            arrays[name]), name
    scale = p_arrays.get("tp0_scale")
    decoded = wire.decode_rows_np(p_arrays["tp0_rows"], scale, dtype)
    assert _raw(decoded) == _raw(jax_wire.decode_rows_np(
        j_arrays["tp0_rows"], j_arrays.get("tp0_scale"), dtype))
    assert np.all(np.abs(decoded - rows).max(axis=-1)
                  <= wire.store_decode_bound(rows, dtype) + 1e-7)
    per_row = wire.delta_row_bytes(16, dtype)
    payload = sum(np.asarray(a).nbytes for k, a in arrays.items()
                  if k.startswith("tp0_"))
    assert payload == 37 * per_row


def test_damage_legacy_files_and_unknown_dtypes(tmp_path, monkeypatch):
    meta, arrays, _ = _stream("int8")
    path = ckpt.save_row_delta(str(tmp_path / "d"), meta, arrays)
    # one flipped payload byte: the zip's member crc or the container's
    data = bytearray(open(path, "rb").read())
    raw = arrays["tp0_rows"].tobytes()
    at = bytes(data).index(raw) + 5
    data[at] ^= 0x40
    bad = str(tmp_path / "bad.npz")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ckpt.StreamIntegrityError):
        ckpt.load_row_delta(bad)
    # damage after extraction: the container's own crc catches it
    m, a = ckpt.load_row_delta(path)
    a["tp0_rows"] = a["tp0_rows"].copy()
    a["tp0_rows"][0, 0] ^= 1
    with pytest.raises(ckpt.StreamIntegrityError, match="checksum"):
        ckpt.verify_stream_payload(m, a, "x")
    m2 = dict(m, version=8)
    with pytest.raises(ckpt.StreamIntegrityError, match="header"):
        ckpt.verify_stream_payload(m2, ckpt.load_row_delta(path)[1], "x")
    # an unsupported dtype is a configuration error, not damage
    with pytest.raises(ValueError, match="not a stream container dtype"):
        ckpt.save_row_delta(str(tmp_path / "e"), dict(meta, dtype="int4"),
                            arrays)
    odd = str(tmp_path / "odd.npz")
    np.savez(odd, __meta__=np.asarray('{"dtype": "int4"}'),
             x=np.zeros(2))
    with pytest.raises(ValueError, match="not supported") as err:
        ckpt.load_row_delta(odd)
    assert not isinstance(err.value, ckpt.StreamIntegrityError)
    # a v1 file (no checksums): one warning a process, and the count
    monkeypatch.setattr(ckpt, "_legacy_warned", False)
    monkeypatch.setattr(ckpt, "_legacy_loads", 0)
    v1 = str(tmp_path / "v1.npz")
    np.savez(v1, __meta__=np.asarray('{"version": 1, "kind": "delta"}'),
             tp0_keys=np.arange(3))
    with pytest.warns(RuntimeWarning, match="legacy"):
        meta1, _ = ckpt.load_row_delta(v1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ckpt.load_row_delta(v1)
    assert ckpt.legacy_load_count() == 2 and meta1["version"] == 1


def test_publish_atomic_and_sweep(tmp_path):
    d = tmp_path / "pub"
    d.mkdir()
    tmp = str(d / "delta_1.npz.tmp")
    open(tmp, "w").write("x")
    final = ckpt.publish_atomic(tmp, str(d / "delta_1.npz"))
    assert os.path.exists(final) and not os.path.exists(tmp)
    for name in ("a.tmp", "b.npz.tmp123", "keep.npz"):
        open(str(d / name), "w").write("x")
    removed = ckpt.sweep_orphan_tmp(str(d))
    assert sorted(os.path.basename(p) for p in removed) == [
        "a.tmp", "b.npz.tmp123"]
    assert sorted(os.listdir(str(d))) == ["delta_1.npz", "keep.npz"]
    assert ckpt.sweep_orphan_tmp(str(tmp_path / "none")) == []


# ----------------------------------------------------------------- resume
DLRM_SIZES = [40, 7, 300, 25, 1000]
DLRM_KW = dict(embedding_dim=16, bottom_mlp_dims=(32, 16),
               top_mlp_dims=(32, 1), num_numerical_features=5)


def _dlrm(seed, storage_dtype=None):
    model = DLRM(DLRM_SIZES, device="cpu", lookup_path="pallas",
                 generator=torch.Generator().manual_seed(seed), **DLRM_KW)
    if storage_dtype is not None:
        # the JAX example's way (examples/dlrm/serve.py:103-113): the
        # embedding rebuilt with its storage dtype
        from distributed_embeddings_tpu_torch.models.dlrm import (
            dlrm_initializer)
        model.embedding = DistributedEmbedding(
            [Embedding(v, 16, embeddings_initializer=dlrm_initializer(),
                       device="meta") for v in DLRM_SIZES],
            device="cpu", lookup_path="pallas", storage_dtype=storage_dtype,
            strategy="memory_balanced",
            generator=torch.Generator().manual_seed(seed))
    return model


def _batches(n, seed=14):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        cats = [torch.from_numpy(rng.randint(0, min(v, 30), size=64)
                                 .astype(np.int32)) for v in DLRM_SIZES]
        out.append((torch.from_numpy(rng.rand(64, 5).astype(np.float32)),
                    cats, torch.from_numpy(rng.randint(
                        0, 2, (64, 1)).astype(np.float32))))
    return out


def _flat(tree):
    if torch.is_tensor(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree \
        if isinstance(tree, (list, tuple)) else []
    return [t for x in items for t in _flat(x)]


@pytest.mark.parametrize("optimizer,storage", [("adagrad", None),
                                               ("sgd", "int8")])
def test_resume_is_bit_equal_to_the_uninterrupted_run(tmp_path, optimizer,
                                                      storage):
    batches = _batches(4)

    def train(model, state, step, part):
        for num, cats, labels in part:
            model, state, _ = step(model, state, num, cats, labels)
        return state

    model = _dlrm(0, storage)
    init, step = training.make_sparse_train_step(model, optimizer, lr=0.05)
    state = train(model, init(model), step, batches[:2])
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, {"params": model.state_dict(),
                                "opt_state": state}, step=2)
    with pytest.raises(FileExistsError):
        ckpt.save_checkpoint(root, {"params": model.state_dict()}, step=2)
    ckpt.save_checkpoint(str(tmp_path / "params_only"),
                         {"params": model.state_dict()}, step=2)
    state = train(model, state, step, batches[2:])

    fresh = _dlrm(1, storage)
    init2, step2 = training.make_sparse_train_step(fresh, optimizer,
                                                   lr=0.05)
    assert ckpt.latest_step(root) == 2
    assert ckpt.checkpoint_keys(root, step=2) == ["opt_state", "params"]
    assert ckpt.checkpoint_keys(str(tmp_path / "params_only"),
                                step=2) == ["params"]
    assert ckpt.checkpoint_keys(root, step=3) is None
    restored = ckpt.restore_checkpoint(
        root, {"params": fresh.state_dict(), "opt_state": init2(fresh)},
        step=2)
    state2 = train(fresh, restored["opt_state"], step2, batches[2:])
    got, want = fresh.state_dict(), model.state_dict()
    assert got.keys() == want.keys()
    if storage:
        assert any(k.startswith("embedding.tp_scale") for k in got)
        assert fresh.embedding.tp[0].dtype == torch.int8
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = _flat(state2), _flat(state)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    # the params-only save restores params into the same template keys
    only = ckpt.restore_checkpoint(str(tmp_path / "params_only"),
                                   {"params": _dlrm(2, storage)
                                    .state_dict()}, step=2)
    assert set(only) == {"params"}
