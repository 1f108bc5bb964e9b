"""Quantized row storage in the port against the JAX package's.

The row codec (`ops.wire.encode_rows` and its numpy twin) and its byte
model against the JAX package's, bit for bit: int8 rounded to nearest and
stochastically, fp8, zero rows, empty arrays. The plan's storage gate and
the float32 default. Then a layer of one sum and one mean bucket at hotness
2, `set_weights` from the same numpy weights in both packages: its payloads
and scales bit-equal, its forward (int8 and fp8, and int8 at bfloat16)
bit-equal to the JAX package's HBM-resident quantized `apply`. Three sgd and
three adagrad steps of `make_sparse_train_step` on a model whose loss is
linear in the layer's outputs (so both packages' tap gradients are the same
numbers), the weights carried across with `convert.params_from_jax`:
payloads, scales and adagrad's accumulators bit-equal after every step.
adam refuses, as in the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.ops import wire as jax_wire  # noqa: E402
from distributed_embeddings_tpu_torch import convert  # noqa: E402
from distributed_embeddings_tpu_torch import training as pt_training  # noqa: E402
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.ops import sparse_update, wire  # noqa: E402
from distributed_embeddings_tpu_torch.utils import checkpoint  # noqa: E402

QUANT = ("int8", "fp8")
# (rows, width, combiner): buckets (8, sum), (8, mean), (4, mean)
TABLES = [(40, 8, "sum"), (30, 8, "sum"), (50, 8, "mean"), (20, 4, "mean")]
HOT = 2
BATCH = 16
STEPS = 3
LR = 0.05


def _bits(x) -> np.ndarray:
    """The raw bytes of an array or tensor (fp8 and int8 alike)."""
    if torch.is_tensor(x):
        x = x.detach().contiguous()
        return x.view(torch.uint8).numpy().reshape(-1) if x.element_size() \
            == 1 else x.view(torch.int32).numpy().reshape(-1)
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint8 if x.dtype.itemsize == 1 else np.int32).reshape(-1)


def _assert_bits(got, want, what):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.array_equal(g, w), (what, int((g != w).sum()))


# ------------------------------------------------------------------ codec
def _rows(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    if x.size:
        # rows of very different magnitudes, one of them zero
        x *= rng.choice([1e-4, 1.0, 300.0], size=shape[:-1] + (1,))
        x.reshape(-1, shape[-1])[0] = 0.0
    return x


@pytest.mark.parametrize("shape", [(64, 32), (3, 5, 17), (0, 8), (1, 128)])
@pytest.mark.parametrize("dtype,sr", [("int8", False), ("int8", True),
                                      ("fp8", False)])
def test_codecs_bit_equal_to_the_jax_package(shape, dtype, sr):
    """torch and numpy codecs against the JAX package's `encode_rows` and
    `encode_rows_np`, and both decodes: bit for bit (each scale a true
    division). The write-back (``scale=writeback_scale``, ``sr=True``)
    against `encode_rows` compiled, as the JAX package's train step runs
    it (its scale a multiply by the reciprocal of the grid's amax)."""
    x = _rows(np.random.RandomState(sum(shape)), shape)
    jp, js = jax_wire.encode_rows(jnp.asarray(x), dtype, sr=sr)
    jpn, jsn = jax_wire.encode_rows_np(x, dtype, sr=sr)
    tp, ts = wire.encode_rows(torch.from_numpy(x), dtype, sr=sr)
    pn, sn = wire.encode_rows_np(x, dtype, sr=sr)
    wp, ws = jax.jit(lambda v: jax_wire.encode_rows(v, dtype, sr=True))(
        jnp.asarray(x))
    bp, bs = wire.encode_rows(
        torch.from_numpy(x), dtype, sr=True,
        scale=wire.writeback_scale(torch.from_numpy(x), dtype))
    _assert_bits(bp, wp, "write-back payload")
    _assert_bits(bs, ws, "write-back scale")
    for got, want, what in ((tp, jp, "payload"), (ts, js, "scale"),
                            (pn, jpn, "numpy payload"),
                            (sn, jsn, "numpy scale")):
        _assert_bits(got, want, what)
    assert tp.dtype == wire.payload_dtype(dtype) and ts.shape == \
        shape[:-1] + (1,)
    _assert_bits(wire.decode_rows(tp, ts, dtype),
                 jax_wire.decode_rows(jp, js, dtype), "decode")
    _assert_bits(wire.decode_rows_np(pn, sn, dtype),
                 jax_wire.decode_rows_np(jpn, jsn, dtype), "numpy decode")
    # a zero row is scale 1 and decodes to zeros
    if x.size:
        zero = x.reshape(-1, shape[-1])[0]
        assert not zero.any()
        assert ts.reshape(-1)[0] == 1.0


def test_the_keyless_draw_depends_on_position_and_bits():
    """`keyless_uniform` is the JAX package's hash: its SR decisions on a
    prefix are the whole array's, and equal inputs at other positions draw
    other numbers."""
    y = torch.full((4, 64), 0.3)
    u = wire.keyless_uniform(y)
    assert torch.equal(wire.keyless_uniform(y[:2]), u[:2])
    assert len(torch.unique(u)) > 200
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_byte_model_and_registries_equal_the_jax_package():
    assert wire.STORE_DTYPES == jax_wire.STORE_DTYPES
    assert checkpoint.STREAM_PAYLOAD_DTYPES == wire.STORE_DTYPES
    assert (wire.INT8_AMAX, wire.FP8_AMAX) == (jax_wire.INT8_AMAX,
                                               jax_wire.FP8_AMAX)
    for dtype in ("f32",) + QUANT:
        for width in (1, 8, 128):
            for fn in ("store_itemsize", "store_scale_bytes"):
                assert getattr(wire, fn)(dtype) == getattr(jax_wire, fn)(
                    dtype)
            assert wire.delta_row_bytes(width, dtype) == \
                jax_wire.delta_row_bytes(width, dtype)
            assert wire.snapshot_row_bytes(width, dtype) == \
                jax_wire.snapshot_row_bytes(width, dtype)
        x = _rows(np.random.RandomState(1), (9, 16))
        for sr in (False, True):
            np.testing.assert_array_equal(
                wire.store_decode_bound(x, dtype, sr),
                jax_wire.store_decode_bound(x, dtype, sr))
    assert wire.resolve_store_dtype(None) == "f32"
    for bad in ("int4", "bf16"):
        with pytest.raises(ValueError, match="unknown storage dtype"):
            wire.resolve_store_dtype(bad)
    assert wire.fp8_supported()


# ------------------------------------------------------------------ layer
def _pt_layer(storage_dtype=None, **kw):
    return DistributedEmbedding(
        [Embedding(r, w, combiner=c, device="meta") for r, w, c in TABLES],
        device="cpu", storage_dtype=storage_dtype, **kw)


def _jax_layer(storage_dtype=None, **kw):
    return JaxDistributedEmbedding(
        [JaxEmbedding(r, w, combiner=c) for r, w, c in TABLES],
        storage_dtype=storage_dtype, **kw)


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(r, w) * rng.choice([0.01, 1.0], size=(r, 1)))
            .astype(np.float32) for r, w, _ in TABLES]


def _cats(seed):
    rng = np.random.RandomState(seed)
    # ids repeat across the batch, so the update aggregates rows
    return [rng.randint(0, min(r, 12), size=(BATCH, HOT)).astype(np.int32)
            for r, _, _ in TABLES]


def test_plan_gate_and_the_f32_default():
    """The JAX package's plan gate (its `tests/test_store_dtype.py`
    :106-153 at world 1, without offload): every tp bucket quantizes,
    row-sliced tables stay float32, a layer without `storage_dtype` has no
    quantized bucket and no scales, an unknown dtype raises."""
    for dtype in QUANT:
        layer, ref = _pt_layer(dtype), _jax_layer(dtype)
        assert layer.quantized_buckets == ref.quantized_buckets == [0, 1, 2]
        assert [b.storage_dtype for b in layer.plan.tp_buckets] == \
            [b.storage_dtype for b in ref.plan.tp_buckets]
        assert all(t.element_size() == 1 for t in layer.tp)
        assert all(s.shape == (t.shape[0], 1)
                   for s, t in zip(layer.tp_scale, layer.tp))
        assert all(rt.storage_dtype == "f32"
                   for rt in layer.plan.row_tables)
    plain = _pt_layer()
    assert plain.quantized_buckets == _jax_layer().quantized_buckets == []
    assert not hasattr(plain, "tp_scale")
    assert all(t.dtype == torch.float32 for t in plain.tp)
    assert not any("scale" in k for k in plain.state_dict())
    with pytest.raises(ValueError, match="unknown storage dtype"):
        _pt_layer("int4")


def test_quantized_init_draws_each_table_whole_in_row_chunks():
    """`init` fills a quantized bucket in row chunks, each drawn by its
    table's initializer at the table's own shape and encoded (rounded to
    nearest): chunks of one row keep DLRM's ``1 / sqrt(rows)`` and glorot's
    ranges of the whole table; the padding rows are payload 0, scale 1."""
    from distributed_embeddings_tpu_torch.models.dlrm import dlrm_initializer
    tables = [Embedding(400, 8, combiner="sum", device="meta",
                        embeddings_initializer=dlrm_initializer()),
              Embedding(300, 8, combiner="sum", device="meta",
                        embeddings_initializer="glorot_uniform")]
    limits = [1 / np.sqrt(400), np.sqrt(6 / (300 + 8))]
    for chunk in (1, 7, 1 << 30):
        layer = DistributedEmbedding(tables, device="cpu",
                                     storage_dtype="int8")
        layer.ENCODE_CHUNK_ELEMS = chunk * 8
        layer.init(torch.Generator().manual_seed(3))
        rows = wire.decode_rows(layer.tp[0], layer.tp_scale[0], "int8")
        for t, limit in enumerate(limits):
            got = float(rows[400 * t:400 * t + tables[t].input_dim]
                        .abs().max())
            assert 0.9 * limit < got <= limit * (1 + 1e-6), (chunk, t, got)
        padding = layer.plan.tp_buckets[0].rows[0]
        assert not layer.tp[0][padding:].any()
        assert bool((layer.tp_scale[0][padding:] == 1.0).all())
        # an encode of the rows gives the payload back: rounded to nearest
        again, _ = wire.encode_rows(rows[:padding], "int8")
        assert torch.equal(again, layer.tp[0][:padding])


@pytest.mark.parametrize("dtype", QUANT)
def test_set_weights_get_weights_and_the_forward(dtype):
    """`set_weights` encodes like the JAX package's (payloads and scales
    bit-equal), `get_weights` decodes like it, and the forward is bit-equal
    to the JAX package's quantized `apply` (the explicit gather, decode,
    combine form)."""
    weights = _weights()
    layer, ref = _pt_layer(dtype), _jax_layer(dtype)
    layer.set_weights(weights)
    params = ref.set_weights(weights)
    for b in range(3):
        _assert_bits(layer.tp[b], np.asarray(params["tp"][b])[0],
                     f"payload {b}")
        _assert_bits(layer.tp_scale[b], np.asarray(params["tp_scale"][b])[0],
                     f"scale {b}")
    for got, want in zip(layer.get_weights(), ref.get_weights(params)):
        _assert_bits(got, np.asarray(want), "get_weights")
    cats = _cats(1)
    outs = layer(cats)
    want = ref.apply(params, [jnp.asarray(c) for c in cats])
    for o, w in zip(outs, want):
        assert o.dtype == torch.float32
        _assert_bits(o, np.asarray(w), "forward")


def test_forward_at_bfloat16():
    """int8 at ``compute_dtype=bfloat16``: decode first, then the cast, the
    combine in float32 rounded once, as the JAX package does."""
    weights = _weights(2)
    layer = _pt_layer("int8", compute_dtype="bfloat16")
    ref = _jax_layer("int8", compute_dtype=jnp.bfloat16)
    layer.set_weights(weights)
    params = ref.set_weights(weights)
    cats = _cats(3)
    for o, w in zip(layer(cats), ref.apply(params,
                                           [jnp.asarray(c) for c in cats])):
        assert o.dtype == torch.bfloat16
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(w, np.float32))


def test_a_quantized_bucket_without_its_scale_fails_loudly():
    layer = _pt_layer("int8")
    del layer.tp_scale
    with pytest.raises(ValueError, match="tp_scale"):
        layer(_cats(0))
    with pytest.raises(ValueError, match="tp_scale"):
        convert.params_from_jax(
            {"dp": [], "tp": [np.zeros((1,) + tuple(t.shape), np.int8)
                              for t in _pt_layer("int8").tp], "row": []},
            _pt_layer("int8"))


# ---------------------------------------------------------------- training
class _JaxLinear:
    """The JAX package's side of the training model: the loss is the sum
    of the layer's outputs times fixed coefficients, so the tap gradients
    are the coefficients themselves."""

    def __init__(self, layer, coefs):
        self.embedding, self.coefs = layer, coefs

    def loss_fn(self, params, numerical, cats, labels, taps=None,
                return_residuals=False):
        outs, res = self.embedding.apply(params["embedding"], cats,
                                         taps=taps, return_residuals=True)
        loss = sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, self.coefs))
        return (loss, res) if return_residuals else loss


class _PtLinear(torch.nn.Module):
    def __init__(self, layer, coefs):
        super().__init__()
        self.embedding = layer
        self.coefs = [torch.from_numpy(c) for c in coefs]

    def loss_fn(self, numerical, cats, labels, taps=None,
                return_residuals=False):
        out = self.embedding(list(cats), taps=taps,
                             return_residuals=return_residuals)
        outs, res = out if return_residuals else (out, None)
        loss = sum((o.float() * c).sum() for o, c in zip(outs, self.coefs))
        return (loss, res) if return_residuals else loss


def _coefs(seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randn(BATCH, w).astype(np.float32) for _, w, _ in TABLES]


def _trainers(dtype, optimizer, seed=4):
    """The JAX package's and the port's model and step from the same
    weights: (ref, params, j_state, j_step, model, p_state, p_step)."""
    coefs = _coefs()
    ref = _JaxLinear(_jax_layer(dtype), coefs)
    params = {"embedding": ref.embedding.set_weights(_weights(seed))}
    model = _PtLinear(_pt_layer(dtype), coefs)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params), model))
    j_init, j_step = jax_training.make_sparse_train_step(ref, optimizer,
                                                         lr=LR)
    p_init, p_step = pt_training.make_sparse_train_step(model, optimizer,
                                                        lr=LR)
    return ref, params, j_init(params), j_step, model, p_init(model), p_step


def _both_steps(s, params, j_state, j_step, model, p_state, p_step):
    dummy = np.zeros((BATCH, 1), np.float32)
    cats = _cats(10 + s)
    params, j_state, _ = j_step(params, j_state, jnp.asarray(dummy),
                                [jnp.asarray(c) for c in cats],
                                jnp.asarray(dummy))
    model, p_state, _ = p_step(model, p_state, torch.from_numpy(dummy),
                               [torch.from_numpy(c) for c in cats],
                               torch.from_numpy(dummy))
    return params, j_state, model, p_state


@pytest.mark.parametrize("dtype", QUANT)
def test_sgd_steps_bit_equal_to_the_jax_package(dtype):
    """Three free-running sparse sgd steps: payloads and scales bit-equal to
    the JAX package's after every step (dedup, the touched rows' decode
    fused with the rule's subtraction into one rounding as its compiled
    step rounds it, the keyless stochastically rounded re-encode)."""
    _, params, j_state, j_step, model, p_state, p_step = _trainers(dtype,
                                                                   "sgd")
    for s in range(STEPS):
        params, j_state, model, p_state = _both_steps(
            s, params, j_state, j_step, model, p_state, p_step)
        emb = params["embedding"]
        for b in range(3):
            _assert_bits(model.embedding.tp[b], np.asarray(emb["tp"][b])[0],
                         f"step {s} payload {b}")
            _assert_bits(model.embedding.tp_scale[b],
                         np.asarray(emb["tp_scale"][b])[0],
                         f"step {s} scale {b}")


# adagrad's int8 payload elements that may take the other side of their
# stochastic rounding, as a share of the elements a step touches: the JAX
# package's compiled CPU ``rsqrt`` is an estimate, an ulp off the port's
# ``1 / sqrt`` for about a third of its inputs; an ulp moves the value's bits,
# which the rounding's hash reads, so the element draws anew and its floor
# flips with probability E|u - u'| = 1/3. Such an element differs by one
# grid step (one scale), and nowhere else may any differ.
ADAGRAD_REROLLED = 0.15


@pytest.mark.parametrize("dtype", QUANT)
def test_adagrad_steps_against_the_jax_package(dtype):
    """Three sparse adagrad steps, each from the JAX step's state before
    it: accumulators bit-equal; fp8 payloads (no rounding draw) bit-equal;
    int8 payloads within one grid step, on at most `ADAGRAD_REROLLED` of
    the touched elements; scales within two ulps (the rule's rsqrt ulp can
    move a row's amax by one, and its product by the grid's reciprocal
    rounds once more)."""
    ref, params, j_state, j_step, model, p_state, p_step = _trainers(
        dtype, "adagrad")
    touched = rerolled = 0
    for s in range(STEPS):
        model.load_state_dict(convert.params_from_jax(
            jax.tree.map(np.asarray, params), model))
        for b in range(3):
            p_state["emb"]["tp"][b][0].copy_(torch.from_numpy(
                np.asarray(j_state["emb"]["tp"][b][0])[0]))
        before = [(np.asarray(p)[0], np.asarray(q)[0]) for p, q in zip(
            params["embedding"]["tp"], params["embedding"]["tp_scale"])]
        params, j_state, model, p_state = _both_steps(
            s, params, j_state, j_step, model, p_state, p_step)
        emb = params["embedding"]
        for b in range(3):
            _assert_bits(p_state["emb"]["tp"][b][0],
                         np.asarray(j_state["emb"]["tp"][b][0])[0],
                         f"step {s} accumulator {b}")
            want = np.asarray(emb["tp"][b])[0]
            want_s = np.asarray(emb["tp_scale"][b])[0]
            np.testing.assert_allclose(
                model.embedding.tp_scale[b].numpy(), want_s,
                rtol=2.0 ** -22, atol=0, err_msg=f"step {s} scale {b}")
            rows = ((want_s != before[b][1])[:, 0]
                    | (_bits(want).reshape(want.shape[0], -1)
                       != _bits(before[b][0]).reshape(want.shape[0], -1))
                    .any(axis=1))
            touched += int(rows.sum()) * want.shape[1]
            got = model.embedding.tp[b].detach()
            if dtype == "fp8":
                _assert_bits(got, want, f"step {s} payload {b}")
                continue
            diff = got.numpy().astype(np.int32) - want.astype(np.int32)
            assert np.abs(diff).max() <= 1, (s, b)
            assert not diff[~rows].any(), (s, b)
            rerolled += int((diff != 0).sum())
    assert touched > 0
    assert rerolled <= ADAGRAD_REROLLED * touched, (rerolled, touched)


def test_adam_refuses_quantized_buckets_as_the_jax_package_does():
    model = _PtLinear(_pt_layer("int8"), _coefs())
    init, step = pt_training.make_sparse_train_step(model, "adam", lr=LR)
    dummy = torch.zeros((BATCH, 1))
    with pytest.raises(NotImplementedError, match="quantized"):
        step(model, init(model), dummy,
             [torch.from_numpy(c) for c in _cats(0)], dummy)
    with pytest.raises(NotImplementedError, match="master-weight-free"):
        sparse_update.quantized_row_update(
            "adam", model.embedding.tp[0], model.embedding.tp_scale[0], (),
            sparse_update.SparseRowGrad(torch.zeros(1, dtype=torch.int32),
                                        torch.zeros(1, 8)), "int8", LR)
    # the dense step differentiates float tables only
    dense = pt_training.make_train_step(
        lambda m, *b: m.loss_fn(*b), pt_training.sgd(LR))
    with pytest.raises(ValueError, match="make_sparse_train_step"):
        dense(model, {}, dummy, [torch.from_numpy(c) for c in _cats(0)],
              dummy)


@pytest.mark.parametrize("strategy", ["sort", "pallas", "tiled", "dense"])
def test_every_strategy_takes_the_quantized_update(strategy):
    """A quantized bucket takes `quantized_row_update` whatever the
    strategy (JAX :3140-3182): every strategy gives the same bytes."""
    coefs = _coefs()
    results = []
    for strat in ("auto", strategy):
        model = _PtLinear(_pt_layer("int8"), coefs)
        model.embedding.set_weights(_weights(5))
        init, step = pt_training.make_sparse_train_step(
            model, "adagrad", lr=LR, strategy=strat)
        state = init(model)
        dummy = torch.zeros((BATCH, 1))
        model, state, _ = step(model, state, dummy,
                               [torch.from_numpy(c) for c in _cats(6)], dummy)
        results.append([t.clone() for t in model.embedding.tp]
                       + [s.clone() for s in model.embedding.tp_scale])
    for a, b in zip(*results):
        _assert_bits(a, b, strategy)


def test_engine_and_fit_serve_and_train_a_quantized_dlrm():
    """A DLRM whose embedding is rebuilt at int8 (the JAX example's way):
    `InferenceEngine` pads a 33-row request to its warmed 64 rows and gives
    the model's own logits bit for bit; `fit` at the example's schedule
    trains it, pipelined bit-equal to serial (payloads and scales), and
    `evaluate` reads its AUC."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        DLRM, dlrm_initializer, make_lr_schedule)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    sizes = [40, 7, 300, 25]

    def model():
        m = DLRM([4] * len(sizes), embedding_dim=16, bottom_mlp_dims=(8, 16),
                 top_mlp_dims=(8, 1), num_numerical_features=5,
                 device="cpu", generator=torch.Generator().manual_seed(1))
        m.embedding = DistributedEmbedding(
            [Embedding(v, 16, embeddings_initializer=dlrm_initializer(),
                       device="meta") for v in sizes], device="cpu",
            storage_dtype="int8", generator=torch.Generator().manual_seed(2))
        return m
    gen = ClickGenerator(sizes, 5, 64, seed=3)
    batches = [gen.batch(s) for s in range(3)]
    runs = []
    for pipelined in (True, False):
        m = model()
        _, _, hist = pt_training.fit(m, batches, 3, "sgd",
                                     lr=make_lr_schedule(2.0, 1, 3, 4),
                                     pipelined=pipelined, log_every=0)
        runs.append((hist["loss"], [t.clone() for t in m.embedding.tp],
                     [s.clone() for s in m.embedding.tp_scale]))
    (l1, p1, s1), (l2, p2, s2) = runs
    assert l1 == l2 and all(map(torch.equal, p1 + s1, p2 + s2))
    assert not all(map(torch.equal, p1, model().embedding.tp))
    auc = pt_training.evaluate(m, batches, steps=3)
    assert 0.0 <= auc <= 1.0
    engine = InferenceEngine(m, device="cpu")
    engine.warmup([64])
    num, cats, _ = gen.batch(9)
    got = engine.predict((num[:33], [c[:33] for c in cats]))
    # the engine's padding: zero rows past the request's 33
    num[33:] = 0.0
    for c in cats:
        c[33:] = 0
    with torch.no_grad():
        want = m(torch.from_numpy(num), [torch.from_numpy(c) for c in cats])
    assert engine.rows_padded == 31 and torch.equal(got, want[:33])
