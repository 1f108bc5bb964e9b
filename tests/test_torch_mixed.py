"""Mixed precision (``compute_dtype``) in the port against the JAX package.

The JAX package rounds to the compute dtype on two routes, and each group
of the port follows one of them:

* the kernel route (the TPU's Pallas lookup, float32, then one cast): the
  port's table-parallel groups, through `lookup_combine`'s store form. The
  JAX package takes it on a TPU; on the CPU its tests reach it with
  ``DET_LOOKUP_PATH=fused`` (the sorted Pallas lookup in interpret mode,
  float32, then the cast), so the multi-hot comparisons set that;
* the XLA route (rows cast first, then combined with float32 accumulation
  and one rounding): the dp group and the row shards, the latter through
  `lookup_combine`'s round-first form.

Tolerances: bit-equal at hotness 1; at most 1 unit in the last place of the
16-bit type at K > 1 (the K-term float32 sum runs in another order); the
tap gradients within 2 ulp (`MAX_TAP_ULP`); the models' trained parameters
(3 sgd and 3 adagrad steps of a small DLRM and of cut Tiny with
``interact_stride``) within rtol 1e-5 / atol 1e-6, the losses rtol 1e-5,
the logits rtol 1e-5 / atol 1e-5 (the float32 tests' bar: a logit that
cancels keeps the two BLAS libraries' low digits). The largest
differences measured: 6e-8 (parameters), 3e-7 (losses, relative), 1.7e-6
(logits), all far inside the JAX package's own bfloat16-against-float32
bar of 4e-2. Inputs come from numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.layers import dist_model_parallel as jax_dmp  # noqa: E402
from distributed_embeddings_tpu.layers.embedding import Embedding as JaxEmbedding  # noqa: E402
from distributed_embeddings_tpu.models import dlrm as jax_dlrm  # noqa: E402
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu.ops import pallas_lookup  # noqa: E402
from distributed_embeddings_tpu.serving.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_embeddings_tpu_torch import convert  # noqa: E402
from distributed_embeddings_tpu_torch import training as pt_training  # noqa: E402
from distributed_embeddings_tpu_torch.layers import dist_model_parallel as pt_dmp  # noqa: E402
from distributed_embeddings_tpu_torch.layers.embedding import Embedding as PtEmbedding  # noqa: E402
from distributed_embeddings_tpu_torch.models import dlrm as pt_dlrm  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402
from distributed_embeddings_tpu_torch.ops import cuda_lookup  # noqa: E402
from distributed_embeddings_tpu_torch.serving.engine import InferenceEngine  # noqa: E402
from distributed_embeddings_tpu_torch.utils.device import (  # noqa: E402
    resolve_compute_dtype)

MAX_ULP = 1
# a tap gradient is the float32 backward rounded to 16 bits, and under
# `interact_stride` rounded again after the pooling's division: the low
# bits of the two BLAS libraries' float32 sums move it by 1 ulp, 2 where
# the value sits at a power of two (an ulp of the upper binade is two of
# the lower)
MAX_TAP_ULP = 2
LOSS_TOL = dict(rtol=1e-5, atol=0)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
AUC_TOL = 1e-4
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
DLRM_SIZES = [40, 7, 300, 25, 1000]
DLRM_KW = dict(embedding_dim=16, bottom_mlp_dims=(32, 16),
               top_mlp_dims=(32, 1), num_numerical_features=5)
BATCH = 64
LR = 0.01


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(x) -> torch.Tensor:
    """A JAX (or numpy) array as a torch tensor of the same dtype."""
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance of two 16-bit float tensors in units in the last
    place."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.numel() == 0:
        return 0

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _hold(got: torch.Tensor, want, k: int):
    """The bar of the lookups: bit-equal at hotness 1, else 1 ulp."""
    want = _to_torch(want)
    assert got.dtype == want.dtype
    if k == 1:
        assert torch.equal(got, want)
    else:
        assert _ulps(got, want) <= MAX_ULP


def _case(batch, hot, vocab, width, seed=0):
    rng = np.random.RandomState(seed)
    table = rng.uniform(-1, 1, (vocab, width)).astype(np.float32)
    ids = rng.randint(-2, vocab + 2, size=(batch, hot)).astype(np.int32)
    weights = (rng.rand(batch, hot) > 0.3).astype(np.float32) * rng.rand(
        batch, hot).astype(np.float32)
    return table, ids, weights


# ---------------------------------------------------------- the resolver
@pytest.mark.parametrize("name,want", [
    (None, None), (torch.float32, None), ("float32", None),
    (np.float32, None), (jnp.float32, None),
    (torch.bfloat16, torch.bfloat16), ("bfloat16", torch.bfloat16),
    (jnp.bfloat16, torch.bfloat16), (jnp.dtype("bfloat16"), torch.bfloat16),
    (ml_dtypes.bfloat16, torch.bfloat16),
    (torch.float16, torch.float16), ("float16", torch.float16),
    (np.float16, torch.float16), (jnp.float16, torch.float16),
])
def test_resolve_compute_dtype_takes_every_name(name, want):
    assert resolve_compute_dtype(name) is want


@pytest.mark.parametrize("bad", [torch.int32, np.int8, "int64",
                                 torch.float64, "f8", object()])
def test_resolve_compute_dtype_refuses_other_dtypes(bad):
    with pytest.raises(ValueError, match="compute"):
        resolve_compute_dtype(bad)


# -------------------------------------------------- the kernel's two forms
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("vocab,width,hot", [(300, 8, 1), (300, 8, 5),
                                             (9000, 128, 1), (9000, 16, 4)])
@pytest.mark.parametrize("weighted", [False, True])
def test_store_form_matches_pallas_then_cast(dtype, vocab, width, hot,
                                             weighted):
    """The kernel route: the Pallas lookup (interpret mode), then the
    cast."""
    pt_dt, j_dt = DTYPES[dtype]
    table, ids, weights = _case(24, hot, vocab, width, seed=hot)
    w = weights if weighted else None
    want = pallas_lookup.fused_embedding_lookup(
        jnp.asarray(table), jnp.asarray(ids),
        None if w is None else jnp.asarray(w), "sum",
        interpret=True).astype(j_dt)
    got = cuda_lookup.lookup_combine(
        torch.from_numpy(table), torch.from_numpy(ids),
        None if w is None else torch.from_numpy(w), pt_dt)
    assert got.dtype == pt_dt and got.shape == (24, width)
    _hold(got, want, hot)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hot", [1, 3, 7])
def test_round_first_form_matches_xla_combine(dtype, hot):
    """The XLA route: JAX's `_combine` over the gathered rows cast to the
    compute dtype (it casts the weights to the rows' dtype)."""
    pt_dt, j_dt = DTYPES[dtype]
    table, ids, weights = _case(32, hot, 500, 16, seed=10 + hot)
    rows = jnp.take(jnp.asarray(table),
                    jnp.clip(jnp.asarray(ids), 0, 499), axis=0).astype(j_dt)
    want = jax_dmp._combine(rows, jnp.asarray(weights), "sum")
    got = cuda_lookup.lookup_combine(torch.from_numpy(table),
                                     torch.from_numpy(ids),
                                     torch.from_numpy(weights), pt_dt,
                                     round_inputs=True)
    _hold(got, want, hot)


@pytest.mark.parametrize("hot", [1, 4, 9])
def test_xla_route_accumulates_in_float32_and_rounds_once(hot):
    """The assumption the round-first form rests on: XLA's `_combine` of
    bfloat16 rows and weights is the float32 sum of the exact products,
    rounded once (numpy emulation; 1 ulp for the order of the sum), not a
    sum rounded at each add."""
    table, ids, weights = _case(64, hot, 200, 32, seed=20 + hot)
    bf = ml_dtypes.bfloat16
    rows = table[np.clip(ids, 0, 199)].astype(bf)
    w = weights.astype(bf)
    want = jax_dmp._combine(jnp.asarray(rows), jnp.asarray(weights), "sum")
    emulated = np.einsum("bk,bkw->bw", w.astype(np.float32),
                         rows.astype(np.float32)).astype(bf)
    _hold(_to_torch(emulated), want, hot)


@pytest.mark.parametrize("round_inputs", [False, True])
def test_fused_lookup_backward_matches_jax(round_inputs):
    """The dense step's lookup: a bfloat16 output's gradient reaches the
    table as float32, the transpose of the JAX route it follows (kernel
    route: the cast's transpose, then `_fused_bwd`; XLA route: the einsum
    of rounded operands)."""
    table, ids, weights = _case(16, 3, 60, 8, seed=3)
    ids = np.clip(ids, 0, 59)
    g = np.random.RandomState(4).randn(16, 8).astype(np.float32)

    def j_loss(t):
        if round_inputs:
            rows = jnp.take(t, jnp.asarray(ids), axis=0).astype(jnp.bfloat16)
            out = jax_dmp._combine(rows, jnp.asarray(weights), "sum")
        else:
            out = pallas_lookup.fused_embedding_lookup(
                t, jnp.asarray(ids), jnp.asarray(weights), "sum",
                interpret=True).astype(jnp.bfloat16)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))
    want = jax.grad(j_loss)(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = cuda_lookup.fused_embedding_lookup(
        t, torch.from_numpy(ids), torch.from_numpy(weights), "sum",
        torch.bfloat16, round_inputs)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert t.grad.dtype == torch.float32
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------- DistributedEmbedding
# (rows, width, combiner) per table, and the inputs' tables and hotness:
# one-hot sum, a weighted mean (K = 3), a passthrough (combiner None, K =
# 3), a one-hot sum, a mean of K = 3 unweighted in a bucket of its own
# (its 1/3 scale is no bfloat16 value), a multi-hot sum, shared tables
SPECS = [(50, 8, "sum"), (70, 8, "mean"), (40, 16, None), (90, 16, "sum"),
         (30, 16, "mean")]
INPUT_TABLES = [0, 1, 2, 3, 4, 0, 2, 1]
HOTNESS = [1, 3, 3, 1, 3, 2, 1, 3]
WEIGHTED = {1}


def _layer_inputs(seed=3, batch=16):
    rng = np.random.RandomState(seed)
    j_in, p_in = [], []
    for i, (t, k) in enumerate(zip(INPUT_TABLES, HOTNESS)):
        shape = (batch, k) if k > 1 or i == 5 else (batch,)
        ids = rng.randint(0, SPECS[t][0], size=shape).astype(np.int32)
        if i in WEIGHTED:
            w = ((rng.rand(*shape) > 0.3) * rng.rand(*shape)).astype(
                np.float32)
            j_in.append((jnp.asarray(ids), jnp.asarray(w)))
            p_in.append((torch.from_numpy(ids), torch.from_numpy(w)))
        else:
            j_in.append(jnp.asarray(ids))
            p_in.append(torch.from_numpy(ids))
    return j_in, p_in


def _layers(dtype, **kw):
    pt_dt, j_dt = DTYPES[dtype]
    jl = jax_dmp.DistributedEmbedding(
        [JaxEmbedding(v, w, combiner=c) for v, w, c in SPECS],
        input_table_map=INPUT_TABLES, compute_dtype=j_dt, **kw)
    params = jl.init(jax.random.PRNGKey(0))
    pl = pt_dmp.DistributedEmbedding(
        [PtEmbedding(v, w, combiner=c, device="meta") for v, w, c in SPECS],
        input_table_map=INPUT_TABLES, compute_dtype=dtype, device="cpu",
        **kw)
    pl.set_weights(jl.get_weights(params))
    return jl, params, pl


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layer_outputs_match_the_kernel_route(dtype, monkeypatch):
    monkeypatch.setenv("DET_LOOKUP_PATH", "fused")
    jl, params, pl = _layers(dtype)
    j_in, p_in = _layer_inputs()
    want = jl.apply(params, j_in)
    got = pl(p_in)
    assert len(got) == len(want) == len(INPUT_TABLES)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == DTYPES[dtype][0], i
        assert tuple(g.shape) == tuple(w.shape), i
        _hold(g, w, HOTNESS[i])


def test_layer_one_hot_outputs_match_either_route():
    """On the JAX package's default CPU route (XLA, rows cast first) the
    unweighted one-hot outputs are the same bits: one row, rounded once."""
    jl, params, pl = _layers("bfloat16")
    j_in, p_in = _layer_inputs(seed=5)
    want = jl.apply(params, j_in)
    got = pl(p_in)
    for i, (g, w) in enumerate(zip(got, want)):
        if HOTNESS[i] == 1 and i not in WEIGHTED:
            assert torch.equal(g, _to_torch(w)), i


def test_layer_scale_is_rounded_first():
    """A mean of K = 3 without weights (a group of its own): the bucket's
    sum times 1/3 rounded to bfloat16 (``out * jnp.asarray(scale,
    out.dtype)``), not times the float32 1/3."""
    _, _, pl = _layers("bfloat16")
    _, p_in = _layer_inputs(seed=7)
    got = pl(p_in)[4]
    ids = p_in[4].reshape(-1, 3).long()
    table = torch.from_numpy(np.asarray(pl.get_weights()[4]))
    total = table[ids].sum(1).to(torch.bfloat16)
    assert torch.equal(got, total * torch.tensor(1 / 3, dtype=torch.bfloat16))
    assert not torch.equal(got, (total.float() * (1 / 3)).to(torch.bfloat16))


def test_dp_group_casts_rows_then_combines():
    """The dp group (the XLA route) on rows cast first: JAX's `_combine` of
    the cast rows, bit for bit, for sum, mean and weighted mean."""
    rng = np.random.RandomState(8)
    emb = rng.uniform(-1, 1, (16, 5, 8)).astype(np.float32)
    weights = rng.rand(16, 5).astype(np.float32)
    j_rows = jnp.asarray(emb).astype(jnp.bfloat16)
    p_rows = torch.from_numpy(emb).to(torch.bfloat16)
    for combiner, w in (("sum", None), ("mean", None), ("sum", weights),
                        ("mean", weights)):
        want = jax_dmp._combine(j_rows, None if w is None else jnp.asarray(w),
                                combiner)
        got = pt_dmp._combine(p_rows, None if w is None
                              else torch.from_numpy(w), combiner)
        assert torch.equal(got, _to_torch(want)), combiner


# --------------------------------------------------------------- models
def _dlrm(dtype="bfloat16", seed=5):
    pt_dt, j_dt = DTYPES[dtype]
    jm = jax_dlrm.DLRM(DLRM_SIZES, compute_dtype=j_dt, **DLRM_KW)
    params = jm.init(jax.random.PRNGKey(seed))
    pm = pt_dlrm.DLRM(DLRM_SIZES, device="cpu", compute_dtype=pt_dt,
                      **DLRM_KW)
    pm.load_state_dict(convert.params_from_jax(_np(params), pm))
    rng = np.random.RandomState(14)
    batches = []
    for _ in range(3):
        num = rng.rand(BATCH, 5).astype(np.float32)
        cats = [rng.randint(0, min(v, 30), size=BATCH).astype(np.int32)
                for v in DLRM_SIZES]
        labels = rng.randint(0, 2, size=(BATCH, 1)).astype(np.float32)
        batches.append((num, cats, labels))
    return jm, params, pm, batches


def _cut_tiny(cfg):
    return cfg._replace(embedding_configs=[
        e._replace(num_rows=min(e.num_rows, 200))
        for e in cfg.embedding_configs], interact_stride=3)


def _tiny(dtype="bfloat16"):
    pt_dt, j_dt = DTYPES[dtype]
    jm = jax_synth.SyntheticModel(
        _cut_tiny(jax_synth.SYNTHETIC_MODELS["tiny"]), compute_dtype=j_dt)
    params = jm.init(jax.random.PRNGKey(0))
    pm = pt_synth.SyntheticModel(
        _cut_tiny(pt_synth.SYNTHETIC_MODELS["tiny"]), device="cpu",
        compute_dtype=pt_dt)
    pm.load_state_dict(convert.params_from_jax(_np(params), pm))
    gen = pt_synth.InputGenerator(_cut_tiny(pt_synth.SYNTHETIC_MODELS["tiny"]),
                                  32, alpha=1.05, num_batches=3, seed=0)
    batches = [(n.numpy(), [c.numpy() for c in cs], lab.numpy())
               for n, cs, lab in gen]
    return jm, params, pm, batches


MODELS = {"dlrm": _dlrm, "tiny_stride": _tiny}


def _j(batch):
    num, cats, labels = batch
    return (jnp.asarray(num), [jnp.asarray(c) for c in cats],
            jnp.asarray(labels))


def _p(batch):
    num, cats, labels = batch
    return (torch.from_numpy(num), [torch.from_numpy(c) for c in cats],
            torch.from_numpy(labels))


def _assert_params_close(pm, jax_params):
    want = convert.params_from_jax(_np(jax_params), pm)
    got = pm.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == torch.float32, name
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **STATE_TOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_logits_and_loss_match(model, monkeypatch):
    monkeypatch.setenv("DET_LOOKUP_PATH", "fused")
    jm, params, pm, batches = MODELS[model]()
    num, cats, labels = _j(batches[0])
    want = jm.apply(params, num, cats)
    want_loss = jm.loss_fn(params, num, cats, labels)
    with torch.no_grad():
        got = pm(*_p(batches[0])[:2])
        got_loss = pm.loss_fn(*_p(batches[0]))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **LOSS_TOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_tap_gradients_are_the_compute_dtype(model, monkeypatch):
    """Each tap's ``.grad`` is bfloat16 and within `MAX_TAP_ULP` of the
    JAX package's tap gradient; the sparse update's contributions are
    upcast to float32."""
    monkeypatch.setenv("DET_LOOKUP_PATH", "fused")
    jm, params, pm, batches = MODELS[model]()
    num, cats, labels = _j(batches[0])
    j_taps = jm.embedding.make_taps(cats)
    assert all(t.dtype == jnp.bfloat16 for t in j_taps["tp"])
    want = jax.grad(lambda taps: jm.loss_fn(params, num, cats, labels,
                                            taps=taps))(j_taps)
    pnum, pcats, plabels = _p(batches[0])
    taps = pm.embedding.make_taps(pcats)
    loss, res = pm.loss_fn(pnum, pcats, plabels, taps=taps,
                           return_residuals=True)
    loss.backward()
    assert len(taps["tp"]) == len(want["tp"])
    for leaf, w in zip(taps["tp"], want["tp"]):
        assert leaf.dtype == leaf.grad.dtype == torch.bfloat16
        assert _ulps(leaf.grad, _to_torch(w)) <= MAX_TAP_ULP
    groups, _ = pm.embedding._exchange_groups_for_key(res.key)
    for g, grp in enumerate(groups):
        contrib = pm.embedding._group_contrib(
            g, grp, res.tp_ids, res.tp_w, [t.grad for t in taps["tp"]])
        assert contrib.contribs.dtype == torch.float32


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_sparse_steps_match_jax(model, optimizer, monkeypatch):
    monkeypatch.setenv("DET_LOOKUP_PATH", "fused")
    jm, params, pm, batches = MODELS[model]()
    j_init, j_step = jax_training.make_sparse_train_step(
        jm, optimizer, lr=LR, strategy="sort")
    p_init, p_step = pt_training.make_sparse_train_step(
        pm, optimizer, lr=LR, strategy="sort")
    j_state, p_state = j_init(params), p_init(pm)
    for batch in batches:
        params, j_state, j_loss = j_step(params, j_state, *_j(batch))
        pm, p_state, p_loss = p_step(pm, p_state, *_p(batch))
        np.testing.assert_allclose(float(p_loss), float(j_loss), **LOSS_TOL)
    _assert_params_close(pm, params)


def test_float16_sparse_step_matches_jax():
    jm, params, pm, batches = _dlrm("float16")
    j_init, j_step = jax_training.make_sparse_train_step(
        jm, "adagrad", lr=LR, strategy="sort")
    p_init, p_step = pt_training.make_sparse_train_step(
        pm, "adagrad", lr=LR, strategy="sort")
    params, _, j_loss = j_step(params, j_init(params), *_j(batches[0]))
    pm, _, p_loss = p_step(pm, p_init(pm), *_p(batches[0]))
    np.testing.assert_allclose(float(p_loss), float(j_loss), **LOSS_TOL)
    _assert_params_close(pm, params)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_step_matches_jax(dtype):
    """fit(sparse=False): the tables' gradients through the kernel's
    backward, upcast from the compute dtype."""
    jm, params, pm, batches = _dlrm(dtype)
    kw = dict(optimizer="adagrad", lr=LR, sparse=False, log_every=0,
              log_fn=lambda *_: None)
    jparams, _, jhist = jax_training.fit(jm, params, batches[:1], 1, **kw)
    _, _, phist = pt_training.fit(pm, batches[:1], 1, **kw)
    np.testing.assert_allclose(phist["loss"], jhist["loss"], **LOSS_TOL)
    _assert_params_close(pm, jparams)


def test_evaluate_matches_jax():
    jm, params, pm, _ = _dlrm()
    gen = pt_synth.ClickGenerator(DLRM_SIZES, 5, BATCH, seed=3)
    data = lambda j: gen.batch(500 + j)  # noqa: E731
    want = jax_training.evaluate(jm, params, data, steps=3)
    got = pt_training.evaluate(pm, data, steps=3)
    assert abs(got - want) <= AUC_TOL


@pytest.mark.parametrize("rows", [1, 17, 32])
def test_engine_predict_matches_jax(rows, monkeypatch):
    """`InferenceEngine.predict` on a bfloat16 model: float32 logits."""
    monkeypatch.setenv("DET_LOOKUP_PATH", "fused")
    jm, params, pm, batches = _tiny()
    num, cats, _ = batches[0]
    request = (num[:rows], [c[:rows] for c in cats])
    je = JaxEngine(jm, params)
    pe = InferenceEngine(pm, device="cpu")
    pe.warmup([32])
    want = je.predict(request)
    got = pe.predict(request)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_per_table_model_casts_its_embeddings():
    """`SyntheticModel(distributed=False)` at bfloat16 against the JAX
    per-table model."""
    cfg = _cut_tiny(jax_synth.SYNTHETIC_MODELS["tiny"])
    jm = jax_synth.SyntheticModel(cfg, distributed=False,
                                  compute_dtype=jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(2))
    pm = pt_synth.SyntheticModel(_cut_tiny(pt_synth.SYNTHETIC_MODELS["tiny"]),
                                 distributed=False, device="cpu",
                                 compute_dtype="bfloat16")
    pm.load_state_dict(convert.params_from_jax(_np(params), pm))
    _, _, _, batches = _tiny()
    num, cats, _ = batches[0]
    want = jm.apply(params, jnp.asarray(num), [jnp.asarray(c) for c in cats])
    with torch.no_grad():
        got = pm(torch.from_numpy(num), [torch.from_numpy(c) for c in cats])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_converted_weights_serve_either_dtype():
    """`convert.params_from_jax` carries float32 parameters: a model built
    with a compute dtype takes the same state dict as the float32 one, and
    its parameters stay float32."""
    jm, params, pm, _ = _dlrm()
    f32 = pt_dlrm.DLRM(DLRM_SIZES, device="cpu", **DLRM_KW)
    state = convert.params_from_jax(_np(params), f32)
    assert set(state) == set(pm.state_dict())
    f32.load_state_dict(state)
    for (name, a), b in zip(pm.state_dict().items(),
                            f32.state_dict().values()):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b), \
            name
