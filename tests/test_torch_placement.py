"""The placement groups of the port on one rank, against the JAX package.

At world size 1 both packages ignore ``row_slice_threshold`` and
``data_parallel_threshold`` (every table table-parallel, the JAX package's
`DistributedEmbedding.__init__`), so a layer built with them plans and
computes what the JAX layer does: the same groups and buckets, the same
outputs (rtol 1e-5 / atol 1e-6). Model-parallel input (``dp_input=False``)
at world 1 takes the flat list of features (the JAX package's
`test_mp_input_single_device_flat`) or the nested per-rank form, and its
outputs are `apply_mp`'s. A layer class with its own forward may not sit
in a fused group, in either package. The JAX params and optimizer states
go into the port and come back out equal. The world-size > 1 cases of the
same slice are in `test_torch_multigpu.py`.
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
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu_torch import convert  # noqa: E402
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402

BATCH = 16
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
ONE_HOT_8 = [(96, 8), (50, 8), (100, 16), (120, 8), (40, 16), (70, 8),
             (60, 8), (81, 8)]
# name -> (tables (rows, width, combiner), input table map, arguments)
CONFIGS = {
    "shared_all_modes": ([(10, 4, None), (1000, 8, None), (4000, 16, None)],
                         [0, 1, 2, 1, 0],
                         dict(strategy="memory_balanced",
                              data_parallel_threshold=100,
                              row_slice_threshold=60000,
                              column_slice_threshold=1000)),
    "multihot_row_slice": ([(2000, 8, "sum"), (96, 8, "sum"), (50, 8, "sum"),
                            (80, 8, "sum")], None,
                           dict(strategy="memory_balanced",
                                row_slice_threshold=8000)),
}


def _inputs(rng, tables, table_map):
    out = []
    for i, t in enumerate(table_map):
        rows, _, combiner = tables[t]
        shape = (BATCH,) if combiner is None else (BATCH, 2 + i % 3)
        out.append(rng.randint(0, rows, size=shape).astype(np.int32))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_thresholds_at_world1_match_jax(name):
    """The repair: `row_slice_threshold` (and `data_parallel_threshold`)
    at world 1 build, plan the JAX layer's groups (every table
    table-parallel) and buckets, and give its outputs."""
    tables, table_map, kw = CONFIGS[name]
    table_map = table_map or list(range(len(tables)))
    rng = np.random.RandomState(3)
    weights = [rng.randn(r, w).astype(np.float32) * 0.1
               for r, w, _ in tables]
    inputs = _inputs(rng, tables, table_map)
    jl = JaxDistributedEmbedding(
        [JaxEmbedding(r, w, combiner=c) for r, w, c in tables],
        input_table_map=table_map, **kw)
    want = jl.apply(jl.set_weights(weights),
                    [jnp.asarray(x) for x in inputs])
    pl = DistributedEmbedding(
        [Embedding(r, w, combiner=c, device="meta") for r, w, c in tables],
        input_table_map=table_map, device="cpu", **kw)
    assert pl.strategy.table_groups == jl.strategy.table_groups == [
        [], list(range(len(tables))), []]
    assert [(b.width, b.combiner, b.rows) for b in pl.plan.tp_buckets] == [
        (b.width, b.combiner, b.rows) for b in jl.plan.tp_buckets]
    pl.set_weights(weights)
    with torch.no_grad():
        got = pl(inputs)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"output {i}", **FWD_TOL)


def _mp_pair():
    rng = np.random.RandomState(5)
    specs = ONE_HOT_8[:4]
    weights = [rng.randn(r, w).astype(np.float32) * 0.1 for r, w in specs]
    inputs = [rng.randint(0, r, size=(BATCH,)).astype(np.int32)
              for r, _ in specs]
    jl = JaxDistributedEmbedding([JaxEmbedding(r, w) for r, w in specs],
                                 dp_input=False)
    pl = DistributedEmbedding([Embedding(r, w, device="meta")
                               for r, w in specs], dp_input=False,
                              device="cpu")
    pl.set_weights(weights)
    return jl, jl.set_weights(weights), pl, inputs


def test_mp_input_single_device_flat_matches_jax():
    """``dp_input=False`` at world 1: the features in
    ``input_ids_list[0]`` order, as a flat list or the nested per-rank
    form, give the JAX package's `apply_mp` outputs."""
    jl, params, pl, inputs = _mp_pair()
    ids = pl.strategy.input_ids_list[0]
    assert ids == jl.strategy.input_ids_list[0]
    flat = [inputs[pl.strategy.input_groups[1][pos]] for pos in ids]
    want = jl.apply_mp(params, [jnp.asarray(x) for x in flat])
    with torch.no_grad():
        for got in (pl(flat), pl([flat]), pl.forward_mp(flat)):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **FWD_TOL)


def test_mp_call_dispatch():
    """As in the JAX package (`test_mp_call_dispatch`): the layer's call
    takes the input form it was built for; the other entry point raises
    ValueError naming ``dp_input``."""
    jl, params, pl, inputs = _mp_pair()
    with pytest.raises(ValueError, match="dp_input=False"):
        jl.apply(params, [jnp.asarray(x) for x in inputs])
    dp = DistributedEmbedding([Embedding(r, w, device="meta")
                               for r, w in ONE_HOT_8[:4]], device="cpu")
    with pytest.raises(ValueError, match="dp_input=True"):
        dp.forward_mp(inputs)
    outs = pl([np.zeros((BATCH,), np.int32)] * 4)
    assert len(outs) == 4 and tuple(outs[0].shape) == (BATCH, 8)


class _JaxScaled(JaxEmbedding):
    def __call__(self, params, inputs):
        return 2.0 * jnp.take(params["embeddings"], jnp.asarray(inputs),
                              axis=0)


class _Scaled(Embedding):
    def forward(self, inputs):
        return 2.0 * self.embeddings[torch.as_tensor(inputs).long()]


def test_custom_layer_in_a_fused_group_raises_like_jax():
    """At world 1 the dp threshold is ignored, so a layer class with its
    own forward lands in a fused table-parallel bucket: both packages
    refuse it at build time, naming the class."""
    specs = [(40, 8), (3000, 8)]
    with pytest.raises(ValueError, match="custom embedding layer class"):
        JaxDistributedEmbedding([_JaxScaled(*specs[0]),
                                 JaxEmbedding(*specs[1])],
                                data_parallel_threshold=600)
    with pytest.raises(ValueError, match="custom embedding layer class "
                                         "_Scaled"):
        DistributedEmbedding([_Scaled(*specs[0], device="meta"),
                              Embedding(*specs[1], device="meta")],
                             data_parallel_threshold=600, device="cpu")


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_convert_round_trip_world1(optimizer):
    """The JAX package's params and sparse optimizer state (after one
    step) go into the port and come back out equal at world 1, where the
    dp and row groups are empty."""
    cfg = jax_synth.ModelConfig(
        "placement", [jax_synth.EmbeddingConfig(1, [1, 3], 200, 8, True),
                      jax_synth.EmbeddingConfig(2, [1], 100, 16, False)],
        [16], 5, None)
    jm = jax_synth.SyntheticModel(cfg, data_parallel_threshold=400,
                                  row_slice_threshold=1600)
    params = jm.init(jax.random.PRNGKey(1))
    pm = pt_synth.SyntheticModel(pt_synth.ModelConfig(
        "placement", [pt_synth.EmbeddingConfig(1, [1, 3], 200, 8, True),
                      pt_synth.EmbeddingConfig(2, [1], 100, 16, False)],
        [16], 5, None), device="cpu", data_parallel_threshold=400,
        row_slice_threshold=1600)
    rng = np.random.RandomState(2)
    num = rng.rand(BATCH, 5).astype(np.float32)
    cats = [rng.randint(0, 200, size=(BATCH, 1)).astype(np.int32),
            rng.randint(0, 200, size=(BATCH, 3)).astype(np.int32),
            rng.randint(0, 100, size=(BATCH, 1)).astype(np.int32),
            rng.randint(0, 100, size=(BATCH, 1)).astype(np.int32)]
    labels = rng.randint(0, 2, size=(BATCH, 1)).astype(np.float32)
    init, step = jax_training.make_sparse_train_step(jm, optimizer, lr=0.01,
                                                     strategy="sort")
    params, state, _ = step(params, init(params), jnp.asarray(num),
                            [jnp.asarray(c) for c in cats],
                            jnp.asarray(labels))
    tree = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    assert tree["embedding"]["dp"] == [] and tree["embedding"]["row"] == []
    pm.load_state_dict(convert.params_from_jax(tree, pm))
    back = convert.params_to_numpy(pm)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    port_state = convert.opt_state_from_jax(state, pm)
    out = convert.opt_state_to_numpy(port_state, pm)
    np.testing.assert_equal(out["emb"], state["emb"])


SMALL = [(1, [1, 3], 200, 8, True), (2, [1], 100, 16, False),
         (1, [2], 50, 4, False)]


def _small_models(distributed):
    jcfg = jax_synth.ModelConfig(
        "small", [jax_synth.EmbeddingConfig(*e) for e in SMALL], [16], 5,
        None)
    pcfg = pt_synth.ModelConfig(
        "small", [pt_synth.EmbeddingConfig(*e) for e in SMALL], [16], 5,
        None)
    jm = jax_synth.SyntheticModel(jcfg, distributed=distributed)
    pm = pt_synth.SyntheticModel(pcfg, distributed=distributed, device="cpu")
    batch = pt_synth.InputGenerator(pcfg, BATCH, alpha=1.05, num_batches=1,
                                    seed=4)[0]
    num, cats, labels = (batch[0].numpy(), [c.numpy() for c in batch[1]],
                         batch[2].numpy())
    return jm, pm, (num, cats, labels)


def test_per_table_model_matches_jax():
    """`SyntheticModel(distributed=False)`, the JAX package's per-table
    comparison model: one table a layer, loaded from the JAX tree: its
    logits are the JAX model's and the distributed model's on the same
    weights (rtol 1e-5 / atol 1e-6); one dense adagrad step
    (`make_train_step`) gives the JAX step's loss and parameters (rtol
    1e-4 / atol 1e-6); the tree comes back out equal."""
    import optax
    from distributed_embeddings_tpu_torch import training as pt_training
    jm, pm, (num, cats, labels) = _small_models(False)
    params = jm.init(jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, params)
    pm.load_state_dict(convert.params_from_jax(tree, pm))
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(pm)),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    jcats = [jnp.asarray(c) for c in cats]
    want = np.asarray(jm.apply(params, jnp.asarray(num), jcats))
    with torch.no_grad():
        got = pm(num, cats).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    # the distributed model on the same tables
    jd, pd, _ = _small_models(True)
    dparams = jd.init(jax.random.PRNGKey(7))
    dparams["mlp"] = params["mlp"]
    dparams["embedding"] = jd.embedding.set_weights(
        [np.asarray(p["embeddings"]) for p in params["embedding"]])
    pd.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, dparams), pd))
    with torch.no_grad():
        np.testing.assert_allclose(pd(num, cats).numpy(), got, **FWD_TOL)
    opt = optax.adagrad(0.01)
    jstep = jax_training.make_train_step(jm.loss_fn, opt)
    new, _, jloss = jstep(params, opt.init(params), jnp.asarray(num), jcats,
                          jnp.asarray(labels))
    popt = pt_training.adagrad(0.01)
    pstep = pt_training.make_train_step(lambda m, *b: m.loss_fn(*b), popt)
    _, _, ploss = pstep(pm, popt.init(dict(pm.named_parameters())), num,
                        cats, labels)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(pm)),
                    jax.tree.leaves(jax.tree.map(np.asarray, new))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="dense step"):
        pm.loss_fn(num, cats, labels, taps={"tp": [], "row": []},
                   return_residuals=True)


KERAS_INITIALIZERS = [
    ({"class_name": "RandomUniform", "config": {"minval": -0.5,
                                                 "maxval": 0.25}},
     "uniform", (-0.5, 0.25)),
    ({"class_name": "RandomNormal", "config": {"mean": 1.0, "stddev": 0.1}},
     "normal", (1.0, 0.1)),
    ({"class_name": "TruncatedNormal", "config": {"mean": -1.0,
                                                   "stddev": 0.2}},
     "truncated", (-1.0, 0.2)),
    ({"class_name": "Constant", "config": {"value": 0.75}}, "constant",
     0.75),
    ({"class_name": "Zeros", "config": {}}, "constant", 0.0),
    ({"class_name": "Ones"}, "constant", 1.0),
    ({"class_name": "GlorotUniform", "config": {}}, "uniform", None),
]


@pytest.mark.parametrize("spec,kind,param", KERAS_INITIALIZERS)
def test_keras_initializer_dicts(spec, kind, param):
    """Keras-serialized initializer dicts, as the JAX package resolves
    them (`utils.initializers._from_keras_config`): the same class names
    and defaults. The draws differ (two generators), so each is held to
    its law on a 512 x 64 table, beside the JAX package's draw of the same
    dict: the same support and moments. A table of a layer built with one
    is initialized by it."""
    from distributed_embeddings_tpu.utils import initializers as jax_init
    from distributed_embeddings_tpu_torch.utils.initializers import (
        get_initializer)
    shape = (512, 64)
    got = get_initializer(spec)(torch.empty(shape),
                                torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(jax_init.get_initializer(spec)(
        jax.random.PRNGKey(0), shape))
    if kind == "constant":
        np.testing.assert_array_equal(got, np.full(shape, param, np.float32))
        np.testing.assert_array_equal(want, got)
        return
    for x in (got, want):
        if kind == "uniform":
            limit = np.sqrt(6 / sum(shape))        # glorot's
            lo, hi = param or (-limit, limit)
            assert lo <= x.min() and x.max() <= hi
            assert abs(x.mean() - (lo + hi) / 2) < 0.02 * (hi - lo)
        else:
            mean, std = param
            np.testing.assert_allclose(x.mean(), mean,
                                       atol=0.01 * (std + abs(mean)))
            if kind == "truncated":
                assert mean - 2 * std <= x.min() and x.max() <= mean + 2 * std
                # a normal truncated at 2 sigma: std 0.88 sigma
                np.testing.assert_allclose(x.std(), 0.8796 * std, rtol=0.02)
            else:
                np.testing.assert_allclose(x.std(), std, rtol=0.02)
    layer = DistributedEmbedding(
        [Embedding(64, 8, embeddings_initializer=spec, device="meta")],
        device="cpu")
    table = layer.tp[0].detach().numpy()
    assert table.shape == (64, 8) and np.isfinite(table).all()
    with pytest.raises(ValueError, match="Unknown keras initializer"):
        get_initializer({"class_name": "Orthogonal"})
