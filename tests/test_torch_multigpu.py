"""World size > 1: the port's ranks against the JAX package on a mesh.

Each world (2 and 4) is one spawn of gloo ranks on the CPU, in processes
that import no jax (`tests/torch_multigpu_worker.py`; each rank checks).
The JAX package runs in this process on ``create_mesh(jax.devices()[:W])``
and hands the ranks the same weights and global batches as numpy arrays;
each rank runs its slice through the port and reports, and each test below
compares one case:

* the forward outputs of sum, mean, weighted and combiner-None tables at
  hotness 1 and 3 (one shared table), the layer loaded from the JAX
  package's world-W tree with `convert.params_from_jax`: rtol 1e-5 /
  atol 1e-6;
* three sparse train steps of a small synthetic model (7 tables, widths
  4 to 16, batch 32): at W = 2 the ``sort`` strategy with sgd, adagrad and
  adam and the ``tiled`` strategy with adagrad, at W = 4 ``sort`` with
  adagrad, and at W = 2 one ``sort`` adagrad step of a small DLRM (its
  logits before it at rtol 1e-5 / atol 1e-6). Losses at rtol 1e-5; tables, optimizer state and MLPs at rtol
  1e-4 / atol 1e-6; adam step by step from the JAX step's state, with
  `test_torch_training`'s rule for elements whose gradient is a sum that
  cancels (its `gradient_scale` taken on a world-1 model of the same
  weights: the global batch's gradient is the same function);
* `set_weights` / `get_weights` across ranks, `params_from_jax`,
  `broadcast_variables`, the training shims (`DistributedGradientTape`
  against the JAX package's, then a `DistributedOptimizer` sgd update),
  an indivisible batch, and what stays unported at W > 1 (column slicing,
  the dp group: ROADMAP Queue A4);
* at W = 2, a small DLRM's `evaluate` and three dense adagrad steps
  (``fit(sparse=False)``) over global click-stream batches.
"""

import os
import pickle
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as torch_mp  # noqa: E402

from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.models import dlrm as jax_dlrm  # noqa: E402
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu_torch import training as pt_training  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402

import torch_multigpu_worker as worker  # noqa: E402
from test_torch_training import (STATE_TOL,  # noqa: E402
                                 _assert_adam_step_close,
                                 _assert_tree_close, _jax_dense_state,
                                 _leaf, _np)

WORLDS = (2, 4)
BATCH = 32
STEPS = 3
LR = 0.01
LOSS_TOL = dict(rtol=1e-5, atol=0)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
JOIN_TIMEOUT_S = 240

# (rows, width, combiner)
FWD_TABLES = [(40, 8, "sum"), (30, 4, "mean"), (50, 16, "sum"),
              (20, 8, None), (60, 4, "mean"), (25, 16, "sum"), (35, 8, None)]
# input name -> (table, hotness, weighted)
FWD_INPUTS = {
    "sum-h1": (0, 1, False), "sum-h3": (2, 3, False),
    "mean-h3": (1, 3, False), "weighted-sum-h3": (5, 3, True),
    "weighted-mean-h3": (4, 3, True), "none-h1": (3, 1, False),
    "none-h3": (6, 3, False), "shared-sum-h3": (0, 3, False),
}
# (num_tables, nnz, rows, width, shared): 7 tables, 8 inputs
TRAIN_EMBEDDINGS = [(1, [1, 3], 200, 8, True), (2, [1], 100, 16, False),
                    (3, [1], 50, 8, False), (1, [1], 300, 4, False)]
TRAIN_CONFIG = ("multigpu", TRAIN_EMBEDDINGS, [16], 5, None)
# case -> (world, strategy, optimizer)
TRAIN_CASES = {
    "w2-sort-sgd": (2, "sort", "sgd"),
    "w2-sort-adagrad": (2, "sort", "adagrad"),
    "w2-sort-adam": (2, "sort", "adam"),
    "w2-tiled-adagrad": (2, "tiled", "adagrad"),
    "w4-sort-adagrad": (4, "sort", "adagrad"),
}

# the small DLRM of `test_torch_training`, built at W = 2
DLRM_SIZES = [40, 7, 300, 25, 1000]
DLRM_KW = dict(embedding_dim=16, bottom_mlp_dims=(32, 16),
               top_mlp_dims=(32, 1), num_numerical_features=5)


def _jax_config():
    name, embs, mlp, numerical, stride = TRAIN_CONFIG
    return jax_synth.ModelConfig(
        name, [jax_synth.EmbeddingConfig(*e) for e in embs], mlp, numerical,
        stride)


def _pt_config():
    name, embs, mlp, numerical, stride = TRAIN_CONFIG
    return pt_synth.ModelConfig(
        name, [pt_synth.EmbeddingConfig(*e) for e in embs], mlp, numerical,
        stride)


def _jax_inputs(inputs):
    return [(jnp.asarray(x[0]), jnp.asarray(x[1])) if isinstance(x, tuple)
            else jnp.asarray(x) for x in inputs]


def _layer_spec():
    return {"tables": FWD_TABLES,
            "table_map": [t for t, _, _ in FWD_INPUTS.values()],
            "hotness": [k for _, k, _ in FWD_INPUTS.values()],
            "strategy": "auto"}


def _forward_cases(world, mesh):
    rng = np.random.RandomState(world)
    spec = _layer_spec()
    inputs = []
    for t, k, weighted in FWD_INPUTS.values():
        shape = (BATCH,) if k == 1 else (BATCH, k)
        ids = rng.randint(0, FWD_TABLES[t][0], size=shape).astype(np.int32)
        if weighted:
            w = rng.rand(BATCH, k).astype(np.float32)
            w[:, -1] *= rng.rand(BATCH) > 0.3      # some padded slots
            inputs.append((ids, w))
        else:
            inputs.append(ids)
    weights = [rng.randn(r, w).astype(np.float32) for r, w, _ in FWD_TABLES]
    jl = JaxDistributedEmbedding(
        [JaxEmbedding(r, w, combiner=c) for r, w, c in FWD_TABLES],
        mesh=mesh, input_table_map=spec["table_map"],
        input_max_hotness=spec["hotness"])
    params = jl.set_weights(weights)
    outs = [np.asarray(o) for o in jl.apply(params, _jax_inputs(inputs))]
    tree = _np(params)
    cases = {"forward": ("forward", {**spec, "tree": tree,
                                     "inputs": inputs}),
             "weights": ("weights", {**spec, "weights": weights}),
             "broadcast": ("broadcast", {"config": TRAIN_CONFIG}),
             "raises": ("raises", {**spec, "column": 100,
                                   "indivisible": [np.zeros(BATCH + 1)]})}
    return cases, {"outputs": outs, "tree": tree, "weights": weights}


def _torch_batch(batch):
    num, cats, labels = batch
    return (torch.from_numpy(num), [torch.from_numpy(c) for c in cats],
            torch.from_numpy(labels))


def _shims_case(world, mesh):
    """The JAX package's `DistributedGradientTape` on the train model's
    initial weights and one global batch."""
    jm = jax_synth.SyntheticModel(_jax_config(), mesh=mesh)
    params = jm.init(jax.random.PRNGKey(10 + world))
    num, cats, labels = pt_synth.InputGenerator(
        _pt_config(), BATCH, alpha=1.05, num_batches=1, seed=10 + world)[0]
    batch = (num.numpy(), [c.numpy() for c in cats], labels.numpy())
    loss, grads = jax_training.DistributedGradientTape().gradient(
        jm.loss_fn, params, jnp.asarray(batch[0]),
        [jnp.asarray(c) for c in batch[1]], jnp.asarray(batch[2]))
    spec = {"config": TRAIN_CONFIG, "params": _np(params), "batch": batch,
            "lr": LR}
    return spec, {"loss": float(loss), "params": _np(params),
                  "grads": _np(grads)}


def _dlrm_case(world, mesh):
    """The JAX package's DLRM on the mesh: its logits on a global batch,
    then one ``sort`` adagrad step from its initial weights."""
    jm = jax_dlrm.DLRM(DLRM_SIZES, mesh=mesh, **DLRM_KW)
    params = jm.init(jax.random.PRNGKey(20 + world))
    rng = np.random.RandomState(20 + world)
    num = rng.rand(BATCH, DLRM_KW["num_numerical_features"]).astype(
        np.float32)
    # some ids repeat across the batch, so rows aggregate
    cats = [rng.randint(0, min(v, 30), size=BATCH).astype(np.int32)
            for v in DLRM_SIZES]
    labels = rng.randint(0, 2, size=(BATCH, 1)).astype(np.float32)
    jax_cats = [jnp.asarray(c) for c in cats]
    logits = np.asarray(jm.apply(params, jnp.asarray(num), jax_cats))
    init, step = jax_training.make_sparse_train_step(jm, "adagrad", lr=LR,
                                                     strategy="sort")
    new, state, loss = step(params, init(params), jnp.asarray(num),
                            jax_cats, jnp.asarray(labels))
    spec = {"sizes": DLRM_SIZES, "kw": DLRM_KW, "params": _np(params),
            "batch": (num, cats, labels), "lr": LR}
    return spec, {"logits": logits, "loss": float(loss),
                  "params": _np(new), "state": _np(state)}


def _dlrm_fit_case(world, mesh):
    """The JAX package's `evaluate` of the DLRM on the mesh, then three
    dense adagrad steps (``fit(sparse=False)``) over global click-stream
    batches, then `evaluate` again."""
    jm = jax_dlrm.DLRM(DLRM_SIZES, mesh=mesh, **DLRM_KW)
    params = jm.init(jax.random.PRNGKey(30 + world))
    gen = pt_synth.ClickGenerator(DLRM_SIZES, 5, BATCH, seed=30 + world)
    batches = [gen.batch(s) for s in range(STEPS)]
    evals = [gen.batch(1000 + s) for s in range(4)]
    auc0 = jax_training.evaluate(jm, params, lambda s: evals[s], steps=4)
    new, _, hist = jax_training.fit(
        jm, params, batches, STEPS, optimizer="adagrad", lr=LR,
        sparse=False, log_every=0, log_fn=lambda *_: None)
    auc1 = jax_training.evaluate(jm, new, lambda s: evals[s], steps=4)
    spec = {"sizes": DLRM_SIZES, "kw": DLRM_KW, "params": _np(params),
            "batches": batches, "evals": evals, "lr": LR}
    return spec, {"auc": [auc0, auc1], "loss": hist["loss"],
                  "params": _np(new)}


def _plain_state(state) -> dict:
    """The JAX step's state with numpy leaves and its optax parts as field
    dicts: nothing in it needs jax to unpickle."""
    state = _np(state)
    return {**state, "dense": [dict(part._asdict())
                               for part in state["dense"]]}


def _train_case(world, mesh, strategy, optimizer):
    jm = jax_synth.SyntheticModel(_jax_config(), mesh=mesh)
    params = jm.init(jax.random.PRNGKey(world))
    gen = pt_synth.InputGenerator(_pt_config(), BATCH, alpha=1.05,
                                  num_batches=STEPS, seed=world)
    batches = [(n.numpy(), [c.numpy() for c in cs], lab.numpy())
               for n, cs, lab in gen]
    spec = {"config": TRAIN_CONFIG, "optimizer": optimizer,
            "strategy": strategy, "lr": LR, "params": _np(params),
            "batches": batches}
    init, step = jax_training.make_sparse_train_step(jm, optimizer, lr=LR,
                                                     strategy=strategy)
    state = init(params)
    steps, before = [], []
    for num, cats, labels in batches:
        before.append((_np(params), _plain_state(state)))
        params, state, loss = step(params, state, jnp.asarray(num),
                                   [jnp.asarray(c) for c in cats],
                                   jnp.asarray(labels))
        steps.append({"loss": float(loss), "params": _np(params),
                      "state": _np(state)})
    if optimizer == "adam":
        spec["before"] = before
    return spec, {"steps": steps, "before": before, "batches": batches,
                  "layer": jm.embedding}


def _spawn(world, cases, tmp):
    """Run the cases on `world` gloo ranks; each rank's results."""
    spec_path = tmp / "cases.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(cases, f)
    ctx = torch_mp.start_processes(
        worker.main, args=(world, f"file://{tmp / 'pg'}", str(spec_path),
                           str(tmp)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, (
                f"{world} ranks did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    """world -> (each rank's results, the JAX package's), one spawn per
    world for the whole module."""
    runs = {}

    def get(world):
        if world not in runs:
            mesh = create_mesh(jax.devices()[:world])
            cases, refs = _forward_cases(world, mesh)
            for name, (w, strategy, optimizer) in TRAIN_CASES.items():
                if w == world:
                    spec, refs[name] = _train_case(world, mesh, strategy,
                                                   optimizer)
                    cases[name] = ("train", spec)
            spec, refs["shims"] = _shims_case(world, mesh)
            cases["shims"] = ("shims", spec)
            if world == 2:
                spec, refs["dlrm"] = _dlrm_case(world, mesh)
                cases["dlrm"] = ("dlrm", spec)
                spec, refs["dlrm_fit"] = _dlrm_fit_case(world, mesh)
                cases["dlrm_fit"] = ("dlrm_fit", spec)
            ranks = _spawn(world, cases,
                           tmp_path_factory.mktemp(f"world{world}"))
            runs[world] = (ranks, refs)
        return runs[world]
    return get


@pytest.mark.parametrize("name", list(FWD_INPUTS))
@pytest.mark.parametrize("world", WORLDS)
def test_forward_matches_jax(world_run, world, name):
    ranks, refs = world_run(world)
    i = list(FWD_INPUTS).index(name)
    got = np.concatenate([r["forward"]["outputs"][i] for r in ranks])
    np.testing.assert_allclose(got, refs["outputs"][i], **FWD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(world_run, world):
    ranks, _ = world_run(world)
    assert [r["jax_loaded"] for r in ranks] == [False] * world
    assert "jax" in sys.modules       # this process is the reference's


@pytest.mark.parametrize("world", WORLDS)
def test_params_from_jax_takes_each_ranks_shard(world_run, world):
    """Each rank loads its [rank] shard of the world-W tree; gathered back
    (`params_to_numpy`), the tree is the JAX package's."""
    ranks, refs = world_run(world)
    for r in ranks:
        _assert_tree_close(r["forward"]["tree"], refs["tree"])


@pytest.mark.parametrize("world", WORLDS)
def test_weights_round_trip_across_ranks(world_run, world):
    ranks, refs = world_run(world)
    for rank, r in enumerate(ranks):
        res = r["weights"]
        for got, want in zip(res["all"], refs["weights"]):
            np.testing.assert_array_equal(got, want)
        if rank == 0:
            for got, want in zip(res["root"], refs["weights"]):
                np.testing.assert_array_equal(got, want)
        else:
            assert res["root"] is None
        # set_weights placed every table where the JAX package does
        _assert_tree_close(res["tree"], refs["tree"])


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_variables(world_run, world):
    ranks, _ = world_run(world)
    root = ranks[0]["broadcast"]
    for r in ranks:
        res = r["broadcast"]
        np.testing.assert_array_equal(res["tensor"], np.zeros(3))
        for key in ("mlp_built", "mlp_after_callback"):
            for got, want in zip(res[key], root[key]):
                np.testing.assert_array_equal(got, want)
    # the bucket tables are rank-local shards: never broadcast
    for r in ranks[1:]:
        assert not all(np.array_equal(a, b) for a, b in zip(
            r["broadcast"]["tables"], root["tables"]))


@pytest.mark.parametrize("world", WORLDS)
def test_training_shims_match_jax(world_run, world):
    """The tape's averaged MLP gradients and loss are the JAX tape's on
    the global batch; the optimizer shim applies them (sgd)."""
    ranks, refs = world_run(world)
    ref = refs["shims"]
    for r in ranks:
        res = r["shims"]
        np.testing.assert_allclose(res["loss"], ref["loss"], **LOSS_TOL)
        for name, got in res["grads"].items():
            grad = _leaf(ref["grads"], name)
            np.testing.assert_allclose(got, grad, err_msg=name,
                                       **STATE_TOL)
            np.testing.assert_allclose(
                res["mlp"][name], _leaf(ref["params"], name) - LR * grad,
                err_msg=name, **STATE_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_what_stays_unported_raises(world_run, world):
    ranks, _ = world_run(world)
    for r in ranks:
        res = r["raises"]
        assert "not divisible" in res["indivisible"]
        for key in ("column_threshold", "fewer_tables_than_ranks",
                    "data_parallel"):
            assert "ROADMAP Queue A4" in res[key], (key, res[key])
        assert "process group" in res["world_size"]


def _per_table(layer, tree):
    """Global per-table arrays of a world-W embedding tree (the JAX
    layer's placement; the port's is the same)."""
    return layer.get_weights(tree["embedding"])


def _world1_scale(weights, mlp, batch) -> dict:
    """`gradient_scale` of the global batch on a world-1 port model with
    these weights, per MLP parameter and per table ("table.<t>")."""
    pm = pt_synth.SyntheticModel(_pt_config(), device="cpu")
    pm.embedding.set_weights(weights)
    with torch.no_grad():
        for i, layer in enumerate(mlp):
            pm.mlp[i].w.copy_(torch.tensor(np.asarray(layer["w"])))
            pm.mlp[i].b.copy_(torch.tensor(np.asarray(layer["b"])))
    scale = pt_training.gradient_scale(pm, *_torch_batch(batch))
    out = {n: (g.numpy(), t.numpy()) for n, (g, t) in scale.items()
           if not n.startswith("embedding")}
    strat = pm.embedding.strategy
    for pl_ in pm.embedding.plan.tp_placements:
        g, t = scale[f"embedding.tp.{pl_.bucket}"]
        rows = slice(pl_.row_offset, pl_.row_offset + pl_.rows)
        out[f"table.{strat.table_groups[1][pl_.table_id]}"] = (
            g[rows].numpy(), t[rows].numpy())
    return out


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_steps_match_jax(world_run, case):
    world, _, optimizer = TRAIN_CASES[case]
    ranks, refs = world_run(world)
    ref = refs[case]
    for r in ranks:
        got = r[case]["steps"]
        np.testing.assert_allclose([s["loss"] for s in got],
                                   [s["loss"] for s in ref["steps"]],
                                   **LOSS_TOL)
        checked = range(STEPS) if optimizer == "adam" else [STEPS - 1]
        for i in checked:
            mine, want = got[i], ref["steps"][i]
            _assert_tree_close(mine["state"]["emb"], want["state"]["emb"])
            _assert_tree_close(mine["state"]["dense"],
                               _jax_dense_state(want["state"]["dense"]))
            if optimizer != "adam":
                _assert_tree_close(mine["params"], want["params"])
                continue
            before = ref["before"][i][0]
            scale = _world1_scale(_per_table(ref["layer"], before),
                                  before["mlp"], ref["batches"][i])
            tables = zip(_per_table(ref["layer"], mine["params"]),
                         _per_table(ref["layer"], want["params"]))
            for t, (g_t, w_t) in enumerate(tables):
                _assert_adam_step_close(g_t, w_t, *scale[f"table.{t}"], LR,
                                        f"step {i} table {t}")
            for name, (g, t) in scale.items():
                if not name.startswith("table."):
                    _assert_adam_step_close(
                        _leaf(mine["params"], name),
                        _leaf(want["params"], name), g, t, LR,
                        f"step {i} {name}")


@pytest.mark.parametrize("check", ["forward", "adagrad-step"])
def test_dlrm_matches_jax(world_run, check):
    """DLRM at W = 2: every rank builds it (a collective broadcast of the
    MLPs); the logits of the ranks' slices, in order, are the JAX DLRM's
    on the global batch, and one sort adagrad step gives its loss, tables,
    MLPs and optimizer state."""
    ranks, refs = world_run(2)
    ref = refs["dlrm"]
    if check == "forward":
        got = np.concatenate([r["dlrm"]["logits"] for r in ranks])
        np.testing.assert_allclose(got, ref["logits"], **FWD_TOL)
        return
    for r in ranks:
        res = r["dlrm"]
        np.testing.assert_allclose(res["loss"], ref["loss"], **LOSS_TOL)
        _assert_tree_close(res["params"], ref["params"])
        _assert_tree_close(res["state"]["emb"], ref["state"]["emb"])
        _assert_tree_close(res["state"]["dense"],
                           _jax_dense_state(ref["state"]["dense"]))


def test_worker_module_imports_no_jax():
    """The ranks' module and the port's sources name no jax (a rank would
    import it when it unpickles the worker function)."""
    with open(os.path.join(os.path.dirname(__file__),
                           "torch_multigpu_worker.py")) as f:
        source = f.read()
    assert "import jax" not in source and "distributed_embeddings_tpu." \
        not in source


def test_dlrm_evaluate_and_dense_fit_match_jax(world_run):
    """W = 2: `evaluate` (each rank's histograms of its slice, summed over
    the ranks) before and after three dense adagrad steps
    (``fit(sparse=False)``: the table gradients through the activation
    exchange's transpose, scaled by 1/W), against the JAX package on the
    mesh: AUCs within 1e-4, losses rtol 1e-5, every parameter rtol 1e-5 /
    atol 1e-6."""
    ranks, refs = world_run(2)
    ref = refs["dlrm_fit"]
    for r in ranks:
        res = r["dlrm_fit"]
        np.testing.assert_allclose(res["auc"], ref["auc"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(res["loss"], ref["loss"], **LOSS_TOL)
        got = jax.tree.leaves(res["params"])
        want = jax.tree.leaves(ref["params"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # the histograms are summed: every rank reads the same AUC
    assert ranks[0]["dlrm_fit"]["auc"] == ranks[1]["dlrm_fit"]["auc"]
