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
  an indivisible batch, what builds at W > 1 (the wires, hot rows, host
  offload, the vocabulary slack and the engine's cache among it), what
  refuses a world above one (the vocabulary manager, the store's
  producer) and what stays unported (the ragged exchange: ROADMAP Queue
  A5);
* the serving tier across ranks: the JAX package's
  `test_engine_streaming_consumption` on a layer with an offloaded
  bucket (cached), a row-sliced and a dp table, the stream files written
  by the JAX store on the mesh, replayed stage by stage against the JAX
  engine there (outputs, cache stats, slot keys and weights bit-equal, on
  every rank), with a payload read failing on rank 1 only (every rank
  at the same version with the same degraded reasons);
* at W = 2, a small DLRM's `evaluate` and three dense adagrad steps
  (``fit(sparse=False)``) over global click-stream batches;
* the placement groups (the JAX package's `test_dist_model_parallel`
  configurations at W = 2 and 4): the forward of layers with
  data-parallel tables (one of them of a layer class with its own
  forward), column-sliced table-parallel tables and row-sliced tables,
  multi-hot, weighted, mean and combiner None among them (rtol 1e-5 /
  atol 1e-6), each rank's plan, the JAX tree after `set_weights` and
  `get_weights` back; model-parallel input (``dp_input=False``) against
  the JAX package's `apply_mp`, and its sparse step against the
  data-parallel one; three sparse steps (sgd, adagrad, adam at W = 2,
  adagrad at W = 4) and one dense adagrad step of the synthetic model
  with dp and row groups; `InferenceEngine` on a request the world does
  not divide, against the JAX engine; the JAX params and optimizer state
  with dp and row leaves through `convert` and back; and each wire
  collective's backward against its forward's transpose;
* quantized storage at W = 2 (``storage_dtype="int8"``, one sum and one
  mean bucket at hotness 2): each rank loads its shard of the JAX
  package's tree (payloads and scales), its forward bit-equal to the JAX
  layer's on the mesh, three sgd steps of a model whose loss is linear in
  the outputs, the ranks' payloads and scales bit-equal to the JAX step's
  after every step; and resume on the two ranks (int8 adagrad: 2 steps,
  `utils.checkpoint.save_checkpoint`, 2 more; a fresh layer restored and
  trained the same 2 steps is bit-equal on every rank);
* mixed precision (``compute_dtype`` bfloat16): a layer of every placement
  group (multi-hot weighted mean and sum and combiner-None row tables, a
  multi-hot mean dp table, a passthrough and a one-hot tp table, the
  routes on which the JAX package's CPU reference and the port round
  alike), its outputs bfloat16, bit-equal at hotness 1 and through the
  passthroughs, within `AMP_ULP` elsewhere; three sparse adagrad steps
  of the train model with its placement groups at bfloat16 (losses rtol
  1e-5, tables, state and MLPs rtol 1e-4 / atol 1e-6), every float
  payload of the wire's all_to_all, all_gather and reduce-scatter
  bfloat16.
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
import optax  # noqa: E402
import torch.multiprocessing as torch_mp  # noqa: E402

from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.models import dlrm as jax_dlrm  # noqa: E402
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu.serving.engine import (  # noqa: E402
    InferenceEngine as JaxInferenceEngine)
from distributed_embeddings_tpu.store import (  # noqa: E402
    TableStore as JaxTableStore)
from distributed_embeddings_tpu_torch import training as pt_training  # noqa: E402
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as PtDistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import (  # noqa: E402
    Embedding as PtEmbedding)
from distributed_embeddings_tpu_torch.store import (  # noqa: E402
    TableStore as PtTableStore)
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402

import torch_multigpu_worker as worker  # noqa: E402
from test_serving import _zipf  # noqa: E402
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
# the train config's placement groups: its three 50 x 8 tables
# data-parallel, the 200 x 8 (two inputs) and both 100 x 16 row-sliced, the
# 300 x 4 table-parallel (cut into columns: fewer tables than ranks)
PLACED_KW = dict(data_parallel_threshold=400, row_slice_threshold=1600)
# case -> (world, strategy, optimizer[, placement arguments])
TRAIN_CASES = {
    "w2-sort-sgd": (2, "sort", "sgd"),
    "w2-sort-adagrad": (2, "sort", "adagrad"),
    "w2-sort-adam": (2, "sort", "adam"),
    "w2-tiled-adagrad": (2, "tiled", "adagrad"),
    "w4-sort-adagrad": (4, "sort", "adagrad"),
    "w2-placed-sgd": (2, "sort", "sgd", PLACED_KW),
    "w2-placed-adagrad": (2, "sort", "adagrad", PLACED_KW),
    "w2-placed-adam": (2, "sort", "adam", PLACED_KW),
    "w4-placed-adagrad": (4, "sort", "adagrad", PLACED_KW),
    "w2-placed-adagrad-bf16": (2, "sort", "adagrad",
                               dict(PLACED_KW, compute_dtype="bfloat16")),
    "w4-placed-adagrad-bf16": (4, "sort", "adagrad",
                               dict(PLACED_KW, compute_dtype="bfloat16")),
}

# the JAX package's test_dist_model_parallel configurations: name ->
# (tables (rows, width, combiner, scaled), input table map, placement
# arguments); inputs as its `check_equivalence` makes them (1-D where the
# table has no combiner, hotness 2 + i % 3 otherwise), plus weighted ones
MB = dict(strategy="memory_balanced")
PLACEMENTS = {
    "all_modes": (  # test_all_parallelism_modes
        [(10, 4, None, False), (96, 8, None, False), (50, 8, None, False),
         (1000, 16, None, False), (2000, 16, None, False),
         (30, 4, None, False), (800, 8, None, False), (64, 8, None, False)],
        None, dict(MB, column_slice_threshold=400, row_slice_threshold=12800,
                   data_parallel_threshold=200)),
    "shared_all_modes": (  # test_shared_tables_all_modes
        [(10, 4, None, False), (1000, 8, None, False),
         (4000, 16, None, False)],
        [0, 1, 2, 1, 0], dict(MB, data_parallel_threshold=100,
                              row_slice_threshold=60000,
                              column_slice_threshold=1000)),
    "multihot_row_slice": (  # test_multihot_row_slice
        [(2000, 8, "sum", False), (96, 8, "sum", False),
         (50, 8, "sum", False), (80, 8, "sum", False)],
        None, dict(MB, row_slice_threshold=8000)),
    "roundtrip": (  # test_get_set_weights_roundtrip
        [(96, 8, None, False), (50, 8, None, False),
         (1000, 16, None, False), (2000, 16, None, False)],
        None, dict(MB, column_slice_threshold=2000,
                   row_slice_threshold=30000)),
    "custom_dp": (  # test_custom_layer_class_dp_runs_real_forward
        [(v, 8, None, v < 100) for v in (40, 48, 56, 64, 3000, 3200, 3400,
                                         3600)],
        None, dict(MB, data_parallel_threshold=600)),
    "weighted_mean_none": (  # row tables: weighted mean, weighted sum, None
        [(3000, 8, "mean", False), (2500, 4, "sum", False),
         (2200, 8, None, False), (96, 8, "sum", False),
         (50, 8, "mean", False), (80, 8, "sum", False)],
        None, dict(MB, row_slice_threshold=9000,
                   data_parallel_threshold=500)),
}
WEIGHTED = {("weighted_mean_none", 0), ("weighted_mean_none", 1),
            ("weighted_mean_none", 4)}
# the placement groups at bfloat16: (rows, width, combiner, hotness,
# weighted) per table, one input each. Row-sliced: a weighted mean, a
# weighted sum and a combiner-None table, multi-hot; data-parallel: a
# multi-hot mean; table-parallel: a passthrough and a one-hot sum. The
# JAX package's CPU reference rounds these as the port does (rows first
# on the dp and row groups; one row on the tp groups)
AMP_TABLES = [(3000, 8, "mean", 3, True), (2500, 8, "sum", 4, True),
              (2200, 8, None, 2, False), (50, 8, "mean", 3, False),
              (96, 8, None, 3, False), (800, 8, "sum", 1, False)]
AMP_KW = dict(MB, row_slice_threshold=9000, data_parallel_threshold=500,
              compute_dtype="bfloat16")
# the multi-hot outputs' bar: one ulp for the order of a K-term float32
# sum; a row table's output is also the reduce-scatter's bfloat16 sum of
# the W ranks' rounded partials, which gloo adds rounding at each add and
# XLA on the CPU in its own order: at W > 2 they differ by up to W - 1
# roundings, each within 2^-8 of the sum of the terms' magnitudes
AMP_ULP = 1
AMP_ADD_EPS = 2.0 ** -8

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
                                   "indivisible": [np.zeros(BATCH + 1)],
                                   "lookahead": LOOKAHEAD_REFUSALS})}
    return cases, {"outputs": outs, "tree": tree, "weights": weights}


class _JaxScaled(JaxEmbedding):
    """The JAX test's `_ScaledEmbedding`: twice the rows."""

    def __call__(self, params, inputs):
        return 2.0 * jnp.take(params["embeddings"], jnp.asarray(inputs),
                              axis=0)


def _placement_case(world, mesh, name):
    """The JAX layer of a `PLACEMENTS` configuration on the mesh: its
    outputs on a global batch, its plan and its tree after `set_weights`."""
    tables, table_map, kw = PLACEMENTS[name]
    rng = np.random.RandomState(world * 100 + len(name))
    table_map = table_map or list(range(len(tables)))
    inputs = []
    for i, t in enumerate(table_map):
        rows, _, combiner, _ = tables[t]
        k = 2 + i % 3
        if combiner is None and (name, t) != ("weighted_mean_none", 2):
            inputs.append(rng.randint(0, rows, size=(BATCH,)).astype(
                np.int32))
            continue
        ids = rng.randint(0, rows, size=(BATCH, k)).astype(np.int32)
        if (name, t) in WEIGHTED:
            w = rng.rand(BATCH, k).astype(np.float32)
            w[:, -1] *= rng.rand(BATCH) > 0.3      # some padded slots
            inputs.append((ids, w))
        else:
            inputs.append(ids)
    weights = [rng.randn(r, w).astype(np.float32) * 0.1
               for r, w, _, _ in tables]
    jl = JaxDistributedEmbedding(
        [(_JaxScaled if scaled else JaxEmbedding)(r, w, combiner=c)
         for r, w, c, scaled in tables],
        mesh=mesh, input_table_map=table_map, **kw)
    params = jl.set_weights(weights)
    outs = [np.asarray(o) for o in jl.apply(params, _jax_inputs(inputs))]
    spec = {"tables": tables, "table_map": table_map, "kw": kw,
            "weights": weights, "inputs": inputs, "tree": _np(params)}
    return spec, {"outputs": outs, "tree": _np(params), "weights": weights,
                  "groups": jl.strategy.table_groups,
                  "placements": len(jl.plan.tp_placements),
                  "buckets": len(jl.plan.tp_buckets),
                  # after the forward: its exchange paths are recorded
                  "report": jl.exchange_padding_report()}


def _amp_placement_case(world, mesh):
    """`AMP_TABLES` at bfloat16 on the mesh: the JAX layer's outputs on a
    global batch."""
    rng = np.random.RandomState(70 + world)
    inputs = []
    for rows, _, _, k, weighted in AMP_TABLES:
        shape = (BATCH,) if k == 1 else (BATCH, k)
        ids = rng.randint(0, rows, size=shape).astype(np.int32)
        if weighted:
            w = rng.rand(BATCH, k).astype(np.float32)
            w[:, -1] *= rng.rand(BATCH) > 0.3      # some padded slots
            inputs.append((ids, w))
        else:
            inputs.append(ids)
    weights = [rng.randn(r, w).astype(np.float32) * 0.1
               for r, w, _, _, _ in AMP_TABLES]
    tables = [(r, w, c, False) for r, w, c, _, _ in AMP_TABLES]
    jl = JaxDistributedEmbedding(
        [JaxEmbedding(r, w, combiner=c) for r, w, c, _ in tables],
        mesh=mesh, **dict(AMP_KW, compute_dtype=jnp.bfloat16))
    params = jl.set_weights(weights)
    outs = jl.apply(params, _jax_inputs(inputs))
    spec = {"tables": tables, "table_map": list(range(len(tables))),
            "kw": AMP_KW, "weights": weights, "inputs": inputs,
            "tree": _np(params)}
    # each output's sum of its terms' magnitudes, sum_k |w_k| |row_k|
    terms = []
    for (ids, w), table, (_, _, combiner, k, _) in zip(
            [x if isinstance(x, tuple) else (x, None) for x in inputs],
            weights, AMP_TABLES):
        rows = np.abs(table[ids.reshape(BATCH, -1)])
        if w is None:
            w = np.ones(rows.shape[:2], np.float32)
        if combiner == "mean":
            w = w / np.maximum(w.sum(1, keepdims=True), 1.0)
        terms.append(np.einsum("bk,bkw->bw", np.abs(w), rows))
    return spec, {"outputs": [np.asarray(o) for o in outs],
                  "groups": jl.strategy.table_groups, "terms": terms}


def _mp_case(world, mesh):
    """test_mp_input_column_slice's layer (ONE_HOT_8, memory_balanced,
    column_slice_threshold 400) with ``dp_input=False`` on the mesh: its
    `apply_mp` outputs on per-rank feature lists; and a global batch and
    weights for one sparse step of the train model."""
    rng = np.random.RandomState(40 + world)
    specs = [(96, 8), (50, 8), (100, 16), (120, 8), (40, 16), (70, 8),
             (60, 8), (81, 8)]
    tables = [(r, w, None, False) for r, w in specs]
    inputs = [rng.randint(0, r, size=(BATCH,)).astype(np.int32)
              for r, _ in specs]
    weights = [rng.randn(r, w).astype(np.float32) * 0.1 for r, w in specs]
    kw = dict(MB, column_slice_threshold=400)
    jl = JaxDistributedEmbedding(
        [JaxEmbedding(r, w) for r, w in specs], mesh=mesh, dp_input=False,
        input_max_hotness=[1] * len(specs), **kw)
    params = jl.set_weights(weights)
    mp_in = [[jnp.asarray(inputs[jl.strategy.input_groups[1][pos]])
              for pos in ids] for ids in jl.strategy.input_ids_list]
    outs = [np.asarray(o) for o in jl.apply_mp(params, mp_in)]
    jm = jax_synth.SyntheticModel(_jax_config(), mesh=mesh)
    model_params = jm.init(jax.random.PRNGKey(50 + world))
    num, cats, labels = pt_synth.InputGenerator(
        _pt_config(), BATCH, alpha=1.05, num_batches=1, seed=50 + world)[0]
    # hotness-1 ids 1-D, as model-parallel input takes them
    cats = [c.numpy()[:, 0] if c.shape[1] == 1 else c.numpy() for c in cats]
    spec = {"tables": tables, "table_map": list(range(len(specs))),
            "hotness": [1] * len(specs), "kw": kw, "weights": weights,
            "inputs": inputs, "config": TRAIN_CONFIG,
            "params": _np(model_params),
            "batch": (num.numpy(), cats, labels.numpy()), "lr": LR}
    return spec, {"outputs": outs}


# the lookahead engine's refusals that need dp tables, which a single rank
# never plans: name -> (tables (rows, width, combiner, scaled), placement
# arguments, the reason the JAX engine gives,
# tests/test_torch_lookahead.py)
LOOKAHEAD_REFUSALS = {
    "all_dp": ([(32, 8, "sum", False), (16, 8, "sum", False)],
               dict(data_parallel_threshold=10_000), "nothing to prefetch"),
    "custom_dp": (PLACEMENTS["custom_dp"][0], PLACEMENTS["custom_dp"][2],
                  "custom embedding layer classes"),
}

# the serving tier across ranks: tests/test_serving.py's tables (two
# 5000-row tables past the device budget, each rank's offloaded bucket,
# fed at hotness 2), a 40-row dp table and an 8000-row row-sliced one
STREAM_TABLES = [(5000, 16, "sum"), (40, 16, "sum"), (5000, 16, "sum"),
                 (64, 16, "sum"), (128, 16, "sum"), (96, 16, "sum"),
                 (80, 16, "sum"), (72, 16, "sum"), (8000, 16, "sum")]
STREAM_KW = dict(gpu_embedding_size=2500 * 16, data_parallel_threshold=700,
                 row_slice_threshold=100_000)
STREAM_HOTNESS = [2, 1, 2, 1, 1, 1, 1, 1, 1]
STREAM_ROWS = 16
STREAM_CAPACITY = 12


def _stream_request(rng, zipf: bool) -> list:
    """One request: the JAX test's hot ids (0..3, and 4..7 as the second
    id of a hotness-2 input), or zipf ids over each table."""
    out = []
    for (rows, _, _), k in zip(STREAM_TABLES, STREAM_HOTNESS):
        if zipf:
            ids = _zipf(rng, rows, STREAM_ROWS * k).reshape(STREAM_ROWS, k)
        else:
            base = np.tile(np.arange(4, dtype=np.int32), STREAM_ROWS // 4)
            ids = np.stack([base + 4 * j for j in range(k)], 1)
        out.append(ids[:, 0].astype(np.int32) if k == 1
                   else ids.astype(np.int32))
    return out


def _stream_case(world, mesh, tmp):
    """`test_engine_streaming_consumption` on a W-device mesh: the JAX
    store publishes a snapshot (v1), a delta on the hot rows (v2) and two
    more deltas (v3, v4: the second chains from the version the
    consumer's `set_params` gives it); the JAX engine then runs the
    worker's stages (`torch_multigpu_worker.stream`) in its order."""
    rng = np.random.RandomState(4)
    jl = JaxDistributedEmbedding(
        [JaxEmbedding(r, w, combiner=c) for r, w, c in STREAM_TABLES],
        mesh=mesh, **STREAM_KW)
    assert jl._offload_enabled and jl.plan.row_tables \
        and jl.strategy.table_groups[0]
    w0 = [rng.randn(r, w).astype(np.float32) * 0.1
          for r, w, _ in STREAM_TABLES]
    w1 = [w.copy() for w in w0]
    for w in w1:
        w[:8] += 1.0
    hot = [_stream_request(rng, False)]
    zipf = [_stream_request(rng, True) for _ in range(2)]
    d = str(tmp / f"stream{world}")
    prod = JaxTableStore(jl, jl.set_weights(w0))
    prod.commit(prod.params)
    assert prod.publish(d)["kind"] == "snapshot"
    touched = jl.touched_row_keys(hot[0])
    assert ("row", 0) in touched
    prod.commit(jl.set_weights(w1), touched=touched)
    assert prod.publish(d)["kind"] == "delta"
    paths = []
    for _ in range(2):
        prod.commit(prod.params, touched=touched)
        paths.append(prod.publish(d))
    assert [p["base_version"] for p in paths] == [2, 3]
    zeros = [np.zeros_like(w) for w in w0]
    eng = JaxInferenceEngine(jl, jl.set_weights(zeros),
                             cache_capacity=STREAM_CAPACITY,
                             promote_threshold=1)
    ref = {}

    def stage(name, infos, requests=()):
        outs = [[np.asarray(a) for a in eng.predict(req)]
                for req in requests]
        ref[name] = {"infos": [(i["kind"], i["version"]) for i in infos],
                     "outputs": outs, "cache": eng.cache_stats(),
                     "slot_keys": {b: c._slot_keys.copy()
                                   for b, c in eng.caches.items()},
                     "version": eng.store.version,
                     "weights": eng.store.get_weights()}
    stage("snapshot", eng.poll_updates(d, upto=1), hot)
    stage("delta", eng.poll_updates(d, upto=2), hot + zipf)
    eng.set_params(jl.set_weights(w0), refresh=True)
    stage("set_params", [], hot)
    stage("reanchor", eng.poll_updates(d, upto=4), hot)
    v = eng.reanchor_published(d, upto=2)
    stage("reanchored", [{"kind": "reanchor", "version": v}], hot)
    assert ref["delta"]["cache"]["buckets"] and any(
        b["evictions"] for b in ref["delta"]["cache"]["buckets"].values())
    # the port's publisher is world 1: its placement differs from the
    # ranks' (the dp and row-sliced tables are table-parallel there), so
    # its delta's bucket keys are re-keyed on every rank
    pub = PtDistributedEmbedding(
        [PtEmbedding(r, w, combiner=c, device="meta")
         for r, w, c in STREAM_TABLES], device="cpu", **STREAM_KW)
    pub.set_weights(w0)
    pstore = PtTableStore(pub)
    port_dir = str(tmp / f"port{world}")
    pstore.commit()
    pstore.publish(port_dir)
    ref["port"] = [pub.get_weights()]
    pub.set_weights(w1)
    pstore.commit(touched=pub.touched_row_keys(
        [np.arange(8, dtype=np.int32)] * len(STREAM_TABLES)))
    assert pstore.publish(port_dir)["kind"] == "delta"
    ref["port"].append(pub.get_weights())
    spec = {"tables": STREAM_TABLES, "kw": STREAM_KW, "zeros": zeros,
            "weights": w0, "capacity": STREAM_CAPACITY, "dir": d,
            "hot": hot, "zipf": zipf, "aliasing": paths[1]["path"],
            "port_dir": port_dir}
    return spec, ref


def _placed_model_case(world, mesh):
    """The train model with its placement groups on the mesh: one dense
    adagrad step (`make_train_step`) over a global batch; the JAX engine's
    logits on a request of BATCH + 1 rows; one sparse adam step's state,
    for the `convert` round trip."""
    jm = jax_synth.SyntheticModel(_jax_config(), mesh=mesh, **PLACED_KW)
    params = jm.init(jax.random.PRNGKey(60 + world))
    gen = pt_synth.InputGenerator(_pt_config(), BATCH, alpha=1.05,
                                  num_batches=2, seed=60 + world)
    num, cats, labels = gen[0]
    num, cats, labels = num.numpy(), [c.numpy() for c in cats], labels.numpy()
    batch = (num, cats, labels)
    opt = optax.adagrad(LR)
    step = jax_training.make_train_step(jm.loss_fn, opt)
    new, _, loss = step(params, opt.init(params), jnp.asarray(num),
                        [jnp.asarray(c) for c in cats], jnp.asarray(labels))
    r_num, r_cats, _ = gen[1]
    r_num = np.concatenate([r_num.numpy(), r_num.numpy()[:1]])
    r_cats = [np.concatenate([c.numpy(), c.numpy()[:1]]) for c in r_cats]
    logits = np.asarray(JaxInferenceEngine(jm, params).predict(
        (jnp.asarray(r_num), [jnp.asarray(c) for c in r_cats])))
    init, sstep = jax_training.make_sparse_train_step(jm, "adam", lr=LR,
                                                      strategy="sort")
    _, state, _ = sstep(params, init(params), jnp.asarray(num),
                        [jnp.asarray(c) for c in cats], jnp.asarray(labels))
    spec = {"config": TRAIN_CONFIG, "kw": PLACED_KW, "params": _np(params),
            "batch": batch, "lr": LR, "request": (r_num, r_cats),
            "state": _plain_state(state)}
    return spec, {"dense": {"loss": float(loss), "params": _np(new)},
                  "logits": logits, "params": _np(params),
                  "state": _np(state)}


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


# (rows, width, combiner): buckets (8, sum) and (8, mean), hotness 2
QUANT_TABLES = [(40, 8, "sum"), (30, 8, "sum"), (50, 8, "mean"),
                (24, 8, "mean")]


class _JaxLinear:
    """The JAX side of the quantized case's model: the mean over the batch
    of the outputs times fixed coefficients (a power-of-two batch, so each
    rank's tap gradient is the same numbers)."""

    def __init__(self, layer, coefs):
        self.embedding, self.coefs = layer, coefs

    def loss_fn(self, params, numerical, cats, labels, taps=None,
                return_residuals=False):
        outs, res = self.embedding.apply(params["embedding"], cats,
                                         taps=taps, return_residuals=True)
        loss = sum(jnp.sum(o * c) for o, c in zip(outs, self.coefs)) / BATCH
        return (loss, res) if return_residuals else loss


def _quantized_case(world, mesh, tmp):
    """The JAX layer at ``storage_dtype="int8"`` on the mesh: its tree
    after `set_weights`, its forward on a global batch, and its tree after
    each of three sgd steps of `_JaxLinear`."""
    rng = np.random.RandomState(40 + world)
    jl = JaxDistributedEmbedding(
        [JaxEmbedding(r, w, combiner=c) for r, w, c in QUANT_TABLES],
        mesh=mesh, storage_dtype="int8")
    weights = [(rng.randn(r, w) * rng.choice([0.01, 1.0], size=(r, 1)))
               .astype(np.float32) for r, w, _ in QUANT_TABLES]
    params = {"embedding": jl.set_weights(weights)}
    batches = [[rng.randint(0, min(r, 12), size=(BATCH, 2)).astype(np.int32)
                for r, _, _ in QUANT_TABLES] for _ in range(STEPS + 1)]
    coefs = [rng.randn(BATCH, w).astype(np.float32)
             for _, w, _ in QUANT_TABLES]
    outs = [np.asarray(o) for o in jl.apply(
        params["embedding"], _jax_inputs(batches[0]))]
    tree = _np(params["embedding"])
    init, step = jax_training.make_sparse_train_step(
        _JaxLinear(jl, coefs), "sgd", lr=LR)
    state, trees = init(params), []
    dummy = jnp.zeros((BATCH, 1), jnp.float32)
    for cats in batches[:STEPS]:
        params, state, _ = step(params, state, dummy, _jax_inputs(cats),
                                dummy)
        trees.append(_np(params["embedding"]))
    spec = {"tables": QUANT_TABLES, "tree": tree, "batches": batches,
            "coefs": coefs, "lr": LR, "dir": str(tmp)}
    return spec, {"outputs": outs, "tree": tree, "trees": trees}


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


def _train_case(world, mesh, strategy, optimizer, kw=None):
    jm = jax_synth.SyntheticModel(_jax_config(), mesh=mesh, **(kw or {}))
    params = jm.init(jax.random.PRNGKey(world))
    gen = pt_synth.InputGenerator(_pt_config(), BATCH, alpha=1.05,
                                  num_batches=STEPS, seed=world)
    batches = [(n.numpy(), [c.numpy() for c in cs], lab.numpy())
               for n, cs, lab in gen]
    spec = {"config": TRAIN_CONFIG, "optimizer": optimizer,
            "strategy": strategy, "lr": LR, "params": _np(params),
            "batches": batches, "kw": kw or {}}
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
            for name, (w, *args) in TRAIN_CASES.items():
                if w == world:
                    spec, refs[name] = _train_case(world, mesh, *args)
                    cases[name] = ("train", spec)
            for name in PLACEMENTS:
                spec, refs[f"placement:{name}"] = _placement_case(
                    world, mesh, name)
                cases[f"placement:{name}"] = ("placement", spec)
            spec, refs["amp_placement"] = _amp_placement_case(world, mesh)
            cases["amp_placement"] = ("placement", spec)
            spec, refs["mp"] = _mp_case(world, mesh)
            cases["mp"] = ("mp_forward", spec)
            spec, refs["placed"] = _placed_model_case(world, mesh)
            for kind in ("dense_step", "engine", "convert"):
                cases[kind] = (kind, spec)
            cases["wire"] = ("wire", {"seed": world})
            spec, refs["shims"] = _shims_case(world, mesh)
            cases["shims"] = ("shims", spec)
            spec, refs["stream"] = _stream_case(
                world, mesh, tmp_path_factory.mktemp("stream"))
            cases["stream"] = ("stream", spec)
            if world == 2:
                spec, refs["quantized"] = _quantized_case(
                    world, mesh, tmp_path_factory.mktemp("checkpoints"))
                cases["quantized"] = ("quantized", spec)
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
    """What the port builds at W > 1 (column slicing, fewer tables than
    ranks, the dp and row groups, model-parallel input, the engine and
    its hot-row cache, the wire formats, hot rows, host offload, the
    vocabulary slack); what stays unported raises naming its ROADMAP
    item; the vocabulary manager and the store's producer refuse a world
    above one; the store's consumer is collective: a file that one rank
    cannot read fails on every rank with the same error."""
    ranks, _ = world_run(world)
    for r in ranks:
        res = r["raises"]
        assert "not divisible" in res["indivisible"]
        for key in ("column_threshold", "fewer_tables_than_ranks",
                    "data_parallel", "row_slice", "dp_input", "engine",
                    "storage_dtype", "exchange_wire", "bf16_all_gather",
                    "hot_rows", "gpu_embedding_size", "vocab_slack",
                    "engine_cache"):
            assert res[key] is None, (key, res[key])
        for key in ("vocab_manager", "store_producer"):
            assert "single-process" in (res[key] or ""), (key, res[key])
        assert "ROADMAP Queue A5 " in (res["ragged_exchange"] or "")
        # lookahead: the JAX engine's reasons, and the multi-process one
        for name, (_, _, reason) in LOOKAHEAD_REFUSALS.items():
            assert reason in (res[f"lookahead_{name}"] or ""), name
        assert "single-process" in (res["lookahead_world"] or "")
        assert "NCCL (ROADMAP Queue A3)" in res["lookahead_world"]
        assert (res["store_consumer"] or "").startswith(
            "rank 0: FileNotFoundError"), res["store_consumer"]
        assert "process group" in res["world_size"]


STREAM_STAGES = ("snapshot", "delta", "set_params", "reanchor",
                 "reanchored")


@pytest.mark.parametrize("stage", STREAM_STAGES)
@pytest.mark.parametrize("world", WORLDS)
def test_stream_consumption_matches_jax(world_run, world, stage):
    """The serving tier across ranks (`torch_multigpu_worker.stream`)
    against the JAX engine on the mesh, stage by stage: the files
    applied, every output bit-equal (and equal to the uncached engine's
    on the same layer), the cache stats and every slot's key, the store
    version and the global weights bit-equal, on every rank."""
    ranks, refs = world_run(world)
    want = refs["stream"][stage]
    for rank, r in enumerate(ranks):
        got = r["stream"][stage]
        assert got["infos"] == want["infos"], rank
        assert got["uncached_equal"] == [True] * len(want["outputs"])
        for g_req, w_req in zip(got["outputs"], want["outputs"],
                                strict=True):
            for g, w in zip(g_req, w_req, strict=True):
                np.testing.assert_array_equal(g, w)
        assert got["cache"] == want["cache"], rank
        assert got["slot_keys"].keys() == want["slot_keys"].keys()
        for b, keys in want["slot_keys"].items():
            np.testing.assert_array_equal(got["slot_keys"][b], keys)
        assert got["version"] == want["version"]
        for g, w in zip(got["weights"], want["weights"], strict=True):
            np.testing.assert_array_equal(g, w)
        assert got["update_stats"] == ranks[0]["stream"][stage][
            "update_stats"]


@pytest.mark.parametrize("world", WORLDS)
def test_world1_publisher_stream_rekeyed_across_ranks(world_run, world):
    """The port's own publisher is world 1: every rank re-keys its
    deltas' bucket keys onto the rank's placement (its dp and row-sliced
    tables among them) and holds the publisher's weights bit for bit at
    each version, cached serving equal to uncached."""
    ranks, refs = world_run(world)
    for r in ranks:
        got = r["stream"]["port_stream"]
        assert [g["infos"] for g in got] == [[("snapshot", 1)],
                                             [("delta", 2)]]
        for g, want in zip(got, refs["stream"]["port"], strict=True):
            assert g["degraded"] == [] and all(g["uncached_equal"])
            for a, b in zip(g["weights"], want, strict=True):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_stream_read_fault_agrees_across_ranks(world_run, world):
    """Rank 1's payload reads fail while the others' succeed: every rank
    stays at the snapshot's version with the same degraded reasons, the
    same error type and the same poll error count (a transient error:
    retried, then `io_transient`; another: `poll_error`); the next sound
    poll catches every rank up; a delta that chains only by version after
    `set_params` is refused on every rank."""
    ranks, _ = world_run(world)
    for name, reasons, kind, errors in (
            ("transient", ["io_transient"], None, 0),
            ("error", ["io_transient", "poll_error"], "RuntimeError", 1)):
        for r in ranks:
            got = r["stream"][name]
            assert got["infos"] == [] and got["version"] == 1, name
            assert got["degraded"] == reasons, (name, got["degraded"])
            assert (got["last_poll_error"] or "").split(":")[0] == \
                (kind or ""), got["last_poll_error"]
            assert got["poll_errors"] == errors
            assert got["update_stats"] == ranks[0]["stream"][name][
                "update_stats"]
    for r in ranks:
        assert "rank 1: KeyError" in r["stream"]["error"]["last_poll_error"]
        assert r["stream"]["delta"]["degraded"] == []
        assert "out of band" in (r["stream"]["aliasing_refused"] or "")


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
    world, _, optimizer, *_ = TRAIN_CASES[case]
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


@pytest.mark.parametrize("name", list(PLACEMENTS))
@pytest.mark.parametrize("world", WORLDS)
def test_placement_forward_matches_jax(world_run, world, name):
    """The ranks' slices, in order, are the JAX layer's outputs on the
    global batch (rtol 1e-5 / atol 1e-6), whether the layer was written by
    `set_weights` or loaded from the JAX tree."""
    ranks, refs = world_run(world)
    ref = refs[f"placement:{name}"]
    for i, want in enumerate(ref["outputs"]):
        got = np.concatenate([r[f"placement:{name}"]["outputs"][i]
                              for r in ranks])
        np.testing.assert_allclose(got, want, err_msg=f"output {i}",
                                   **FWD_TOL)
    assert all(r[f"placement:{name}"]["loaded_equal"] for r in ranks)


@pytest.mark.parametrize("name", list(PLACEMENTS))
@pytest.mark.parametrize("world", WORLDS)
def test_placement_plan_and_weights_match_jax(world_run, world, name):
    """Every rank plans the JAX layer's groups, placements and buckets;
    `set_weights` puts every table where the JAX package does (the trees
    gathered back are equal, dp, tp and row leaves), and `get_weights`
    gives the tables back (on every rank with all_ranks, on rank 0 by
    default). Every rank's `exchange_padding_report` after the forward is
    the JAX layer's, field for field."""
    ranks, refs = world_run(world)
    ref = refs[f"placement:{name}"]
    for rank, r in enumerate(ranks):
        res = r[f"placement:{name}"]
        assert res["groups"] == ref["groups"]
        assert res["report"] == ref["report"]
        assert (res["placements"], res["buckets"]) == (ref["placements"],
                                                       ref["buckets"])
        for group in ("dp", "tp", "row"):
            got, want = res["tree"][group], ref["tree"][group]
            assert len(got) == len(want), group
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        for got, want in zip(res["weights"], ref["weights"]):
            np.testing.assert_array_equal(got, want)
        assert (res["root"] is None) == (rank > 0)
    # every group is exercised across the configurations
    if name == "all_modes":
        assert all(ref["groups"]) and ref["placements"] > len(
            ref["groups"][1])


def _bf16(a: np.ndarray) -> torch.Tensor:
    """bfloat16 values held as float32 (a rank's) or as ml_dtypes'
    bfloat16 (the JAX package's), as a bfloat16 tensor."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    assert torch.equal(t.to(torch.bfloat16).float(), t)
    return t.to(torch.bfloat16)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_placement_forward_matches_jax(world_run, world):
    """Every placement group at bfloat16: the JAX layer's plan; the ranks'
    slices bfloat16 and, in order, the JAX layer's outputs: bit-equal at
    hotness 1 and through the passthroughs; the multi-hot combiners within
    `AMP_ULP`, the row tables' at W > 2 also within (W - 1)
    `AMP_ADD_EPS` of the sum of their terms' magnitudes (the
    reduce-scatter's roundings)."""
    ranks, refs = world_run(world)
    ref = refs["amp_placement"]
    assert all(ref["groups"])
    for i, want in enumerate(ref["outputs"]):
        _, _, combiner, k, _ = AMP_TABLES[i]
        got = _bf16(np.concatenate([r["amp_placement"]["outputs"][i]
                                    for r in ranks]))
        want = _bf16(np.asarray(want, np.float32))
        assert got.shape == want.shape, i
        if k == 1 or combiner is None:
            assert torch.equal(got, want), i
        elif i in ref["groups"][2] and world > 2:
            bar = (AMP_ADD_EPS * (world - 1)
                   * torch.from_numpy(ref["terms"][i])
                   + (want.float().abs() * 2.0 ** -7))
            assert bool(((got.float() - want.float()).abs() <= bar).all()), i
        else:
            assert _ulps(got, want) <= AMP_ULP, i
    for r in ranks:
        res = r["amp_placement"]
        assert res["groups"] == ref["groups"]
        assert res["dtypes"] == ["torch.bfloat16"] * len(AMP_TABLES)
        assert res["loaded_equal"]


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_wire_moves_bf16(world_run, world):
    """In the bfloat16 train steps every float payload of the wire's
    collectives (forward and backward, activations and their gradients)
    is bfloat16; the ids move as ints, and the row tables' input weights,
    where an input has them, as they come (float32)."""
    ranks, _ = world_run(world)
    for r in ranks:
        payloads = dict(r[f"w{world}-placed-adagrad-bf16"]["payloads"])
        assert payloads.pop("weight_broadcast", {"torch.float32"}) == {
            "torch.float32"}
        assert payloads == {
            "all_to_all_single": {"torch.bfloat16"},
            "all_gather_into_tensor": {"torch.bfloat16"},
            "reduce_scatter_tensor": {"torch.bfloat16"}}


@pytest.mark.parametrize("world", WORLDS)
def test_mp_input_matches_jax(world_run, world):
    """``dp_input=False``: each rank feeds its own features at global
    batch size; the ranks' slices are the JAX package's `apply_mp` outputs
    (test_mp_input_column_slice's configuration). One sparse adagrad step
    from model-parallel input gives the data-parallel step's loss, tables,
    state and MLP, bit for bit (the same plan, the same lookups)."""
    ranks, refs = world_run(world)
    for i, want in enumerate(refs["mp"]["outputs"]):
        got = np.concatenate([r["mp"]["outputs"][i] for r in ranks])
        np.testing.assert_allclose(got, want, err_msg=f"output {i}",
                                   **FWD_TOL)
    for r in ranks:
        dp_loss, dp_params, dp_state = r["mp"]["dp_step"]
        mp_loss, mp_params, mp_state = r["mp"]["mp_step"]
        assert mp_loss == dp_loss
        for a, b in zip(jax.tree.leaves(mp_params),
                        jax.tree.leaves(dp_params)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(mp_state),
                        jax.tree.leaves(dp_state)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_placed_dense_step_matches_jax(world_run, world):
    """One dense adagrad step (`make_train_step`) of the synthetic model
    with dp, column-sliced tp and row tables: the loss at rtol 1e-5, every
    parameter (each rank's shards, gathered) at rtol 1e-4 / atol 1e-6."""
    ranks, refs = world_run(world)
    ref = refs["placed"]["dense"]
    for r in ranks:
        np.testing.assert_allclose(r["dense_step"]["loss"], ref["loss"],
                                   **LOSS_TOL)
        _assert_tree_close(r["dense_step"]["params"], ref["params"])


@pytest.mark.parametrize("world", WORLDS)
def test_engine_matches_jax(world_run, world):
    """`InferenceEngine` at W > 1 on a request of BATCH + 1 rows (padded to
    a multiple of W): every rank returns the whole request's logits, the
    JAX engine's within rtol 1e-5 / atol 1e-6."""
    ranks, refs = world_run(world)
    want = refs["placed"]["logits"]
    for r in ranks:
        got = r["engine"]["logits"]
        assert got.shape == want.shape == (BATCH + 1, 1)
        np.testing.assert_allclose(got, want, **FWD_TOL)
        assert r["engine"]["padded"] == -(-(BATCH + 1) // world) * world \
            - (BATCH + 1)


@pytest.mark.parametrize("world", WORLDS)
def test_convert_round_trip_with_dp_and_row(world_run, world):
    """The JAX package's params and adam state, with dp and row leaves, go
    into the port and come back out equal."""
    ranks, refs = world_run(world)
    ref = refs["placed"]
    assert len(ref["params"]["embedding"]["dp"]) == 3
    assert len(ref["params"]["embedding"]["row"]) == 3
    for r in ranks:
        res = r["convert"]
        for a, b in zip(jax.tree.leaves(res["params"]),
                        jax.tree.leaves(ref["params"])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_equal(res["state"]["emb"], ref["state"]["emb"])
        for key, val in _jax_dense_state(ref["state"]["dense"]).items():
            got = res["state"]["dense"][key]
            if isinstance(val, int):
                assert got == val, key
                continue
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(val)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_wire_backward_is_forward_transpose(world_run, world):
    """Each float wire collective's backward is its forward's transpose
    (over the ranks, sum <op(x), c> == sum <x, op^T(c)>); the forwards give
    the tiled all_gather and reduce-scatter of the ranks' blocks."""
    ranks, _ = world_run(world)
    xs = {k: [r["wire"][k]["x"] for r in ranks]
          for k in ("all_gather", "psum_scatter")}
    for rank, r in enumerate(ranks):
        res = r["wire"]
        for k in ("all_gather", "psum_scatter"):
            dots = res[k]["dots"]
            np.testing.assert_allclose(dots[0], dots[1], rtol=1e-6)
        np.testing.assert_array_equal(res["all_gather"]["y"],
                                      np.concatenate(xs["all_gather"]))
        rows = xs["psum_scatter"][0].shape[0] // world
        np.testing.assert_allclose(
            res["psum_scatter"]["y"],
            np.sum(xs["psum_scatter"], axis=0)[rank * rows:(rank + 1)
                                                * rows], rtol=1e-6)
        np.testing.assert_array_equal(
            res["psum_scatter_t"]["t"],
            np.concatenate([q["wire"]["psum_scatter_t"]["c"]
                            for q in ranks]))
        np.testing.assert_array_equal(
            res["id_all_gather"],
            np.concatenate([np.arange(3) + 10 * q for q in range(world)]))


def _same_bytes(got, want) -> bool:
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    return got.shape == want.shape and got.tobytes() == want.tobytes()


def test_quantized_forward_and_sgd_steps_match_jax(world_run):
    """int8 storage at W = 2: each rank's payload and scale shards are the
    JAX tree's, its forward on its slice is the JAX layer's bit for bit,
    and after each of three sgd steps the gathered payloads and scales are
    the JAX step's bit for bit."""
    ranks, refs = world_run(2)
    ref = refs["quantized"]
    for r in ranks:
        res = r["quantized"]
        for key in ("tp", "tp_scale"):
            for got, want in zip(res["tree"][key], ref["tree"][key]):
                assert got.dtype == want.dtype and _same_bytes(got, want)
    for i, want in enumerate(ref["outputs"]):
        got = np.concatenate([r["quantized"]["outputs"][i] for r in ranks])
        assert _same_bytes(got, want), i
    for s, want in enumerate(ref["trees"]):
        for r in ranks:
            got = r["quantized"]["steps"][s]
            for key in ("tp", "tp_scale"):
                for b, (g, w) in enumerate(zip(got[key], want[key])):
                    assert _same_bytes(g, w), (s, key, b)


def test_quantized_resume_is_bit_equal_on_every_rank(world_run):
    """Resume at W = 2 (int8 adagrad): each rank saves its own file, a
    fresh layer restores it, and 2 more steps end bit-equal to the
    uninterrupted run's on every rank (payloads, scales, accumulators)."""
    ranks, _ = world_run(2)
    for r in ranks:
        res = r["quantized"]["resume"]
        assert res["files"] == ["meta.json", "rank_0.pt", "rank_1.pt"]
        assert res["keys"] == ["opt_state", "params"]
        assert res["equal"] and res["tensors"] > 0, res
