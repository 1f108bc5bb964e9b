"""One rank of `tests/test_torch_multigpu.py`, `tests/test_torch_wire.py`
and `tests/test_torch_offload.py`: the port at world size > 1.

The test spawns the ranks with ``torch.multiprocessing`` (``spawn``), so
each rank imports this module afresh; it imports torch and the port only,
never jax nor the JAX package, and each rank checks so before it starts
and before it reports. A rank joins a gloo process group on the CPU,
reads the cases the test wrote (the JAX package's weights and global
batches as numpy arrays), runs each through the port's entry points on its
slice of the batch, and writes its results for the test to compare.
"""

import collections
import contextlib
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from distributed_embeddings_tpu_torch import convert, training
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding, broadcast_variables)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding
from distributed_embeddings_tpu_torch.models import dlrm as dlrm_model
from distributed_embeddings_tpu_torch.models import synthetic
from distributed_embeddings_tpu_torch.ops import wire
from distributed_embeddings_tpu_torch.parallel import mesh
from distributed_embeddings_tpu_torch.parallel.staging import (DeviceStager,
                                                               dp_slice,
                                                               stage_dp_batch)
from distributed_embeddings_tpu_torch.serving.engine import InferenceEngine
from distributed_embeddings_tpu_torch.utils import checkpoint

# each rank's slices stay on the CPU (a thread a rank: one stager each)
CPU_STAGE = DeviceStager("cpu")


class ScaledEmbedding(Embedding):
    """A layer class whose forward is not a plain gather: twice the rows
    (the JAX test's ``_ScaledEmbedding``); placed data-parallel."""

    def forward(self, inputs):
        ids = torch.as_tensor(inputs, device=self.embeddings.device)
        return 2.0 * self.embeddings[ids.long()]


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; a 16-bit float one as float32 (the
    widening is exact; numpy has no bfloat16)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


@contextlib.contextmanager
def _payload_dtypes():
    """Within the block, the dtypes of the floating inputs of every wire
    collective (`ops.wire` calls them through ``torch.distributed``), by
    collective name; the row tables' weight broadcasts
    (`wire.wire_all_gather` of the input weights) apart, under
    ``"weight_broadcast"``."""
    names = ("all_to_all_single", "all_gather_into_tensor",
             "reduce_scatter_tensor")
    real = {n: getattr(dist, n) for n in names}
    real_weights = wire.wire_all_gather
    seen: dict = {}
    in_weights = []

    def recording(name):
        def call(out, inp, *args, **kwargs):
            if inp.is_floating_point():
                key = "weight_broadcast" if in_weights else name
                seen.setdefault(key, set()).add(str(inp.dtype))
            return real[name](out, inp, *args, **kwargs)
        return call

    def weight_broadcast(*args, **kwargs):
        in_weights.append(True)
        try:
            return real_weights(*args, **kwargs)
        finally:
            in_weights.pop()
    for n in names:
        setattr(dist, n, recording(n))
    wire.wire_all_gather = weight_broadcast
    try:
        yield seen
    finally:
        for n in names:
            setattr(dist, n, real[n])
        wire.wire_all_gather = real_weights


def _no_jax():
    if "jax" in sys.modules:
        raise RuntimeError("a rank of the port imported jax")


def _layer(spec, **kw) -> DistributedEmbedding:
    return DistributedEmbedding(
        [Embedding(r, w, combiner=c, device="meta")
         for r, w, c in spec["tables"]],
        strategy=spec["strategy"], input_table_map=spec["table_map"],
        input_max_hotness=spec["hotness"], device="cpu", **kw)


def _placed(spec, **kw) -> DistributedEmbedding:
    """A layer of `spec`'s tables, (rows, width, combiner, scaled), with
    its placement arguments ``spec["kw"]``."""
    return DistributedEmbedding(
        [(ScaledEmbedding if scaled else Embedding)(
            r, w, combiner=c, device="meta")
         for r, w, c, scaled in spec["tables"]],
        input_table_map=spec["table_map"],
        input_max_hotness=spec.get("hotness"), device="cpu",
        **spec["kw"], **kw)


def _mp_inputs(layer, inputs):
    """This rank's model-parallel inputs: its own features, whole."""
    strat = layer.strategy
    return [inputs[strat.input_groups[1][pos]]
            for pos in strat.input_ids_list[layer.rank]]


def _config(spec) -> synthetic.ModelConfig:
    name, embs, mlp, numerical, stride = spec["config"]
    return synthetic.ModelConfig(
        name, [synthetic.EmbeddingConfig(*e) for e in embs], mlp, numerical,
        stride)


def _opt_state(plain: dict, model) -> dict:
    """The port's opt state from the JAX package's, whose optax parts
    arrive as field dicts."""
    parts = tuple(collections.namedtuple("Part", list(fields))(**fields)
                  for fields in plain["dense"])
    return convert.opt_state_from_jax({**plain, "dense": parts}, model)


def forward(spec) -> dict:
    """The forward of this rank's slice, the layer loaded from the JAX
    package's parameter tree (`convert.params_from_jax`)."""
    layer = _layer(spec)
    state = convert.params_from_jax(spec["tree"], layer)
    layer.load_state_dict(state)
    outs = layer(stage_dp_batch(spec["inputs"], CPU_STAGE))
    return {"outputs": [o.detach().numpy() for o in outs],
            "tree": convert.params_to_numpy(layer)}


def weights(spec) -> dict:
    """`set_weights` then `get_weights` on every rank (all_ranks, and the
    default, rank 0 only), with the gather cut into chunks of a few rows."""
    layer = _layer(spec)
    layer.set_weights(spec["weights"])
    layer.GATHER_CHUNK_ELEMS = 64
    return {"all": layer.get_weights(all_ranks=True),
            "root": layer.get_weights(),
            "tree": convert.params_to_numpy(layer)}


def broadcast(spec) -> dict:
    """`broadcast_variables` of tensors; a model built from another seed on
    each rank takes rank 0's MLP (and keeps its own table shards), as it
    does again after a perturbation through the callback."""
    rank = mesh.rank()
    tensor = torch.full((3,), float(rank))
    broadcast_variables([tensor])
    model = synthetic.SyntheticModel(
        _config(spec), device="cpu",
        generator=torch.Generator().manual_seed(100 + rank))
    built = [p.detach().clone().numpy() for p in model.mlp.parameters()]
    with torch.no_grad():
        for p in model.mlp.parameters():
            p.add_(float(rank))
    training.BroadcastGlobalVariablesCallback().on_train_begin(model)
    return {"tensor": tensor.numpy(), "mlp_built": built,
            "mlp_after_callback": [p.detach().numpy()
                                   for p in model.mlp.parameters()],
            "tables": [t.detach().numpy() for t in model.embedding.tp]}


def shims(spec) -> dict:
    """`DistributedGradientTape` over this rank's slice (the dense
    gradients and the loss averaged over the ranks), then one
    `DistributedOptimizer` (sgd) update of the MLP."""
    model = synthetic.SyntheticModel(_config(spec), device="cpu")
    model.load_state_dict(convert.params_from_jax(spec["params"], model))
    num, cats, labels = stage_dp_batch(spec["batch"], CPU_STAGE)
    loss, grads = training.DistributedGradientTape().gradient(
        lambda m, *batch: m.loss_fn(*batch), model, num, cats, labels)
    dense = {n: p for n, p in model.named_parameters() if p.requires_grad}
    opt = training.DistributedOptimizer(training.sgd(spec["lr"]))
    opt.update(grads, opt.init(dense), dense)
    return {"loss": float(loss),
            "grads": {n: g.numpy() for n, g in grads.items()},
            "mlp": {n: p.detach().numpy().copy() for n, p in dense.items()}}


def raises(spec) -> dict:
    """The errors the port gives at world size > 1 (None: no error):
    what it ported builds (column slicing, fewer tables than ranks, the dp
    and row groups, model-parallel input, the engine, the wire formats,
    hot rows, host offload); what it did not raises NotImplementedError
    naming its ROADMAP item."""
    out = {}

    def message(fn, kind=NotImplementedError):
        try:
            fn()
        except kind as e:
            return str(e)
        return None
    batch = spec["indivisible"]
    out["indivisible"] = message(
        lambda: stage_dp_batch(batch, CPU_STAGE), ValueError)
    for key, kw in (("column_threshold",
                     dict(column_slice_threshold=spec["column"])),
                    ("data_parallel", dict(data_parallel_threshold=100)),
                    ("row_slice", dict(row_slice_threshold=100)),
                    ("dp_input", dict(dp_input=False))):
        out[key] = message(lambda: _layer(spec, **kw), Exception)
    out["fewer_tables_than_ranks"] = message(
        lambda: DistributedEmbedding([Embedding(16, 8, device="meta")],
                                     device="cpu"), Exception)
    out["engine"] = message(
        lambda: InferenceEngine(_layer(spec), device="cpu"), Exception)
    for key, kw in (("hot_rows", dict(hot_rows=8)),
                    ("exchange_wire", dict(exchange_wire="bf16")),
                    ("storage_dtype", dict(storage_dtype="int8")),
                    ("gpu_embedding_size", dict(gpu_embedding_size=100)),
                    ("vocab_slack", dict(vocab_slack=4))):
        out[key] = message(lambda: _layer(spec, **kw))
    out["ragged_exchange"] = message(wire.ragged_exchange)
    out["bf16_all_gather"] = message(
        lambda: wire.wire_all_gather(torch.zeros(2, 2), "bf16"))
    out["engine_cache"] = message(
        lambda: InferenceEngine(_layer(spec), device="cpu",
                                cache_capacity=16))
    out["world_size"] = message(
        lambda: _layer(spec, world_size=mesh.world_size() + 1), ValueError)
    return out


def placement(spec) -> dict:
    """A layer of every placement group (dp, column-sliced tp, row): its
    plan, the forward of this rank's slice with the weights written by
    `set_weights`, the same from the JAX package's tree
    (`convert.params_from_jax`), the tree back (`params_to_numpy`) and the
    weights back (`get_weights`, gathered a few rows at a time)."""
    layer = _placed(spec)
    layer.set_weights(spec["weights"])
    batch = stage_dp_batch(spec["inputs"], CPU_STAGE)
    with torch.no_grad():
        out_t = layer(batch)
    outs = [_host(o) for o in out_t]
    loaded = _placed(spec)
    loaded.load_state_dict(convert.params_from_jax(spec["tree"], loaded))
    with torch.no_grad():
        again = [_host(o) for o in loaded(batch)]
    layer.GATHER_CHUNK_ELEMS = 64
    return {"groups": layer.strategy.table_groups,
            "placements": len(layer.plan.tp_placements),
            "buckets": len(layer.plan.tp_buckets),
            "outputs": outs, "dtypes": [str(o.dtype) for o in out_t],
            "loaded_equal": all(np.array_equal(a, b)
                                for a, b in zip(outs, again)),
            "tree": convert.params_to_numpy(layer),
            "weights": layer.get_weights(all_ranks=True),
            "root": layer.get_weights()}


def mp_forward(spec) -> dict:
    """A layer built with ``dp_input=False``: this rank feeds its own
    features at global batch size (`_mp_inputs`); the outputs of its
    slice. Then one sparse adagrad step of the small synthetic model from
    model-parallel input against the same step from data-parallel input
    (same plan: no threshold), both from the JAX package's weights."""
    layer = _placed(spec, dp_input=False)
    layer.set_weights(spec["weights"])
    with torch.no_grad():
        outs = [o.numpy() for o in layer(_mp_inputs(layer,
                                                     spec["inputs"]))]
    trees = []
    for dp_input in (True, False):
        model = synthetic.SyntheticModel(_config(spec), device="cpu",
                                         dp_input=dp_input)
        model.load_state_dict(convert.params_from_jax(spec["params"],
                                                      model))
        init, step = training.make_sparse_train_step(
            model, "adagrad", lr=spec["lr"], strategy="sort")
        num, cats, labels = spec["batch"]
        num, labels = dp_slice((num, labels))
        cats = (dp_slice(cats) if dp_input
                else _mp_inputs(model.embedding, cats))
        _, state, loss = step(model, init(model), num, cats, labels)
        trees.append((float(loss), convert.params_to_numpy(model),
                      convert.opt_state_to_numpy(state, model)))
    return {"outputs": outs, "dp_step": trees[0], "mp_step": trees[1]}


def dense_step(spec) -> dict:
    """One dense adagrad step (`training.make_train_step`) of the small
    synthetic model with every placement group, from the JAX package's
    weights, over this rank's slice of the global batch."""
    model = synthetic.SyntheticModel(_config(spec), device="cpu",
                                     **spec["kw"])
    model.load_state_dict(convert.params_from_jax(spec["params"], model))
    opt = training.adagrad(spec["lr"])
    step = training.make_train_step(lambda m, *b: m.loss_fn(*b), opt)
    state = opt.init(dict(model.named_parameters()))
    num, cats, labels = stage_dp_batch(spec["batch"], CPU_STAGE)
    _, state, loss = step(model, state, num, cats, labels)
    return {"loss": float(loss), "params": convert.params_to_numpy(model)}


def engine(spec) -> dict:
    """`InferenceEngine` over the small synthetic model with every
    placement group: every rank passes the same request, whose size the
    world does not divide, and gets the whole request's logits."""
    model = synthetic.SyntheticModel(_config(spec), device="cpu",
                                     **spec["kw"])
    model.load_state_dict(convert.params_from_jax(spec["params"], model))
    eng = InferenceEngine(model, device="cpu")
    num, cats = spec["request"]
    return {"logits": eng.predict((num, cats)).numpy(),
            "padded": eng.rows_padded}


def convert_round_trip(spec) -> dict:
    """The JAX package's params and sparse optimizer state (dp, tp and row
    leaves) into the port and back out."""
    model = synthetic.SyntheticModel(_config(spec), device="cpu",
                                     **spec["kw"])
    model.load_state_dict(convert.params_from_jax(spec["params"], model))
    state = _opt_state(spec["state"], model)
    return {"params": convert.params_to_numpy(model),
            "state": convert.opt_state_to_numpy(state, model)}


def wire_ops(spec) -> dict:
    """Each float wire collective's backward against its forward's
    transpose: with x and a cotangent c drawn per rank, the sums over the
    ranks of <op(x), c> and <x, op^T(c)> (op^T(c) the gradient autograd
    gives x). Also the forwards' values, and the id all_gather."""
    rank, world = mesh.rank(), mesh.world_size()
    gen = torch.Generator().manual_seed(spec["seed"] + rank)
    out = {}
    for name, op, rows in (("all_gather", wire.wire_all_gather, 3),
                           ("psum_scatter", wire.wire_psum_scatter,
                            3 * world)):
        x = torch.randn(rows, 4, generator=gen, dtype=torch.float64
                        ).float().requires_grad_()
        y = op(x)
        c = torch.randn(y.shape, generator=gen)
        (g,) = torch.autograd.grad(y, x, grad_outputs=c)
        dots = torch.stack([(y.detach().double() * c.double()).sum(),
                            (x.detach().double() * g.double()).sum()])
        dist.all_reduce(dots)
        out[name] = {"x": x.detach().numpy(), "y": y.detach().numpy(),
                     "dots": dots.numpy()}
    c = torch.randn(2, 4, generator=gen)
    out["psum_scatter_t"] = {
        "c": c.numpy(), "t": wire.wire_psum_scatter_t(c).numpy()}
    ids = torch.arange(3, dtype=torch.int32) + 10 * rank
    out["id_all_gather"] = wire.wire_id_all_gather(ids).numpy()
    return out


def train(spec) -> dict:
    """Sparse train steps over the global batches. Free-running from the
    JAX package's initial weights, or, with ``spec["before"]``, each step
    from the JAX step's params and state before it. ``spec["kw"]``: the
    placement arguments (the dp and row groups)."""
    model = synthetic.SyntheticModel(_config(spec), device="cpu",
                                     **spec.get("kw", {}))
    init, step = training.make_sparse_train_step(
        model, spec["optimizer"], lr=spec["lr"], strategy=spec["strategy"])
    model.load_state_dict(convert.params_from_jax(spec["params"], model))
    state = init(model)
    steps = []
    payloads: dict = {}
    for i, batch in enumerate(spec["batches"]):
        if spec.get("before"):
            params, plain = spec["before"][i]
            model.load_state_dict(convert.params_from_jax(params, model))
            state = _opt_state(plain, model)
        num, cats, labels = stage_dp_batch(batch, CPU_STAGE)
        with _payload_dtypes() as seen:
            _, state, loss = step(model, state, num, cats, labels)
        for name, dtypes in seen.items():
            payloads.setdefault(name, set()).update(dtypes)
        steps.append({"loss": float(loss),
                      "params": convert.params_to_numpy(model),
                      "state": convert.opt_state_to_numpy(state, model)})
    return {"steps": steps, "payloads": payloads}


class _Linear(torch.nn.Module):
    """The quantized case's model: the mean over this rank's slice of the
    outputs times its slice of the coefficients."""

    def __init__(self, layer, coefs):
        super().__init__()
        self.embedding = layer
        self.coefs = list(dp_slice([torch.from_numpy(c) for c in coefs]))

    def loss_fn(self, numerical, cats, labels, taps=None,
                return_residuals=False):
        out = self.embedding(list(cats), taps=taps,
                             return_residuals=return_residuals)
        outs, res = out if return_residuals else (out, None)
        loss = sum((o * c).sum() for o, c in zip(outs, self.coefs)) \
            / self.coefs[0].shape[0]
        return (loss, res) if return_residuals else loss


def _quantized_model(spec, seed=0) -> _Linear:
    layer = DistributedEmbedding(
        [Embedding(r, w, combiner=c, device="meta")
         for r, w, c in spec["tables"]], device="cpu",
        storage_dtype="int8", generator=torch.Generator().manual_seed(seed))
    return _Linear(layer, spec["coefs"])


def _steps(model, step, state, batches):
    dummy = torch.zeros((model.coefs[0].shape[0], 1))
    for cats in batches:
        model, state, _ = step(model, state, dummy,
                               stage_dp_batch(cats, CPU_STAGE), dummy)
    return state


def _flat(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    items = (tree.values() if isinstance(tree, dict)
             else tree if isinstance(tree, (list, tuple)) else [])
    return [t for x in items for t in _flat(x)]


def quantized(spec) -> dict:
    """int8 storage: the layer loaded from the JAX package's tree (payload
    and scale shards), the forward of this rank's slice, the gathered tree
    after each of three sgd steps of `_Linear`; then resume (int8 adagrad):
    2 steps, a checkpoint of this rank, 2 more; a fresh layer restored from
    it and trained the same 2 steps, compared tensor for tensor."""
    model = _quantized_model(spec)
    layer = model.embedding
    layer.load_state_dict(convert.params_from_jax(spec["tree"], layer))
    tree = convert.params_to_numpy(layer)
    outs = layer(stage_dp_batch(spec["batches"][0], CPU_STAGE))
    init, step = training.make_sparse_train_step(model, "sgd", lr=spec["lr"])
    state, steps = init(model), []
    for cats in spec["batches"][:3]:
        state = _steps(model, step, state, [cats])
        steps.append(convert.params_to_numpy(layer))

    batches = spec["batches"]
    first = _quantized_model(spec)
    init, step = training.make_sparse_train_step(first, "adagrad",
                                                 lr=spec["lr"])
    state = _steps(first, step, init(first), batches[:2])
    checkpoint.save_checkpoint(spec["dir"], {"params": first.state_dict(),
                                             "opt_state": state}, step=2)
    state = _steps(first, step, state, batches[2:4])
    dist.barrier()
    fresh = _quantized_model(spec, seed=1)
    init2, step2 = training.make_sparse_train_step(fresh, "adagrad",
                                                   lr=spec["lr"])
    restored = checkpoint.restore_checkpoint(
        spec["dir"], {"params": fresh.state_dict(),
                      "opt_state": init2(fresh)}, step=2)
    state2 = _steps(fresh, step2, restored["opt_state"], batches[2:4])
    a = _flat(fresh.state_dict()) + _flat(state2)
    b = _flat(first.state_dict()) + _flat(state)
    return {"outputs": [o.detach().numpy() for o in outs], "tree": tree,
            "steps": steps, "resume": {
                "files": sorted(os.listdir(os.path.join(spec["dir"],
                                                        "step_2"))),
                "keys": checkpoint.checkpoint_keys(spec["dir"], step=2),
                "tensors": len(a),
                "equal": len(a) == len(b) and all(
                    torch.equal(x, y) for x, y in zip(a, b))}}


def wire_parity(spec) -> dict:
    """Each wired collective at each compressed float wire on this rank's
    blocks (`spec[name]["x"][rank]`, cotangent ``["c"][rank]``): the
    forward and the gradient autograd gives; the explicit transposes; the
    int16 id collectives."""
    rank = mesh.rank()
    ops = {"all_to_all": wire.wire_all_to_all,
           "all_gather": wire.wire_all_gather,
           "psum_scatter": wire.wire_psum_scatter}
    out = {}
    for name_w in spec["wires"]:
        for name, op in ops.items():
            x = torch.from_numpy(spec[name]["x"][rank]).requires_grad_()
            y = op(x, name_w)
            (g,) = torch.autograd.grad(
                y, x, grad_outputs=torch.from_numpy(spec[name]["c"][rank]))
            out[(name_w, name)] = (y.detach().numpy(), g.numpy())
        for name, op in (("all_to_all_t", wire.wire_all_to_all_t),
                         ("psum_scatter_t", wire.wire_psum_scatter_t)):
            out[(name_w, name)] = op(torch.from_numpy(spec[name][rank]),
                                     name_w).numpy()
    out["id_all_to_all"] = wire.wire_id_all_to_all(
        torch.from_numpy(spec["ids_a2a"][rank]), "int16").numpy()
    out["id_all_gather"] = wire.wire_id_all_gather(
        torch.from_numpy(spec["ids_ag"][rank]), "int16").numpy()
    return out


@contextlib.contextmanager
def _payload_bytes():
    """Within the block, (collective, dtype, bytes) of every input the
    wire's collectives send."""
    names = ("all_to_all_single", "all_gather_into_tensor",
             "reduce_scatter_tensor")
    real = {n: getattr(dist, n) for n in names}
    seen = []

    def recording(name):
        def call(out, inp, *args, **kwargs):
            seen.append((name, str(inp.dtype),
                         inp.numel() * inp.element_size()))
            return real[name](out, inp, *args, **kwargs)
        return call
    for n in names:
        setattr(dist, n, recording(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(dist, n, real[n])


def hot_wire(spec) -> dict:
    """Hot rows over a compressed wire: steps of `_Linear` (its
    coefficients `spec["coefs"]`) on this rank's slices, the keys
    `spec["keys"]` admitted before step ``admit_at``
    (after each rank observed its slice); after the steps, an admission
    of the trackers' own top keys (``admit=True``: rank 0's, on every
    rank). The layer's wires, the bytes each collective sent in a step."""
    layer = DistributedEmbedding(
        [Embedding(v, w, combiner=c, device="meta")
         for v, w, c in spec["tables"]], device="cpu", **spec["kw"])
    layer.set_weights(spec["weights"])
    model = _Linear(layer, spec["coefs"])
    init, step = training.make_sparse_train_step(model, spec["optimizer"],
                                                 lr=spec["lr"])
    state = init(model)
    losses, payloads, scales = [], [], []
    dummy = torch.zeros((model.coefs[0].shape[0], 1))
    for i, cats in enumerate(spec["batches"]):
        cats = stage_dp_batch(cats, CPU_STAGE)
        layer.observe_hot_ids(cats)
        if i == spec["admit_at"]:
            state["emb"] = layer.sync_hot_rows(state["emb"],
                                               new_keys=spec["keys"])
        with torch.no_grad():
            scale = torch.stack([(o * c).abs().sum() for o, c in zip(
                layer(cats), model.coefs)]).sum() / dummy.shape[0]
        scales.append(float(mesh.average_across_ranks([scale])[0]))
        with _payload_bytes() as seen:
            _, state, loss = step(model, state, dummy, cats, dummy)
        payloads.append(seen)
        losses.append(float(loss))
    out = {"losses": losses, "loss_scales": scales, "payloads": payloads,
           "weights": layer.get_weights(all_ranks=True),
           "hot": {b: [t.numpy().copy() for t in layer._hot_entry(b)]
                   for b in layer._hot_buckets},
           "hot_state": [[t.numpy().copy() for t in entry
                          if torch.is_tensor(t)]
                         for entry in state["emb"]["hot"]],
           "wires": [(b.wire_dtype, b.id_wire_dtype)
                     for b in layer.plan.tp_buckets],
           "id_blocks": [
               (layer.plan.tp_buckets[grp.bucket].id_wire_dtype,
                spec["coefs"][0].shape[0] * grp.f_max * grp.k)
               for grp in layer._exchange_groups_for_key(
                   tuple((np.asarray(c).shape[1], False)
                         for c in spec["batches"][0]))[0]],
           "top_keys": {b: tr.top_keys()
                        for b, tr in layer._hot_trackers.items()}}
    layer.sync_hot_rows(state["emb"], admit=True)
    out["admitted"] = {b: layer._hot_entry(b)[0].numpy().copy()
                       for b in layer._hot_buckets}
    return out


def dlrm(spec) -> dict:
    """A DLRM built on every rank (its constructor broadcasts rank 0's
    MLPs) and loaded from the JAX package's tree: the logits of this
    rank's slice, then one ``sort`` adagrad step."""
    model = dlrm_model.DLRM(spec["sizes"], device="cpu", **spec["kw"])
    model.load_state_dict(convert.params_from_jax(spec["params"], model))
    num, cats, labels = stage_dp_batch(spec["batch"], CPU_STAGE)
    with torch.no_grad():
        logits = model(num, cats).numpy()
    init, step = training.make_sparse_train_step(
        model, "adagrad", lr=spec["lr"], strategy="sort")
    _, state, loss = step(model, init(model), num, cats, labels)
    return {"logits": logits, "loss": float(loss),
            "params": convert.params_to_numpy(model),
            "state": convert.opt_state_to_numpy(state, model)}


def dlrm_fit(spec) -> dict:
    """The DLRM loaded from the JAX package's tree: `evaluate` over global
    batches (each rank takes its slice and the histograms are summed),
    three dense adagrad steps through `fit(sparse=False)` (global batches;
    the default stage cuts this rank's slice), `evaluate` again."""
    model = dlrm_model.DLRM(spec["sizes"], device="cpu", **spec["kw"])
    model.load_state_dict(convert.params_from_jax(spec["params"], model))
    evals = spec["evals"]
    auc0 = training.evaluate(model, lambda s: evals[s], steps=len(evals))
    _, _, hist = training.fit(model, spec["batches"], len(spec["batches"]),
                              "adagrad", lr=spec["lr"], sparse=False,
                              log_every=0)
    auc1 = training.evaluate(model, iter(evals), steps=len(evals))
    return {"auc": [auc0, auc1], "loss": hist["loss"],
            "params": convert.params_to_numpy(model)}


class _OffloadModel(torch.nn.Module):
    """The JAX offload test's `TinyModel`: the outputs concatenated, a
    linear head, the mean squared error."""

    def __init__(self, spec):
        super().__init__()
        self.embedding = DistributedEmbedding(
            [Embedding(v, w, combiner=c, device="meta")
             for v, w, c in spec["tables"]],
            device="cpu", gpu_embedding_size=spec["budget"])
        self.w = torch.nn.Parameter(torch.from_numpy(spec["head"]))

    def loss_fn(self, numerical, cats, labels, taps=None,
                return_residuals=False):
        out = self.embedding(list(cats), taps=taps,
                             return_residuals=return_residuals)
        outs, res = out if return_residuals else (out, None)
        x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], 1).float()
        loss = torch.mean(((x @ self.w)[:, 0] - labels.reshape(-1)) ** 2)
        return (loss, res) if return_residuals else loss


def offload(spec) -> dict:
    """Host offload at W > 1 (`gpu_embedding_size`): each rank's buckets
    past the budget in its host memory; the forward of this rank's slice,
    three sparse adagrad steps on global batches (each rank its slice),
    the weights back."""
    model = _OffloadModel(spec)
    layer = model.embedding
    layer.set_weights(spec["weights"])
    with torch.no_grad():
        outs = layer(stage_dp_batch(spec["inputs"], CPU_STAGE))
    init, step = training.make_sparse_train_step(
        model, "adagrad", lr=spec["lr"], strategy="sort")
    state = init(model)
    losses = []
    for batch in spec["batches"]:
        num, cats, labels = stage_dp_batch(batch, CPU_STAGE)
        _, state, loss = step(model, state, num, cats, labels)
        losses.append(float(loss))
    return {"outputs": [o.numpy() for o in outs],
            "offloaded": layer.offloaded_buckets,
            "on_host": [layer.tp[b].device.type == "cpu"
                        and state["emb"]["tp"][b][0].device.type == "cpu"
                        for b in layer.offloaded_buckets],
            "losses": losses, "weights": layer.get_weights(all_ranks=True)}


KINDS = {"dlrm": dlrm, "dlrm_fit": dlrm_fit, "forward": forward,
         "weights": weights, "broadcast": broadcast, "shims": shims,
         "raises": raises, "train": train, "placement": placement,
         "mp_forward": mp_forward, "dense_step": dense_step,
         "engine": engine, "convert": convert_round_trip, "wire": wire_ops,
         "quantized": quantized, "wire_parity": wire_parity,
         "hot_wire": hot_wire, "offload": offload}


def main(rank: int, world: int, init_method: str, spec_path: str,
         out_dir: str) -> None:
    """Run every case of `spec_path` on this rank; write its results to
    ``out_dir/rank<r>.pkl``."""
    torch.set_num_threads(1)
    _no_jax()
    mesh.initialize_distributed("gloo", init_method, world, rank)
    try:
        with open(spec_path, "rb") as f:
            cases = pickle.load(f)
        results = {name: KINDS[kind](spec)
                   for name, (kind, spec) in cases.items()}
        _no_jax()
        results["jax_loaded"] = "jax" in sys.modules
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit("run by tests/test_torch_multigpu.py and "
                     "tests/test_torch_wire.py")
