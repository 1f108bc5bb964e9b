"""One rank of `tests/test_torch_multigpu.py`: the port at world size > 1.

The test spawns the ranks with ``torch.multiprocessing`` (``spawn``), so
each rank imports this module afresh; it imports torch and the port only,
never jax nor the JAX package, and each rank checks so before it starts
and before it reports. A rank joins a gloo process group on the CPU,
reads the cases the test wrote (the JAX package's weights and global
batches as numpy arrays), runs each through the port's entry points on its
slice of the batch, and writes its results for the test to compare.
"""

import collections
import os
import pickle
import sys

import torch
import torch.distributed as dist

from distributed_embeddings_tpu_torch import convert, training
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    DistributedEmbedding, broadcast_variables)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding
from distributed_embeddings_tpu_torch.models import dlrm as dlrm_model
from distributed_embeddings_tpu_torch.models import synthetic
from distributed_embeddings_tpu_torch.parallel import mesh
from distributed_embeddings_tpu_torch.parallel.staging import (DeviceStager,
                                                               stage_dp_batch)

# each rank's slices stay on the CPU (a thread a rank: one stager each)
CPU_STAGE = DeviceStager("cpu")


def _no_jax():
    if "jax" in sys.modules:
        raise RuntimeError("a rank of the port imported jax")


def _layer(spec, **kw) -> DistributedEmbedding:
    return DistributedEmbedding(
        [Embedding(r, w, combiner=c, device="meta")
         for r, w, c in spec["tables"]],
        strategy=spec["strategy"], input_table_map=spec["table_map"],
        input_max_hotness=spec["hotness"], device="cpu", **kw)


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
    """The errors the slice gives at world size > 1 (None: no error)."""
    out = {}

    def message(fn, kind):
        try:
            fn()
        except kind as e:
            return str(e)
        return None
    batch = spec["indivisible"]
    out["indivisible"] = message(
        lambda: stage_dp_batch(batch, CPU_STAGE), ValueError)
    out["column_threshold"] = message(
        lambda: _layer(spec, column_slice_threshold=spec["column"]),
        NotImplementedError)
    out["fewer_tables_than_ranks"] = message(
        lambda: DistributedEmbedding([Embedding(16, 8, device="meta")],
                                     device="cpu"), NotImplementedError)
    out["data_parallel"] = message(
        lambda: _layer(spec, data_parallel_threshold=100),
        NotImplementedError)
    out["world_size"] = message(
        lambda: _layer(spec, world_size=mesh.world_size() + 1), ValueError)
    return out


def train(spec) -> dict:
    """Sparse train steps over the global batches. Free-running from the
    JAX package's initial weights, or, with ``spec["before"]``, each step
    from the JAX step's params and state before it."""
    model = synthetic.SyntheticModel(_config(spec), device="cpu")
    init, step = training.make_sparse_train_step(
        model, spec["optimizer"], lr=spec["lr"], strategy=spec["strategy"])
    model.load_state_dict(convert.params_from_jax(spec["params"], model))
    state = init(model)
    steps = []
    for i, batch in enumerate(spec["batches"]):
        if spec.get("before"):
            params, plain = spec["before"][i]
            model.load_state_dict(convert.params_from_jax(params, model))
            state = _opt_state(plain, model)
        num, cats, labels = stage_dp_batch(batch, CPU_STAGE)
        _, state, loss = step(model, state, num, cats, labels)
        steps.append({"loss": float(loss),
                      "params": convert.params_to_numpy(model),
                      "state": convert.opt_state_to_numpy(state, model)})
    return {"steps": steps}


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


KINDS = {"dlrm": dlrm, "dlrm_fit": dlrm_fit, "forward": forward, "weights": weights, "broadcast": broadcast,
         "shims": shims, "raises": raises, "train": train}


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
    raise SystemExit("run by tests/test_torch_multigpu.py")
