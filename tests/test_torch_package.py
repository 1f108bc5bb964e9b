"""Package rules of the PyTorch port.

It imports neither jax nor the JAX package (at run time or in its source,
nor does chip_smoke.py); its entry points default to the card and refuse
to run without one; its CUDA wrapper launches the kernel or raises, never
falling back to the plain version; features outside the slice raise
NotImplementedError. The sparse kernels' wrappers, the feature ladder's
and the train step follow the same rules.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_embeddings_tpu_torch import DistributedEmbedding, InferenceEngine  # noqa: E402
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.models.dlrm import DLRM  # noqa: E402
from distributed_embeddings_tpu_torch.models.synthetic import (  # noqa: E402
    SYNTHETIC_MODELS, SyntheticModel)
from distributed_embeddings_tpu_torch.ops import cuda_lookup, cuda_sparse  # noqa: E402
from distributed_embeddings_tpu_torch.ops import sparse_update, wire  # noqa: E402
from distributed_embeddings_tpu_torch.tools import cuda_feature_probe  # noqa: E402
from distributed_embeddings_tpu_torch.utils.metrics import StreamingAUC  # noqa: E402
from distributed_embeddings_tpu_torch.training import (  # noqa: E402
    fit, make_sparse_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "distributed_embeddings_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "distributed_embeddings_tpu")


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append((os.path.relpath(path, REPO), mod))
    assert bad == []


def test_import_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import distributed_embeddings_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _tiny_tables():
    return [Embedding(10, 8, combiner="sum", device="meta"),
            Embedding(20, 8, combiner="sum", device="meta")]


@pytest.mark.parametrize("entry", ["embedding", "distributed", "synthetic",
                                   "dlrm", "engine", "train_step",
                                   "auc_init"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    build = {
        "embedding": lambda: Embedding(10, 8),
        "distributed": lambda: DistributedEmbedding(_tiny_tables()),
        "synthetic": lambda: SyntheticModel(SYNTHETIC_MODELS["tiny"]),
        "dlrm": lambda: DLRM([10, 20], embedding_dim=8),
        "engine": lambda: InferenceEngine(
            DistributedEmbedding(_tiny_tables(), device="cpu")),
        "train_step": lambda: make_sparse_train_step(
            DLRM([10, 20], embedding_dim=8)),
        "auc_init": lambda: StreamingAUC().init(),
    }[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()


def test_cuda_tensor_launches_the_kernel_or_raises(monkeypatch):
    """A CUDA tensor never reaches the plain version: here, with no nvcc,
    building the kernel raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*args):
        raise AssertionError("plain version reached with a CUDA tensor")

    monkeypatch.setattr(cuda_lookup, "lookup_combine_plain", plain)
    monkeypatch.setattr(cuda_lookup.kernel_build, "_LIBS", {})
    monkeypatch.setattr(cuda_lookup.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with FakeTensorMode():
        table = torch.empty((100, 8), device="cuda")
        ids = torch.zeros((4, 3), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_lookup.lookup_combine(table, ids)
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_lookup.fused_embedding_lookup(table, ids, combiner="mean")


@pytest.mark.parametrize("kernel", ["segment_sum_sorted", "sgd_rows",
                                    "adagrad_rows", "adam_rows"])
def test_sparse_wrappers_launch_the_kernel_or_raise(kernel, monkeypatch):
    """A CUDA tensor never reaches a sparse kernel's plain version: here,
    with no nvcc, building the kernel raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain(*args):
        raise AssertionError("plain version reached with a CUDA tensor")

    monkeypatch.setattr(cuda_sparse, f"{kernel}_plain", plain)
    monkeypatch.setattr(cuda_sparse.kernel_build, "_LIBS", {})
    monkeypatch.setattr(cuda_sparse.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    before = dict(cuda_sparse.launches)
    with FakeTensorMode():
        table = torch.zeros((100, 8), device="cuda")
        rep = torch.zeros((6,), dtype=torch.int32, device="cuda")
        sums = torch.zeros((6, 8), device="cuda")
        call = {
            "segment_sum_sorted": lambda: cuda_sparse.segment_sum_sorted(
                sums, rep.long(), torch.zeros(7, dtype=torch.int64,
                                              device="cuda")),
            "sgd_rows": lambda: cuda_sparse.sgd_rows(table, rep, sums, 0.1),
            "adagrad_rows": lambda: cuda_sparse.adagrad_rows(
                table, torch.zeros_like(table), rep, sums, 0.1, 1e-7),
            "adam_rows": lambda: cuda_sparse.adam_rows(
                table, torch.zeros_like(table), torch.zeros_like(table),
                rep, sums, 0.1, 0.9, 0.999, 1e-8, 0.1, 0.001),
        }[kernel]
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert cuda_sparse.launches == before


@pytest.mark.parametrize("rung", list(cuda_feature_probe.KERNEL_RUNGS))
def test_probe_wrappers_launch_the_kernel_or_raise(rung, monkeypatch):
    """A CUDA tensor never reaches a feature-ladder rung's plain version:
    here, with no nvcc, building the rung's kernel raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, wrapper, plain, _ = cuda_feature_probe.KERNEL_RUNGS[rung]

    def reached(*args):
        raise AssertionError("plain version reached with a CUDA tensor")

    monkeypatch.setattr(cuda_feature_probe, plain.__name__, reached)
    monkeypatch.setattr(cuda_feature_probe.kernel_build, "_LIBS", {})
    monkeypatch.setattr(cuda_feature_probe.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    before = dict(cuda_feature_probe.launches)
    arrays = cuda_feature_probe.rung_inputs(rung)
    with FakeTensorMode():
        args = [torch.empty(a.shape, dtype=getattr(torch, str(a.dtype)),
                            device="cuda") for a in arrays]
        with pytest.raises(RuntimeError, match="nvcc"):
            wrapper(*args)
    assert cuda_feature_probe.launches == before


@pytest.mark.parametrize("bad", [
    dict(table=torch.zeros(5, 4, dtype=torch.float64)),
    dict(rep=torch.zeros(3)),
    dict(sums=torch.zeros(3, 5)),
    dict(rep=torch.zeros(3, 1, dtype=torch.int32)),
    dict(state=torch.zeros(5, 3)),
])
def test_sparse_wrappers_refuse_what_the_kernel_does_not_take(bad):
    args = dict(table=torch.zeros(5, 4), rep=torch.zeros(3, dtype=torch.int32),
                sums=torch.zeros(3, 4), state=torch.zeros(5, 4))
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        cuda_sparse.adagrad_rows(args["table"], args["state"], args["rep"],
                                 args["sums"], 0.1, 1e-7)


@pytest.mark.parametrize("kwargs", [
    pytest.param(dict(gpu_embedding_size=100, dist_strategy="basic"),
                 id="kwargs1")])
def test_train_step_outside_the_slice_raises(kwargs):
    """Host offload, the last case here that raised before it was ported
    (ROADMAP Queue A8): a DLRM built with it builds its train step and
    takes a step, and the table past the budget, in host memory, moves."""
    model = DLRM([10, 20], embedding_dim=8, bottom_mlp_dims=(8,),
                 top_mlp_dims=(8, 1), num_numerical_features=3,
                 device="cpu", **kwargs)
    emb = model.embedding
    assert emb.offloaded_buckets
    before = [emb.tp[b].detach().clone() for b in emb.offloaded_buckets]
    init, step = make_sparse_train_step(model)
    rng = np.random.RandomState(0)
    batch = (rng.rand(4, 3).astype(np.float32),
             [rng.randint(0, 10, 4), rng.randint(0, 20, 4)],
             rng.randint(0, 2, 4).astype(np.float32))
    _, _, loss = step(model, init(model), *batch)
    assert np.isfinite(float(loss))
    assert all(emb.tp[b].device.type == "cpu"
               and not torch.equal(emb.tp[b], t)
               for b, t in zip(emb.offloaded_buckets, before))


@pytest.mark.parametrize("kwargs,ported", [
    pytest.param(dict(publish_every=4), True, id="kwargs0"),
    pytest.param(dict(lookahead=1), True, id="kwargs1"),
    pytest.param(dict(store=object()), True, id="kwargs2"),
    pytest.param(dict(vocab=object()), True, id="kwargs3"),
    pytest.param(dict(vocab_every=4), True, id="kwargs4"),
    pytest.param(dict(stale_ok=True), True, id="kwargs5"),
    pytest.param(dict(publish_dir="somewhere"), True, id="kwargs6"),
    pytest.param(dict(registry=object()), True, id="kwargs7"),
])
def test_fit_outside_the_slice_raises(kwargs, ported):
    """What `fit` has not ported raises naming its ROADMAP item. The
    weight-streaming and vocabulary arguments (A12) are ported: alone they
    are accepted, as in the JAX package (a store without a cadence, a
    cadence without a store, a directory or a maintenance cadence without
    the rest publish nothing), and they raise the JAX `ValueError`s: a
    cadence with a store but no directory, a manager over another layer,
    a manager with the dense step. So is the registry (A15a): a run's
    metrics land in the one passed, and its snapshot in the history."""
    from distributed_embeddings_tpu_torch.store import TableStore
    from distributed_embeddings_tpu_torch.vocab import VocabManager
    model = DLRM([10, 20], embedding_dim=8, device="cpu")
    if not ported:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
            fit(model, [], 0, **kwargs)
        return
    if "vocab" in kwargs:
        other = DistributedEmbedding(_tiny_tables(), device="cpu",
                                     vocab_slack=4)
        with pytest.raises(ValueError, match="different layer"):
            fit(model, [], 0, vocab=VocabManager(other, use_native=False))
        with pytest.raises(ValueError, match="sparse"):
            fit(model, [], 0, sparse=False,
                vocab=VocabManager(model.embedding, use_native=False))
        return
    if "store" in kwargs:
        kwargs = dict(store=TableStore(model.embedding))
    if "registry" in kwargs:
        from distributed_embeddings_tpu_torch.obs import MetricRegistry
        kwargs = dict(registry=MetricRegistry())
    history = fit(model, [], 0, **kwargs)[2]
    if "registry" in kwargs:
        assert history["metrics_snapshot"] == kwargs["registry"].snapshot()
        assert "metrics_error" not in history
    assert "published" not in history and "vocab_stats" not in history
    assert ("lookahead_stats" in history) == ("lookahead" in kwargs)
    if "publish_every" in kwargs:
        with pytest.raises(ValueError, match="publish_dir"):
            fit(model, [], 0, store=TableStore(model.embedding), **kwargs)


@pytest.mark.parametrize("name,default,other,item", [
    ("lookahead", None, 1, "A14"), ("vocab_every", 16, 4, "A12"),
])
def test_fit_takes_the_reference_arguments_at_their_defaults(name, default,
                                                             other, item):
    """The JAX `fit`'s arguments: the default is accepted, and so is
    another value once the argument is ported (vocab_every, A12;
    lookahead, A14: its engine's stats join the history)."""
    model = DLRM([10, 20], embedding_dim=8, device="cpu")
    fit(model, [], 0, **{name: default})
    history = fit(model, [], 0, **{name: other})[2]
    assert history["loss"] == [] and "vocab_stats" not in history
    assert ("lookahead_stats" in history) == (item == "A14")


def test_fit_sync_every_reads_the_loss_every_n_steps():
    """`sync_every` (ported with the multi-GPU slice) blocks on the loss
    every N steps; the history is the same with and without it."""
    def run(sync_every):
        model = DLRM([10, 20], embedding_dim=8, bottom_mlp_dims=(16, 8),
                     top_mlp_dims=(16, 1), device="cpu")
        rng = torch.Generator().manual_seed(3)
        batches = [(torch.rand(8, 13, generator=rng),
                    [torch.randint(0, v, (8,), generator=rng)
                     for v in (10, 20)],
                    torch.randint(0, 2, (8, 1), generator=rng).float())
                   for _ in range(3)]
        return fit(model, batches, 3, "sgd", log_every=0,
                   sync_every=sync_every)[2]["loss"]
    assert run(2) == run(0) and len(run(1)) == 3


@pytest.mark.parametrize("bad", [
    dict(table=torch.zeros(5, 4, dtype=torch.float64)),
    dict(ids=torch.zeros(3, 2)),
    dict(weights=torch.ones(3, 3)),
    dict(ids=torch.zeros(3, 2, 2, dtype=torch.int64)),
    dict(table=torch.zeros(0, 4)),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args = dict(table=torch.zeros(5, 4), ids=torch.zeros(3, 2,
                                                         dtype=torch.int64),
                weights=None)
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        cuda_lookup.lookup_combine(args["table"], args["ids"],
                                   args["weights"])


@pytest.mark.parametrize("kwargs,ported", [
    pytest.param(dict(mesh=object(), world_size=2), False, id="kwargs0"),
    pytest.param(dict(mesh=object()), False, id="kwargs1"),
    pytest.param(dict(gpu_embedding_size=100), True, id="kwargs2"),
    pytest.param(dict(vocab_slack=4), True, id="kwargs3"),
])
def test_features_outside_the_slice_raise(kwargs, ported):
    """What the port has not ported raises naming its ROADMAP item; host
    offload (A8) and the vocabulary slack (A12), ported since, build: the
    table past the budget is offloaded, in host memory; every table holds
    its slack rows past its configured ones; and the forward runs."""
    if not ported:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
            DistributedEmbedding(_tiny_tables(), device="cpu", **kwargs)
        return
    layer = DistributedEmbedding(_tiny_tables(), device="cpu", **kwargs)
    if "vocab_slack" in kwargs:
        assert [w.shape for w in layer.get_weights()] == [(14, 8), (24, 8)]
        assert [c["vocab_base_rows"] for c in
                layer.strategy.global_configs] == [10, 20]
    else:
        assert layer.offloaded_buckets == [
            b for b, bk in enumerate(layer.plan.tp_buckets)
            if bk.offload] != []
    outs = layer([np.arange(4) % 10, np.arange(4) % 20])
    assert [tuple(o.shape) for o in outs] == [(4, 8), (4, 8)]


@pytest.mark.parametrize("kwargs,wire,hot", [
    (dict(exchange_wire="bf16-sr"), "bf16-sr", 0),
    (dict(hot_rows=8), "f32", 8),
    (dict(exchange_wire="bf16"), "bf16", 0),
])
def test_wire_and_hot_rows_build(kwargs, wire, hot):
    """The wire formats and hot rows (ported with the wire slice): the
    layer builds and its plan carries them on every combined bucket."""
    layer = DistributedEmbedding(_tiny_tables(), device="cpu", **kwargs)
    for bucket in layer.plan.tp_buckets:
        assert bucket.wire_dtype == (wire if bucket.combiner else "f32")
        assert bucket.hot_rows == (min(hot, sum(bucket.rows))
                                   if bucket.combiner else 0)
    assert layer._hot_buckets == [b for b, bk in enumerate(
        layer.plan.tp_buckets) if bk.hot_rows]


@pytest.mark.parametrize("storage_dtype,payload", [
    ("fp8", torch.float8_e4m3fn), ("int8", torch.int8)])
def test_quantized_storage_builds(storage_dtype, payload):
    """Quantized storage (ported with the checkpoint slice): every tp
    bucket quantized, its payload 1-byte with a float32 scale a row."""
    layer = DistributedEmbedding(_tiny_tables(), device="cpu",
                                 storage_dtype=storage_dtype)
    assert layer.quantized_buckets == list(range(len(layer.tp)))
    for table, scale in zip(layer.tp, layer.tp_scale):
        assert table.dtype == payload
        assert scale.dtype == torch.float32
        assert tuple(scale.shape) == (table.shape[0], 1)


def test_world_size_without_a_process_group_raises():
    """The world is the process group's: `world_size` must match it."""
    with pytest.raises(ValueError, match="process group"):
        DistributedEmbedding(_tiny_tables(), device="cpu", world_size=2)
    layer = DistributedEmbedding(_tiny_tables(), device="cpu", world_size=1)
    assert (layer.world_size, layer.rank) == (1, 0)


def test_engine_features_outside_the_slice_raise(tmp_path):
    """The serving tier (A13) is ported at world size 1: the cache
    arguments, the replica label and the stream's calls build and run (a
    layer without offloaded buckets has no cache to build); a vocabulary
    manager of another layer still refuses."""
    layer = DistributedEmbedding(_tiny_tables(), device="cpu")
    eng = InferenceEngine(layer, device="cpu", cache_capacity=16)
    assert eng.caches == {} and eng.cache_stats()["hit_rate"] == 0.0
    with pytest.raises(ValueError, match="different layer"):
        InferenceEngine(layer, device="cpu", vocab_manager=object())
    assert eng.poll_updates(str(tmp_path / "somewhere")) == []
    assert not eng.degraded_reasons() and eng.refresh() == 0
    for kwargs in (dict(promote_threshold=3), dict(replica="r1")):
        e = InferenceEngine(layer, device="cpu", **kwargs)
        out = e.predict([np.arange(4), np.arange(4)])
        assert [tuple(o.shape) for o in out] == [(4, 8), (4, 8)]
    assert e.replica == "r1"
    assert e._metrics.counter("serve/predicts", replica="r1").value == 1


# ------------------------------------------------ the JAX package's signatures
# parameters of the JAX callables the port does not take, by idiom: its
# models hold their own parameters
IDIOM = {"params"}


def _jax_signatures():
    """(name, the JAX callable's parameters with their defaults)."""
    import inspect
    pytest.importorskip("jax")
    from distributed_embeddings_tpu import training as jt
    from distributed_embeddings_tpu.layers import dist_model_parallel as jd
    from distributed_embeddings_tpu.models import dlrm as jdl
    from distributed_embeddings_tpu.models import synthetic as js
    from distributed_embeddings_tpu.serving import engine as je
    out = {}
    for name, fn in (("DistributedEmbedding", jd.DistributedEmbedding),
                     ("DLRM", jdl.DLRM),
                     ("SyntheticModel", js.SyntheticModel),
                     ("InferenceEngine", je.InferenceEngine),
                     ("make_sparse_train_step", jt.make_sparse_train_step),
                     ("fit", jt.fit), ("evaluate", jt.evaluate)):
        params = inspect.signature(fn).parameters
        out[name] = {n: p.default for n, p in params.items()
                     if n not in {"self"} | IDIOM
                     and p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)
                     and p.default is not p.empty}
    return out


def _small_dlrm():
    return DLRM([10, 20], embedding_dim=8, bottom_mlp_dims=(8,),
                top_mlp_dims=(8, 1), num_numerical_features=3,
                device="cpu")


def _eval_batch(step):
    rng = np.random.RandomState(step)
    return (rng.rand(4, 3).astype(np.float32),
            [rng.randint(0, 10, 4), rng.randint(0, 20, 4)],
            rng.randint(0, 2, 4).astype(np.float32))


@pytest.mark.parametrize("name", [
    "DistributedEmbedding", "DLRM", "SyntheticModel", "InferenceEngine",
    "make_sparse_train_step", "fit", "evaluate"])
def test_port_takes_every_jax_parameter_at_its_default(name):
    """Every parameter of the JAX callable with a default, passed at that
    default (the JAX values themselves: ``jnp.float32``, ``print``, ...),
    is accepted by the port's counterpart; only `IDIOM` is left out."""
    from distributed_embeddings_tpu_torch import training
    defaults = _jax_signatures()[name]
    call = {
        "DistributedEmbedding": lambda kw: DistributedEmbedding(
            _tiny_tables(), device="cpu", **kw),
        "DLRM": lambda kw: DLRM([10, 20], device="cpu", **kw),
        "SyntheticModel": lambda kw: SyntheticModel(
            SYNTHETIC_MODELS["criteo"]._replace(embedding_configs=[
                SYNTHETIC_MODELS["criteo"].embedding_configs[0]._replace(
                    num_tables=2, num_rows=10, width=4)],
                mlp_sizes=[4]), device="cpu", **kw),
        "InferenceEngine": lambda kw: InferenceEngine(
            _small_dlrm(), device="cpu", **kw),
        "make_sparse_train_step": lambda kw: make_sparse_train_step(
            _small_dlrm(), **kw),
        "fit": lambda kw: fit(_small_dlrm(), [], 0, **kw),
        "evaluate": lambda kw: training.evaluate(
            _small_dlrm(), _eval_batch, **kw),
    }[name]
    call(defaults)
    for param, value in defaults.items():
        call({param: value})


SERVING_SIGNATURES = [
    ("serving.cache", "HotRowCache", "__init__"),
    ("serving.cache", "HotRowCache", "lookup_slots"),
    ("serving.cache", "HotRowCache", "refresh_from"),
    ("serving.cache", "HotRowCache", "apply_rows"),
    ("serving.cache", "HotRowCache", "invalidate"),
    ("serving.cache", "HotRowCache", "stats"),
    ("serving.cache", None, "cached_group_lookup"),
    ("serving.engine", "InferenceEngine", "predict"),
    ("serving.engine", "InferenceEngine", "warmup"),
    ("serving.engine", "InferenceEngine", "set_params"),
    ("serving.engine", "InferenceEngine", "refresh"),
    ("serving.engine", "InferenceEngine", "reanchor_published"),
    ("serving.engine", "InferenceEngine", "apply_delta"),
    ("serving.engine", "InferenceEngine", "poll_updates"),
    ("serving.engine", "InferenceEngine", "degraded_reasons"),
    ("serving.engine", "InferenceEngine", "update_stats"),
    ("serving.engine", "InferenceEngine", "cache_stats"),
    ("serving.batcher", "MicroBatcher", "__init__"),
    ("serving.batcher", "MicroBatcher", "submit"),
    ("serving.batcher", "MicroBatcher", "flush"),
    ("serving.batcher", "MicroBatcher", "summary"),
    ("fleet.ring", None, "stable_hash64"),
    ("fleet.ring", "HashRing", "__init__"),
    ("fleet.ring", "HashRing", "route"),
    ("fleet.ring", "HashRing", "assignments"),
    ("fleet.admission", "RouteResult", "__init__"),
    ("fleet.admission", "AdmissionController", "__init__"),
    ("fleet.admission", "AdmissionController", "shed_reason"),
    ("fleet.rollout", "CanaryController", "__init__"),
    ("fleet.rollout", "CanaryController", "advance"),
    ("fleet.rollout", "CanaryController", "candidate"),
    ("fleet.router", "FleetRouter", "__init__"),
    ("fleet.router", "FleetRouter", "add_replica"),
    ("fleet.router", "FleetRouter", "remove_replica"),
    ("fleet.router", "FleetRouter", "submit"),
    ("fleet.router", "FleetRouter", "flush"),
    ("fleet.router", "FleetRouter", "step"),
    ("fleet.router", "FleetRouter", "stats"),
]


@pytest.mark.parametrize("module,cls,name", SERVING_SIGNATURES,
                         ids=[f"{c or m}.{n}"
                              for m, c, n in SERVING_SIGNATURES])
def test_serving_names_take_the_jax_parameters(module, cls, name):
    """The serving tier's public names (the cache, the engine's stream
    calls, the batcher, the fleet) take the JAX package's parameters, in
    order, with its defaults."""
    import importlib
    import inspect
    pytest.importorskip("jax")

    def params(pkg):
        mod = importlib.import_module(f"{pkg}.{module}")
        fn = getattr(getattr(mod, cls), name) if cls else getattr(mod, name)
        return [(n, p.default)
                for n, p in inspect.signature(fn).parameters.items()
                if n not in {"self"} | IDIOM]
    assert params("distributed_embeddings_tpu_torch") == params(
        "distributed_embeddings_tpu")


@pytest.mark.parametrize("name", [
    "sync_hot_rows", "observe_hot_ids", "hot_keys_from_counts",
    "hot_resident_rows", "hot_stats", "make_taps", "init_sparse_state"])
def test_layer_methods_take_the_jax_parameters(name):
    """The hot-row methods (and `make_taps` and `init_sparse_state`, which
    they extend) take the JAX layer's parameters, in order, with its
    defaults; only `IDIOM` is left out (the port's layer holds its own
    tables)."""
    import inspect
    pytest.importorskip("jax")
    from distributed_embeddings_tpu.layers import dist_model_parallel as jd

    def params(fn):
        return [(n, p.default)
                for n, p in inspect.signature(fn).parameters.items()
                if n not in {"self"} | IDIOM]
    assert params(getattr(DistributedEmbedding, name)) == params(
        getattr(jd.DistributedEmbedding, name))


@pytest.mark.parametrize("build,item", [
    pytest.param(lambda: DistributedEmbedding(
        _tiny_tables(), device="cpu", use_custom_kernel=False), "North star",
        id="build0-North star"),
    pytest.param(lambda: DLRM([10, 20], embedding_dim=8,
                              bottom_mlp_dims=(8,), top_mlp_dims=(8, 1),
                              num_numerical_features=3, device="cpu",
                              gpu_embedding_size=100), "A8",
                 id="build1-A8"),
    pytest.param(lambda: wire.ragged_exchange(), "A5", id="build2-A5"),
    pytest.param(lambda: InferenceEngine(_small_dlrm(), device="cpu",
                                         promote_threshold=5), "A13",
                 id="build3-A13"),
])
def test_refused_values_name_their_roadmap_item(build, item):
    """What stays unported raises naming its ROADMAP item; A8 (host
    offload), ported since, builds: a DLRM with a device budget holds its
    table past it in host memory and serves its logits; so does A13 (the
    engine's promote_threshold), whose engine serves a DLRM's logits."""
    if item not in ("A8", "A13"):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            build()
        return
    if item == "A13":
        engine = build()
        rng = np.random.RandomState(1)
        logits = engine.predict((rng.rand(4, 3).astype(np.float32),
                                 [rng.randint(0, 10, 4),
                                  rng.randint(0, 20, 4)]))
        assert tuple(logits.shape) == (4, 1)
        assert bool(torch.isfinite(logits).all())
        return
    model = build()
    assert model.embedding.offloaded_buckets
    rng = np.random.RandomState(1)
    with torch.no_grad():
        logits = model(rng.rand(4, 3).astype(np.float32),
                       [rng.randint(0, 10, 4), rng.randint(0, 20, 4)])
    assert tuple(logits.shape) == (4, 1) and bool(torch.isfinite(logits).all())


def _tiny_synthetic(**kw):
    return SyntheticModel(
        SYNTHETIC_MODELS["criteo"]._replace(embedding_configs=[
            SYNTHETIC_MODELS["criteo"].embedding_configs[0]._replace(
                num_tables=2, num_rows=10, width=4)],
            mlp_sizes=[4]), device="cpu", **kw)


def _mixed_outputs(name, dtype):
    """The outputs of each entry point built with `compute_dtype`: the
    layer's lookups, or the model's (and engine's) embedding outputs and
    logits, or a train step's losses and updated tables."""
    ids = [np.array([1, 3, 9]), np.array([0, 19, 4])]
    if name == "DistributedEmbedding":
        return DistributedEmbedding(_tiny_tables(), device="cpu",
                                    compute_dtype=dtype)(ids), []
    if name == "InferenceEngine":
        layer = DistributedEmbedding(_tiny_tables(), device="cpu",
                                     compute_dtype=dtype)
        return InferenceEngine(layer, device="cpu").predict(ids), []
    model = (_tiny_synthetic(compute_dtype=dtype) if name == "SyntheticModel"
             else DLRM([10, 20], embedding_dim=8, bottom_mlp_dims=(8,),
                       top_mlp_dims=(8, 1), num_numerical_features=3,
                       device="cpu", compute_dtype=dtype))
    num = np.ones((3, model.num_numerical_features), np.float32)
    if name == "make_sparse_train_step":
        init, step = make_sparse_train_step(model, "adagrad")
        _, _, loss = step(model, init(model), num, ids, np.ones(3))
        return model.embedding(ids), [loss]
    return model.embedding(ids), [model(num, ids)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, "float16"])
@pytest.mark.parametrize("name", ["DistributedEmbedding", "DLRM",
                                  "SyntheticModel", "InferenceEngine",
                                  "make_sparse_train_step"])
def test_entry_points_take_a_compute_dtype(name, dtype):
    """Each constructor takes bfloat16 and float16 (mixed precision, ROADMAP
    Queue A16): the embedding outputs come in that dtype, the logits and
    losses in float32, finite."""
    want = torch.bfloat16 if dtype is torch.bfloat16 else torch.float16
    embedded, f32 = _mixed_outputs(name, dtype)
    assert embedded and all(e.dtype == want for e in embedded)
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for t in f32)


@pytest.mark.parametrize("build", [
    lambda: DistributedEmbedding(_tiny_tables(), device="cpu",
                                 compute_dtype=torch.int32),
    lambda: DLRM([10, 20], embedding_dim=8, device="cpu",
                 compute_dtype=np.int64),
    lambda: _tiny_synthetic(compute_dtype="int8"),
])
def test_an_integer_compute_dtype_raises(build):
    with pytest.raises(ValueError, match="compute_dtype"):
        build()


def test_dlrm_takes_the_strategy_under_both_names(monkeypatch):
    """`dist_strategy` (the JAX name) and `strategy` (the port's older
    keyword) reach `DistributedEmbedding` as its strategy."""
    from distributed_embeddings_tpu_torch.models import dlrm as pt_dlrm
    seen = []

    class Recording(DistributedEmbedding):
        def __init__(self, embeddings, strategy="auto", **kw):
            seen.append(strategy)
            super().__init__(embeddings, strategy, **kw)

    monkeypatch.setattr(pt_dlrm, "DistributedEmbedding", Recording)
    DLRM([10, 20], embedding_dim=8, device="cpu", dist_strategy="basic")
    DLRM([10, 20], embedding_dim=8, device="cpu", strategy="comm_balanced")
    DLRM([10, 20], embedding_dim=8, device="cpu")
    assert seen == ["basic", "comm_balanced", "memory_balanced"]


# ------------------------------------------- the reference's public names
def test_top_level_names_match_the_reference():
    """The original library's top-level names (as the JAX package's
    `test_top_level_api_matches_reference` lists them) exist in the port,
    the version is the reference's, and `dist_model_parallel` is the
    layer's module."""
    import distributed_embeddings_tpu as jax_pkg
    import distributed_embeddings_tpu_torch as port
    from distributed_embeddings_tpu_torch.layers import dist_model_parallel
    for name in ["embedding_lookup", "Embedding", "IntegerLookup",
                 "dist_model_parallel",
                 "DistEmbeddingStrategy", "DistributedEmbedding",
                 "broadcast_variables", "DistributedGradientTape",
                 "DistributedOptimizer", "BroadcastGlobalVariablesCallback",
                 "store", "TableStore", "DeltaConsumer", "vocab",
                 "VocabManager", "serving", "InferenceEngine",
                 "HotRowCache", "MicroBatcher", "__version__"]:
        assert hasattr(port, name) and name in port.__all__, name
    assert port.__version__ == jax_pkg.__version__ == "0.1.0"
    assert port.dist_model_parallel is dist_model_parallel
    assert (port.dist_model_parallel.DistributedEmbedding
            is DistributedEmbedding)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_to_split_matches_the_reference(seed):
    """Sorted COO rows (some rows empty, some repeated) -> CSR splits, the
    same as the JAX function's, in the ids' dtype."""
    from distributed_embeddings_tpu.ops import embedding_ops as jax_ops
    from distributed_embeddings_tpu_torch.ops import embedding_ops
    rng = np.random.default_rng(seed)
    nrows = int(rng.integers(1, 40))
    rows = np.sort(rng.integers(0, nrows, int(rng.integers(0, 120))))
    for dtype in (np.int32, np.int64):
        want = np.asarray(jax_ops.row_to_split(rows.astype(dtype), nrows))
        got = embedding_ops.row_to_split(torch.from_numpy(rows.astype(dtype)),
                                         nrows)
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        np.testing.assert_array_equal(got.numpy(), want)
    table = torch.from_numpy(rng.standard_normal((5, 3), dtype=np.float32))
    assert embedding_ops.read_var_no_copy(table) is table


@pytest.mark.parametrize("combiner", [None, "sum", "mean"])
@pytest.mark.parametrize("shape", [(4,), (4, 3), (2, 5, 7)])
def test_compute_output_shape_matches_the_reference(combiner, shape):
    from distributed_embeddings_tpu.layers.embedding import (
        Embedding as JaxEmbedding)
    want = JaxEmbedding(10, 6, combiner=combiner).compute_output_shape(shape)
    got = Embedding(10, 6, combiner=combiner,
                    device="meta").compute_output_shape(shape)
    assert got == tuple(want)


def test_distributed_optimizer_apply_matches_the_reference():
    """``apply(params, updates)`` adds the updates (in place in the port),
    as the JAX optimizer's does."""
    from distributed_embeddings_tpu import training as jax_training
    from distributed_embeddings_tpu_torch import training as pt_training
    rng = np.random.default_rng(4)
    params = {n: rng.standard_normal(s, dtype=np.float32)
              for n, s in (("a", (3, 4)), ("b", (5,)))}
    updates = {n: rng.standard_normal(p.shape, dtype=np.float32)
               for n, p in params.items()}
    want = jax_training.DistributedOptimizer(None).apply(params, updates)
    pt_params = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    got = pt_training.DistributedOptimizer(pt_training.sgd(0.1)).apply(
        pt_params, {n: torch.from_numpy(u) for n, u in updates.items()})
    assert got is pt_params
    for n in params:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_dlrm_make_train_step_matches_the_reference():
    """Two dense sgd steps of `DLRM.make_train_step` from the same weights
    and batches: the JAX model's loss and parameters (rtol 1e-5)."""
    import jax
    import optax
    from distributed_embeddings_tpu.models import dlrm as jax_dlrm
    from distributed_embeddings_tpu_torch import convert
    from distributed_embeddings_tpu_torch import training as pt_training
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    sizes = [40, 7, 300, 25]
    kw = dict(embedding_dim=8, bottom_mlp_dims=(16, 8), top_mlp_dims=(16, 1),
              num_numerical_features=5)
    jm = jax_dlrm.DLRM(sizes, **kw)
    params = jm.init(jax.random.PRNGKey(5))
    pm = DLRM(sizes, device="cpu", **kw)
    pm.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params), pm))
    jstep = jm.make_train_step(optax.sgd(0.05))
    jstate = optax.sgd(0.05).init(params)
    popt = pt_training.sgd(0.05)
    pstep = pm.make_train_step(popt)
    pstate = popt.init(dict(pm.named_parameters()))
    gen = ClickGenerator(sizes, 5, 32, seed=3)
    for s in range(2):
        num, cats, labels = gen.batch(s)
        params, jstate, jloss = jstep(params, jstate, num, list(cats), labels)
        pm, pstate, ploss = pstep(pm, pstate, num, list(cats), labels)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(np.asarray, params), pm)
    got = pm.state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("pipelined", [True, False])
def test_pipeline_accounting_matches_the_reference(pipelined):
    """`stage_histograms` (both pipelines) and `IngestPipeline.bottleneck`
    name the same stages and counts as the JAX package's, and the
    bottleneck is the stage that sleeps."""
    import time
    from distributed_embeddings_tpu.utils import pipeline as jax_pipeline
    from distributed_embeddings_tpu_torch.utils import pipeline as pt_pipeline
    rng = np.random.default_rng(6)
    items = [rng.standard_normal(3) for _ in range(4)]

    def slow(x):
        time.sleep(0.02)
        return x * 2

    stages = [("scale", lambda x: x + 1), ("slow", slow)]
    name = "IngestPipeline" if pipelined else "SerialPipeline"
    results = []
    for module in (jax_pipeline, pt_pipeline):
        pipe = getattr(module, name)(iter(items), stages)
        out = list(pipe)
        hists = pipe.stage_histograms()
        results.append((out, {n: h.count for n, h in hists.items()},
                        pipe.bottleneck() if pipelined else None))
    (jout, jcounts, jslow), (pout, pcounts, pslow) = results
    for a, b in zip(pout, jout):
        np.testing.assert_array_equal(a, b)
    assert pcounts == jcounts == {"read": 4, "scale": 4, "slow": 4}
    assert pslow == jslow == ("slow" if pipelined else None)

