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
from distributed_embeddings_tpu_torch.ops import sparse_update  # noqa: E402
from distributed_embeddings_tpu_torch.tools import cuda_feature_probe  # noqa: E402
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
                                   "dlrm", "engine", "train_step"])
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
    dict(compute_dtype=torch.bfloat16),
    dict(row_slice_threshold=100, dist_strategy="basic")])
def test_train_step_outside_the_slice_raises(kwargs):
    """A model the train step would train, built with what the port has
    not ported (mixed precision, row slicing), raises at build time."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        make_sparse_train_step(DLRM([10, 20], embedding_dim=8, device="cpu",
                                    **kwargs))


@pytest.mark.parametrize("kwargs", [
    dict(publish_every=4), dict(lookahead=1), dict(store=object()),
    dict(vocab=object()), dict(hot_sync_every=4), dict(stale_ok=True),
    dict(publish_dir="somewhere"), dict(registry=object()),
])
def test_fit_outside_the_slice_raises(kwargs):
    model = DLRM([10, 20], embedding_dim=8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        fit(model, [], 0, **kwargs)


@pytest.mark.parametrize("name,default,other,item", [
    ("hot_sync_every", 0, 4, "A7"), ("vocab_every", 16, 4, "A12"),
])
def test_fit_takes_the_reference_arguments_at_their_defaults(name, default,
                                                             other, item):
    """The JAX `fit`'s arguments without a port yet: the default is
    accepted, any other value raises naming the ROADMAP item."""
    model = DLRM([10, 20], embedding_dim=8, device="cpu")
    fit(model, [], 0, **{name: default})
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP Queue {item}[ ,]"):
        fit(model, [], 0, **{name: other})


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


@pytest.mark.parametrize("kwargs", [
    dict(mesh=object(), world_size=2), dict(mesh=object()),
    dict(dp_input=False),
    dict(row_slice_threshold=100), dict(gpu_embedding_size=100),
    dict(hot_rows=8), dict(exchange_wire="bf16"),
    dict(storage_dtype="int8"), dict(vocab_slack=4),
])
def test_features_outside_the_slice_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        DistributedEmbedding(_tiny_tables(), device="cpu", **kwargs)


def test_world_size_without_a_process_group_raises():
    """The world is the process group's: `world_size` must match it."""
    with pytest.raises(ValueError, match="process group"):
        DistributedEmbedding(_tiny_tables(), device="cpu", world_size=2)
    layer = DistributedEmbedding(_tiny_tables(), device="cpu", world_size=1)
    assert (layer.world_size, layer.rank) == (1, 0)


def test_engine_features_outside_the_slice_raise():
    layer = DistributedEmbedding(_tiny_tables(), device="cpu")
    for kwargs in (dict(cache_capacity=16), dict(vocab_manager=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
            InferenceEngine(layer, device="cpu", **kwargs)
    eng = InferenceEngine(layer, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        eng.poll_updates("somewhere")
    for kwargs in (dict(promote_threshold=3), dict(replica="r1")):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue A13"):
            InferenceEngine(layer, device="cpu", **kwargs)


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


@pytest.mark.parametrize("build,item", [
    (lambda: DistributedEmbedding(_tiny_tables(), device="cpu",
                                  compute_dtype="bfloat16"), "A16"),
    (lambda: DistributedEmbedding(_tiny_tables(), device="cpu",
                                  use_custom_kernel=False), "North star"),
    (lambda: DLRM([10, 20], embedding_dim=8, device="cpu",
                  compute_dtype=torch.float16), "A16"),
    (lambda: DLRM([10, 20], embedding_dim=8, device="cpu",
                  dp_input=False), "A4"),
    (lambda: SyntheticModel(SYNTHETIC_MODELS["tiny"], device="cpu",
                            distributed=False), "A4"),
    (lambda: SyntheticModel(SYNTHETIC_MODELS["tiny"], device="cpu",
                            compute_dtype="bfloat16"), "A16"),
    (lambda: InferenceEngine(_small_dlrm(), device="cpu",
                             promote_threshold=5), "A13"),
])
def test_refused_values_name_their_roadmap_item(build, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
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
