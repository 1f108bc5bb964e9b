"""Package rules of the PyTorch port.

It imports neither jax nor the JAX package (at run time or in its source,
nor does chip_smoke.py); its entry points default to the card and refuse
to run without one; its CUDA wrapper launches the kernel or raises, never
falling back to the plain version; features outside the slice raise
NotImplementedError. The sparse kernels' wrappers and the train step
follow the same rules.
"""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from distributed_embeddings_tpu_torch import DistributedEmbedding, InferenceEngine  # noqa: E402
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.models.dlrm import DLRM  # noqa: E402
from distributed_embeddings_tpu_torch.models.synthetic import (  # noqa: E402
    SYNTHETIC_MODELS, SyntheticModel)
from distributed_embeddings_tpu_torch.ops import cuda_lookup, cuda_sparse  # noqa: E402
from distributed_embeddings_tpu_torch.ops import sparse_update  # noqa: E402
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


@pytest.mark.parametrize("kwargs", [dict(strategy="dense"),
                                    dict(strategy="tiled")])
def test_train_step_outside_the_slice_raises(kwargs):
    model = DLRM([10, 20], embedding_dim=8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A2"):
        make_sparse_train_step(model, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(sparse=False), dict(lookahead=1), dict(store=object()),
    dict(vocab=object()), dict(hot_sync_every=4), dict(eval_data=[]),
    dict(pipelined=True), dict(registry=object()),
])
def test_fit_outside_the_slice_raises(kwargs):
    model = DLRM([10, 20], embedding_dim=8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        fit(model, [], 0, **kwargs)


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
    dict(world_size=2), dict(mesh=object()), dict(dp_input=False),
    dict(row_slice_threshold=100), dict(gpu_embedding_size=100),
    dict(hot_rows=8), dict(exchange_wire="bf16"),
    dict(storage_dtype="int8"), dict(vocab_slack=4),
])
def test_features_outside_the_slice_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        DistributedEmbedding(_tiny_tables(), device="cpu", **kwargs)


def test_engine_features_outside_the_slice_raise():
    layer = DistributedEmbedding(_tiny_tables(), device="cpu")
    for kwargs in (dict(cache_capacity=16), dict(vocab_manager=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
            InferenceEngine(layer, device="cpu", **kwargs)
    eng = InferenceEngine(layer, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        eng.poll_updates("somewhere")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A2"):
        sparse_update.make_sparse_optimizer("adagrad", 0.1,
                                            strategy="dense")
