"""Host offload in the port against the JAX package's float32 offload path.

The JAX package's `tests/test_offload.py` tables (8 one-hot-or-more tables,
the two 5000-row ones past its 40,000-element device budget) at world 1,
the same weights (numpy, from a seed) in both packages:

* placement: the same buckets offloaded; on the CPU the offloaded tables
  are plain host tensors that ``.to()`` leaves in place; the forward
  against the JAX offloaded layer and the port's all-device layer (rtol
  1e-5 / atol 1e-5, the JAX test's bar); the weights round trip bit for
  bit; the weighted-mean regression (explicit weights get no 1/k scale);
* three sparse steps of sgd, adagrad and adam (and adagrad under a
  schedule) against the JAX offloaded model and the port's all-device
  model: losses at rtol 1e-5 / atol 1e-6, tables at rtol 2e-5 / atol
  2e-5 (the JAX test's bars); model-parallel input (``dp_input=False``)
  forward and step against the data-parallel ones;
* resume files and the global weights with offloaded buckets and their
  state; the engine (``cache_capacity=0``) against the forward;
* `host_apply_rows_inplace` and `prepare_safe_grad` against the JAX
  package's functions bit for bit, with the two refusals; an optimizer
  without a host rule refused; the dense step refused, as the JAX
  package's `make_train_step` refuses an offloaded layer;
* quantized offload (int8, fp8), held against the numpy twins
  (`decode_rows_np`, `host_apply_rows_inplace`, `encode_rows_np` of the
  JAX package): the forward and each host apply bit for bit (the JAX
  package's own quantized offload path is red on this host, ROADMAP
  Queue C);
* world 2 over gloo (one spawn of `tests/torch_multigpu_worker.py`'s
  ``offload`` case) against the JAX package on a 2-device mesh: forward,
  three adagrad steps and the weights, at the same bars.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.ops import sparse_update as jax_sparse  # noqa: E402
from distributed_embeddings_tpu.ops import wire as jax_wire  # noqa: E402
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu_torch import training as pt_training  # noqa: E402
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.ops import sparse_update  # noqa: E402
from distributed_embeddings_tpu_torch.serving.engine import (  # noqa: E402
    InferenceEngine)
from distributed_embeddings_tpu_torch.utils import checkpoint  # noqa: E402

from test_offload import BUDGET, SPECS  # noqa: E402
from test_sparse_train import BATCH, TinyModel  # noqa: E402

LR = 0.05
STEPS = 3
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=2e-5, atol=2e-5)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
MEAN_SPECS = [(5000, 16, "mean"), (40, 16, "mean"), (5000, 16, "sum"),
              (64, 16, "mean"), (128, 16, "sum"), (96, 16, "mean"),
              (80, 16, "sum"), (72, 16, "mean")]


def _layer(specs=SPECS, offload=True, **kw):
    return DistributedEmbedding(
        [Embedding(v, w, combiner=c, device="meta") for v, w, c in specs],
        device="cpu", gpu_embedding_size=(BUDGET if offload else None), **kw)


def _jax_layer(specs=SPECS, offload=True, **kw):
    return JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner=c) for v, w, c in specs],
        gpu_embedding_size=(BUDGET if offload else None), **kw)


def _weights(specs=SPECS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(v, w).astype(np.float32) * 0.1 for v, w, _ in specs]


def _head(specs=SPECS):
    return np.random.RandomState(7).randn(
        sum(w for _, w, _ in specs), 1).astype(np.float32)


class _Tiny(torch.nn.Module):
    """The JAX test's `TinyModel` in the port: the outputs concatenated,
    a linear head, the mean squared error."""

    def __init__(self, specs=SPECS, offload=True, **kw):
        super().__init__()
        self.embedding = _layer(specs, offload, **kw)
        self.w = torch.nn.Parameter(torch.from_numpy(_head(specs)))

    def loss_fn(self, numerical, cats, labels, taps=None,
                return_residuals=False):
        out = self.embedding(list(cats), taps=taps,
                             return_residuals=return_residuals)
        outs, res = out if return_residuals else (out, None)
        x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], 1).float()
        labels = torch.as_tensor(labels, dtype=torch.float32)
        loss = torch.mean(((x @ self.w)[:, 0] - labels.reshape(-1)) ** 2)
        return (loss, res) if return_residuals else loss

    def forward(self, numerical, cats):
        outs = self.embedding(list(cats))
        return torch.cat([o.reshape(o.shape[0], -1) for o in outs], 1) @ self.w


def _batches(seed=3, steps=STEPS, specs=SPECS, hotness=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        cats = [rng.randint(0, v, size=(BATCH, hotness)) for v, _, _ in specs]
        out.append((cats, rng.randn(BATCH).astype(np.float32)))
    return out


def _run_jax(optimizer, batches, lr=LR):
    model = TinyModel(SPECS, create_mesh(jax.devices()[:1]),
                      gpu_embedding_size=BUDGET)
    assert model.embedding._offload_enabled
    init_fn, step_fn = jax_training.make_sparse_train_step(
        model, optimizer, lr=lr, strategy="sort")
    params = {"embedding": model.embedding.set_weights(_weights()),
              "head": {"w": jnp.asarray(_head())}}
    state = init_fn(params)
    losses = []
    for cats, labels in batches:
        params, state, loss = step_fn(params, state, jnp.zeros((BATCH, 1)),
                                      [jnp.asarray(c) for c in cats],
                                      jnp.asarray(labels))
        losses.append(float(loss))
    return losses, model.embedding.get_weights(params["embedding"])


def _run_port(optimizer, batches, offload=True, lr=LR, **kw):
    model = _Tiny(offload=offload, **kw)
    model.embedding.set_weights(_weights())
    init_fn, step_fn = pt_training.make_sparse_train_step(
        model, optimizer, lr=lr, strategy="sort")
    state = init_fn(model)
    losses = []
    for cats, labels in batches:
        _, state, loss = step_fn(model, state, np.zeros((BATCH, 1)), cats,
                                 labels)
        losses.append(float(loss))
    return losses, model.embedding.get_weights(), model, state


def _assert_tables(got, want, what):
    for t, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, err_msg=f"{what} table {t}",
                                   **TABLE_TOL)


# ------------------------------------------------------------- placement
def test_offload_placement_forward_and_round_trip():
    layer, jl = _layer(), _jax_layer()
    assert layer._offload_enabled and jl._offload_enabled
    assert layer.offloaded_buckets == [
        b for b, bk in enumerate(jl.plan.tp_buckets) if bk.offload]
    assert layer.offloaded_buckets, "the budget should force an offload"
    for b, bk in enumerate(layer.plan.tp_buckets):
        assert bk.offload == jl.plan.tp_buckets[b].offload
        assert layer.tp[b].device.type == "cpu"
    # .to() and friends leave the host tables where they are
    held = [layer.tp[b] for b in layer.offloaded_buckets]
    layer.to("cpu").float()
    assert all(layer.tp[b] is t for b, t in zip(layer.offloaded_buckets,
                                                  held))
    assert layer.pinned_host_bytes() == 0     # a CPU layer pins nothing
    weights = _weights()
    layer.set_weights(weights)
    dev = _layer(offload=False)
    dev.set_weights(weights)
    params = jl.set_weights(weights)
    rng = np.random.RandomState(0)
    inputs = [rng.randint(0, v, size=(BATCH, 2)) for v, _, _ in SPECS]
    got = layer(inputs)
    want = jl.apply(params, [jnp.asarray(x) for x in inputs])
    for i, (a, b, c) in enumerate(zip(got, want, dev(inputs))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"output {i}", **FWD_TOL)
        np.testing.assert_allclose(a.numpy(), c.numpy(),
                                   err_msg=f"output {i}", **FWD_TOL)
    for t, (a, b) in enumerate(zip(weights, layer.get_weights())):
        np.testing.assert_array_equal(a, b, err_msg=f"table {t}")


def test_offload_weighted_mean_forward():
    """The JAX test's regression: a mean table's offloaded lookup with
    explicit weights takes the normalized weights and no 1/k scale on
    top; without weights, the 1/k scale."""
    layer, jl = _layer(MEAN_SPECS), _jax_layer(MEAN_SPECS)
    assert layer.offloaded_buckets
    weights = _weights(MEAN_SPECS, 5)
    layer.set_weights(weights)
    params = jl.set_weights(weights)
    rng = np.random.RandomState(5)
    for weighted in (True, False):
        inputs = [(rng.randint(0, v, size=(BATCH, 3)),
                   np.abs(rng.rand(BATCH, 3)).astype(np.float32))
                  if weighted else rng.randint(0, v, size=(BATCH, 3))
                  for v, _, _ in MEAN_SPECS]
        want = jl.apply(params, [
            tuple(jnp.asarray(y) for y in x) if weighted
            else jnp.asarray(x) for x in inputs])
        for i, (a, b) in enumerate(zip(layer(inputs), want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f"output {i}", **FWD_TOL)


# -------------------------------------------------------------- training
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_offload_sparse_train_matches_jax(optimizer):
    """Three sparse steps of the offloaded model against the JAX package's
    offloaded model and against the port's all-device model."""
    batches = _batches()
    l_jax, w_jax = _run_jax(optimizer, batches)
    l_off, w_off, model, state = _run_port(optimizer, batches)
    l_dev, w_dev, _, _ = _run_port(optimizer, batches, offload=False)
    np.testing.assert_allclose(l_off, l_jax, **LOSS_TOL)
    np.testing.assert_allclose(l_off, l_dev, **LOSS_TOL)
    _assert_tables(w_off, w_jax, "against the JAX package:")
    _assert_tables(w_off, w_dev, "against the all-device model:")
    emb = model.embedding
    for b in emb.offloaded_buckets:
        for x in state["emb"]["tp"][b]:
            if torch.is_tensor(x):
                assert x.device.type == "cpu" and x.shape == emb.tp[b].shape
    if optimizer == "adam":
        assert state["emb"]["tp"][emb.offloaded_buckets[0]][2] == STEPS


def test_offload_scheduled_lr_matches_jax():
    """Under a schedule each step's host apply takes the lr at the step's
    count (JAX training.py :316-318, :342-360)."""
    batches = _batches(seed=11)

    def schedule(count):
        return 0.02 * (count + 1)
    l_jax, w_jax = _run_jax("adagrad", batches, lr=schedule)
    l_off, w_off, _, _ = _run_port("adagrad", batches, lr=schedule)
    np.testing.assert_allclose(l_off, l_jax, **LOSS_TOL)
    _assert_tables(w_off, w_jax, "scheduled:")


def test_offload_forward_mp_matches_dp_input():
    """Model-parallel input (``dp_input=False``) at world 1: the forward
    equals the data-parallel layer's and the JAX package's `apply_mp`, and
    its sparse step the data-parallel step."""
    layer, jl = _layer(dp_input=False), _jax_layer(dp_input=False)
    weights = _weights()
    layer.set_weights(weights)
    params = jl.set_weights(weights)
    rng = np.random.RandomState(4)
    inputs = [rng.randint(0, v, size=(BATCH, 2)) for v, _, _ in SPECS]
    own = [inputs[layer.strategy.input_groups[1][pos]]
           for pos in layer.strategy.input_ids_list[0]]
    got = layer.forward_mp(own)
    want = jl.apply_mp(params, [[jnp.asarray(x) for x in own]])
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"output {i}", **FWD_TOL)
    batches = _batches(seed=9, steps=2)
    _, w_dp, _, _ = _run_port("adagrad", batches)
    model = _Tiny(dp_input=False)
    model.embedding.set_weights(weights)
    init_fn, step_fn = pt_training.make_sparse_train_step(
        model, "adagrad", lr=LR, strategy="sort")
    state = init_fn(model)
    for cats, labels in batches:
        own = [cats[model.embedding.strategy.input_groups[1][pos]]
               for pos in model.embedding.strategy.input_ids_list[0]]
        _, state, _ = step_fn(model, state, np.zeros((BATCH, 1)), own,
                              labels)
    for t, (a, b) in enumerate(zip(model.embedding.get_weights(), w_dp)):
        np.testing.assert_array_equal(a, b, err_msg=f"table {t}")


def test_offload_dense_step_refused():
    """The JAX package's dense step cannot differentiate an offloaded
    layer on this host (its host and device memory spaces do not mix);
    the port's refuses one by name."""
    jl = _jax_layer()
    params = jl.set_weights(_weights())
    cats = [jnp.asarray(np.random.RandomState(0).randint(0, v, size=(8,)))
            for v, _, _ in SPECS]
    step = jax_training.make_train_step(
        lambda p, c: sum(jnp.sum(o * o) for o in jl.apply(p, c)),
        optax.sgd(0.1))
    with pytest.raises(ValueError, match="memory_space"):
        step(params, optax.sgd(0.1).init(params), cats)
    model = _Tiny()
    step = pt_training.make_train_step(
        lambda m, *batch: m.loss_fn(*batch), pt_training.sgd(0.1))
    with pytest.raises(ValueError, match="offloaded"):
        step(model, pt_training.sgd(0.1).init(dict(model.named_parameters())),
             np.zeros((BATCH, 1)), _batches(steps=1)[0][0],
             np.zeros(BATCH, np.float32))


def test_unknown_host_apply_rejected():
    """Only an optimizer with a host rule touches offloaded buckets."""
    fake = sparse_update.SparseOptimizer("rmsprop", lambda t: (),
                                         lambda t, s, g: (t, s))
    layer = _layer()
    with pytest.raises(NotImplementedError, match="host-memory apply"):
        layer.sparse_update({"tp": [], "row": []}, {"tp": [], "row": []},
                            None, fake)


# -------------------------------------------------- checkpoints, serving
def test_offload_checkpoint_round_trip(tmp_path):
    """A resume file carries the offloaded tables and their state; the
    restore copies into the layer's own host tensors. The global weights
    round trip through `save_global_weights` and `set_weights`."""
    batches = _batches(seed=5)
    _, _, model, state = _run_port("adagrad", batches[:2])
    path = checkpoint.save_checkpoint(
        str(tmp_path / "ck"), {"params": model.state_dict(),
                               "opt_state": state}, step=2)
    fresh = _Tiny()
    init_fn, step_fn = pt_training.make_sparse_train_step(
        fresh, "adagrad", lr=LR, strategy="sort")
    fresh_state = init_fn(fresh)
    tables = [fresh.embedding.tp[b] for b in fresh.embedding.offloaded_buckets]
    acc = [fresh_state["emb"]["tp"][b][0]
           for b in fresh.embedding.offloaded_buckets]
    restored = checkpoint.restore_checkpoint(
        path, {"params": fresh.state_dict(), "opt_state": fresh_state})
    for b, t, a in zip(fresh.embedding.offloaded_buckets, tables, acc):
        assert fresh.embedding.tp[b] is t
        assert restored["opt_state"]["emb"]["tp"][b][0] is a
        np.testing.assert_array_equal(t.detach().numpy(),
                                      model.embedding.tp[b].detach().numpy())
        np.testing.assert_array_equal(
            a.numpy(), state["emb"]["tp"][b][0].numpy())
    cats, labels = batches[2]
    _, _, loss_a = step_fn(fresh, restored["opt_state"],
                           np.zeros((BATCH, 1)), cats, labels)
    _, step_b = pt_training.make_sparse_train_step(
        model, "adagrad", lr=LR, strategy="sort")
    _, _, loss_b = step_b(model, state, np.zeros((BATCH, 1)), cats, labels)
    assert float(loss_a) == float(loss_b)
    for a, b in zip(fresh.embedding.get_weights(),
                    model.embedding.get_weights()):
        np.testing.assert_array_equal(a, b)
    written = checkpoint.save_global_weights(str(tmp_path / "gw"),
                                             model.embedding.get_weights())
    other = _layer()
    other.set_weights(checkpoint.load_global_weights(written))
    for a, b in zip(other.get_weights(), model.embedding.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_offload_engine_matches_forward():
    """`InferenceEngine` (``cache_capacity=0``, the host-side path) serves
    an offloaded model: a request it pads, equal to the model's forward
    and to the JAX layer's outputs through the same head."""
    model = _Tiny()
    weights = _weights()
    model.embedding.set_weights(weights)
    engine = InferenceEngine(model, device="cpu", cache_capacity=0)
    engine.warmup([32])
    rng = np.random.RandomState(8)
    cats = [rng.randint(0, v, size=(BATCH + 3, 2)) for v, _, _ in SPECS]
    num = np.zeros((BATCH + 3, 1), np.float32)
    got = engine.predict((num, cats))
    with torch.no_grad():
        want = model(num, cats)
    # the engine's padded batch takes another gemm than the request's
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    jl = _jax_layer()
    outs = jl.apply(jl.set_weights(weights), [jnp.asarray(c) for c in cats])
    x = np.concatenate([np.asarray(o).reshape(o.shape[0], -1)
                        for o in outs], 1)
    np.testing.assert_allclose(got.numpy(), x @ _head(), **FWD_TOL)


# ------------------------------------------------------ the host rules
def _apply_case(kind, seed=0, rows=50, width=6, n=20):
    rng = np.random.RandomState(seed)
    table = rng.randn(rows, width).astype(np.float32)
    state = {"sgd": (), "set": (),
             "adagrad": (np.full((rows, width), 0.1, np.float32),),
             "adam": (rng.rand(rows, width).astype(np.float32),
                      rng.rand(rows, width).astype(np.float32), 3)}[kind]
    rep = rng.permutation(rows)[:n].astype(np.int32)
    valid = (rng.rand(n) > 0.3).astype(np.float32)
    rep[valid == 0] = 0
    sums = rng.randn(n, width).astype(np.float32) * (valid[:, None] > 0)
    return table, state, rep, sums, valid


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam", "set"])
def test_host_apply_rows_inplace_matches_jax(kind):
    table, state, rep, sums, valid = _apply_case(kind)
    ours = (table.copy(), tuple(np.copy(s) if np.ndim(s) else s
                                for s in state))
    ref = (table.copy(), tuple(np.copy(s) if np.ndim(s) else s
                               for s in state))
    hp = {"adagrad": {"eps": 1e-7}, "adam": {"b1": 0.8, "eps": 1e-6}}.get(
        kind, {})
    sparse_update.host_apply_rows_inplace(kind, *ours, rep, sums, valid,
                                          0.05, **hp)
    jax_sparse.host_apply_rows_inplace(kind, *ref, rep, sums, valid, 0.05,
                                       **hp)
    np.testing.assert_array_equal(ours[0], ref[0])
    for a, b in zip(ours[1], ref[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    moved = np.unique(rep[valid > 0])
    untouched = np.setdiff1d(np.arange(table.shape[0]), moved)
    np.testing.assert_array_equal(ours[0][untouched], table[untouched])


def test_host_apply_rows_inplace_refusals():
    table, state, rep, sums, valid = _apply_case("adagrad")
    with pytest.raises(TypeError, match="float32"):
        sparse_update.host_apply_rows_inplace(
            "sgd", table.astype(np.float64), (), rep, sums, valid, 0.1)
    with pytest.raises(ValueError, match="C-contiguous"):
        sparse_update.host_apply_rows_inplace(
            "adagrad", table, (np.asfortranarray(state[0]),), rep, sums,
            valid, 0.1)
    with pytest.raises(NotImplementedError, match="host-memory"):
        sparse_update.host_apply_rows_inplace("rmsprop", table, (), rep,
                                              sums, valid, 0.1)


def test_prepare_safe_grad_matches_jax():
    rng = np.random.RandomState(2)
    ids = rng.randint(-3, 40, size=(64,)).astype(np.int32)
    contribs = rng.randn(64, 5).astype(np.float32)
    rep, sums, valid = sparse_update.prepare_safe_grad(
        torch.from_numpy(ids), torch.from_numpy(contribs), 32)
    j_rep, j_sums, j_valid = jax_sparse.prepare_safe_grad(
        jnp.asarray(ids), jnp.asarray(contribs), 32)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(rep.numpy(), np.asarray(j_rep))
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums), rtol=1e-6,
                               atol=1e-6)
    assert rep.dtype == torch.int32 and valid.dtype == torch.float32


# ------------------------------------------------- quantized offload
class _ApplyTap:
    """Records each quantized host apply's inputs (the bucket's payload,
    scales and state before it, the pending rows) and the bucket after."""

    def __init__(self, layer):
        self.layer, self.calls = layer, []
        self.real = layer._host_quantized_apply

    def __call__(self, b, arrays, rep, sums, valid, opt, kw):
        layer = self.layer
        sd = layer._bucket_store_dtype(b)

        def payload():
            t = layer.tp[b].data
            return (t.view(torch.uint8) if sd == "fp8" else t).numpy().copy()
        call = {"b": b, "sd": sd, "payload": payload(),
                "scale": layer.tp_scale[b].data.numpy().copy(),
                "state": [np.copy(x) if np.ndim(x) else x for x in arrays],
                "rep": rep.copy(), "sums": sums.copy(),
                "valid": valid.copy(), "kind": opt.kind, "lr": opt.lr,
                "kw": dict(kw)}
        self.real(b, arrays, rep, sums, valid, opt, kw)
        call.update(payload_after=payload(),
                    scale_after=layer.tp_scale[b].data.numpy().copy(),
                    state_after=[np.copy(x) if np.ndim(x) else x
                                 for x in arrays])
        self.calls.append(call)


def _twin_apply(call):
    """The JAX package's numpy functions on a recorded call's inputs: the
    touched rows decoded, the host rule, the stochastic re-encode."""
    sd = call["sd"]
    payload, scale = call["payload"].copy(), call["scale"].copy()
    state = [np.copy(x) if np.ndim(x) else x for x in call["state"]]
    ok = call["valid"] > 0
    ru = call["rep"][ok].astype(np.int64)
    raw = payload.view(np.uint8) if sd == "fp8" else payload
    sub = np.ascontiguousarray(jax_wire.decode_rows_np(raw[ru], scale[ru],
                                                       sd))
    tables = [x for x in state if np.ndim(x) >= 1]
    subs = [np.ascontiguousarray(x[ru]) for x in tables]
    st = (subs[0], subs[1], state[2]) if call["kind"] == "adam" \
        else tuple(subs)
    jax_sparse.host_apply_rows_inplace(
        call["kind"], sub, st, np.arange(len(ru)),
        np.ascontiguousarray(call["sums"][ok]), np.ones(len(ru), np.float32),
        call["lr"], **call["kw"])
    for x, s in zip(tables, subs):
        x[ru] = s
    pay, scl = jax_wire.encode_rows_np(sub, sd, sr=True)
    raw[ru] = np.asarray(pay).view(raw.dtype)
    scale[ru] = scl
    return payload, scale, state


@pytest.mark.parametrize("store,optimizer", [("int8", "sgd"),
                                             ("int8", "adagrad"),
                                             ("fp8", "adagrad"),
                                             ("fp8", "sgd")])
def test_quantized_offload_matches_numpy_twins(store, optimizer):
    """Offloaded buckets stored quantized: the forward decodes the
    gathered rows on the host (the twin: `decode_rows_np` of the rows,
    then the combine); each step's host apply, recorded, is bit for bit
    the JAX package's numpy twins on the same inputs; the losses track
    the quantized all-device model's."""
    model = _Tiny(storage_dtype=store)
    emb = model.embedding
    assert emb.offloaded_buckets and set(emb.offloaded_buckets) <= set(
        emb.quantized_buckets)
    emb.set_weights(_weights())
    batches = _batches(seed=13)
    cats = batches[0][0]
    got = emb(cats)
    for pl_ in emb.plan.tp_placements:
        if pl_.bucket not in emb.offloaded_buckets:
            continue
        i = emb.strategy.table_groups[1][pl_.table_id]
        ids = np.asarray(cats[i]) + pl_.row_offset
        raw = emb.tp[pl_.bucket].data
        raw = (raw.view(torch.uint8) if store == "fp8" else raw).numpy()
        rows = jax_wire.decode_rows_np(
            raw[ids], emb.tp_scale[pl_.bucket].data.numpy()[ids], store)
        np.testing.assert_array_equal(got[i].numpy(), rows.sum(axis=1),
                                      err_msg=f"input {i}")
    tap = _ApplyTap(emb)
    emb._host_quantized_apply = tap
    init_fn, step_fn = pt_training.make_sparse_train_step(
        model, optimizer, lr=LR, strategy="sort")
    state = init_fn(model)
    losses = []
    for cats, labels in batches:
        _, state, loss = step_fn(model, state, np.zeros((BATCH, 1)), cats,
                                 labels)
        losses.append(float(loss))
    assert len(tap.calls) == STEPS * len(emb.offloaded_buckets)
    for n, call in enumerate(tap.calls):
        payload, scale, st = _twin_apply(call)
        np.testing.assert_array_equal(call["payload_after"], payload,
                                      err_msg=f"apply {n} payload")
        np.testing.assert_array_equal(call["scale_after"], scale,
                                      err_msg=f"apply {n} scale")
        for a, b in zip(call["state_after"], st):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"apply {n} state")
    if optimizer != "adam":
        dev = _Tiny(offload=False, storage_dtype=store)
        dev.embedding.set_weights(_weights())
        init_fn, step_fn = pt_training.make_sparse_train_step(
            dev, optimizer, lr=LR, strategy="sort")
        d_state = init_fn(dev)
        cats, labels = batches[0]
        _, _, loss = step_fn(dev, d_state, np.zeros((BATCH, 1)), cats,
                             labels)
        assert float(loss) == losses[0]


# ---------------------------------------------------------------- W = 2
W2 = 2


def _w2_case():
    """The spec the ranks run (the tables, the budget, the weights, the
    head, a forward batch and three global batches) and the JAX package's
    results on a 2-device mesh."""
    mesh = create_mesh(jax.devices()[:W2])
    weights = _weights(seed=21)
    rng = np.random.RandomState(22)
    inputs = [rng.randint(0, v, size=(BATCH, 2)) for v, _, _ in SPECS]
    batches = [(np.zeros((BATCH, 1), np.float32), cats, labels)
               for cats, labels in _batches(seed=23)]
    model = TinyModel(SPECS, mesh, gpu_embedding_size=BUDGET)
    emb = model.embedding
    assert emb._offload_enabled
    params = {"embedding": emb.set_weights(weights),
              "head": {"w": jnp.asarray(_head())}}
    outputs = [np.asarray(o) for o in emb.apply(
        params["embedding"], [jnp.asarray(x) for x in inputs])]
    init_fn, step_fn = jax_training.make_sparse_train_step(
        model, "adagrad", lr=LR, strategy="sort")
    state = init_fn(params)
    losses = []
    for num, cats, labels in batches:
        params, state, loss = step_fn(params, state, jnp.asarray(num),
                                      [jnp.asarray(c) for c in cats],
                                      jnp.asarray(labels))
        losses.append(float(loss))
    spec = {"tables": SPECS, "budget": BUDGET, "weights": weights,
            "head": _head(), "inputs": inputs, "batches": batches, "lr": LR}
    ref = {"outputs": outputs, "losses": losses,
           "weights": emb.get_weights(params["embedding"]),
           "offloaded": [[b for b, bk in enumerate(emb.plan.tp_buckets)
                          if bk.offload]] * W2}
    return spec, ref


@pytest.fixture(scope="module")
def w2_run(tmp_path_factory):
    from test_torch_multigpu import _spawn
    spec, ref = _w2_case()
    ranks = _spawn(W2, {"offload": ("offload", spec)},
                   tmp_path_factory.mktemp("offload_w2"))
    return [r["offload"] for r in ranks], ref, [r["jax_loaded"]
                                               for r in ranks]


def test_offload_world2_matches_jax(w2_run):
    """Each rank's offloaded buckets live on its host and are looked up
    and applied there; the activation exchange is the device buckets'.
    Each rank's forward slice at rtol 1e-5 / atol 1e-5, the losses at rtol
    1e-5, the global tables after three adagrad steps at rtol 2e-5 / atol
    2e-5, against the JAX package on a 2-device mesh."""
    ranks, ref, jax_loaded = w2_run
    assert not any(jax_loaded)
    blocal = BATCH // W2
    for r, res in enumerate(ranks):
        assert res["offloaded"] == ref["offloaded"][r]
        assert res["offloaded"] and all(res["on_host"])
        for i, (a, b) in enumerate(zip(res["outputs"], ref["outputs"])):
            np.testing.assert_allclose(
                a, b[r * blocal:(r + 1) * blocal],
                err_msg=f"rank {r} output {i}", **FWD_TOL)
        np.testing.assert_allclose(res["losses"], ref["losses"], **LOSS_TOL)
        _assert_tables(res["weights"], ref["weights"], f"rank {r}:")
