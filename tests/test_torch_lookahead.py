"""The port's lookahead pipeline (`schedule.LookaheadEngine`, `fit(
lookahead=, stale_ok=)`) at world size 1, against its own sequential step
and against the JAX package's engine.

tests/test_schedule.py's model (4 tables, widths 8 and 16, sum and mean,
a linear head, batch 16 at hotness 2; one input weighted) and batches
made from a seed with numpy:

* ``lookahead=1`` bit-equal to ``lookahead=0`` (`make_sparse_train_step`)
  over 5 steps of sgd, adagrad and adam: every loss, table, optimizer
  state and the head; the patch ran (the tables are small, so most
  prefetched samples go stale);
* the patch overflow's fallback, `reset` and a cold restart, ``stale_ok``
  (finite losses, no patch), ``lookahead=0`` delegating, a carry that is
  not the batch's;
* `fit(lookahead=1)` against `fit(lookahead=0)`, bit for bit;
* the port's ``lookahead=1`` against the JAX `LookaheadEngine` on a
  1-device mesh with the default strategy (sgd, adagrad): losses rtol
  1e-5, tables and head rtol 1e-4 / atol 1e-6 (tests/test_torch_training
  's bars);
* the seams: `prefetch_stale_mask` against the JAX layer's, a patched
  carry equal to a fresh prefetch, `DoubleBufferSlots`;
* each refusal the JAX engine makes at world 1, with its reason (hot rows,
  host offload, quantized storage, ragged input, a depth past 1, fit's
  hot and vocabulary cycles and dense path); the dp-table refusals and
  the multi-process one ride `tests/test_torch_multigpu.py`'s spawns,
  against the JAX engine's reasons on a mesh here.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu.schedule import (  # noqa: E402
    LookaheadEngine as JaxLookaheadEngine)
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.ops.embedding_ops import RaggedIds  # noqa: E402
from distributed_embeddings_tpu_torch.parallel.staging import (  # noqa: E402
    DoubleBufferSlots)
from distributed_embeddings_tpu_torch.schedule import LookaheadEngine  # noqa: E402
from distributed_embeddings_tpu_torch.training import (  # noqa: E402
    fit, make_sparse_train_step)

from test_schedule import TinyModel as JaxTinyModel  # noqa: E402
from test_torch_training import LOSS_TOL, STATE_TOL  # noqa: E402

BATCH = 16
K = 2
SPECS = [(60, 8, "sum"), (40, 8, "sum"), (500, 16, "mean"), (120, 8, "sum")]
WEIGHTED = 2          # this input comes as (ids, weights)
LR = 0.05
STEPS = 5


class TinyModel(torch.nn.Module):
    """tests/test_schedule.py's model: the embeddings, concatenated,
    through a linear head; the loss the mean squared error."""

    def __init__(self, specs=SPECS, seed=0, **kw):
        super().__init__()
        self.embedding = DistributedEmbedding(
            [Embedding(v, w, combiner=c, device="meta") for v, w, c in specs],
            device="cpu", **kw)
        w, head = _weights(specs, seed)
        self.embedding.set_weights(w)
        self.head = torch.nn.Parameter(torch.from_numpy(head))

    def loss_fn(self, numerical, cats, labels, taps=None,
                return_residuals=False):
        out = self.embedding(list(cats), taps=taps,
                             return_residuals=return_residuals)
        outs, res = out if return_residuals else (out, None)
        x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], 1).float()
        loss = torch.mean(((x @ self.head)[:, 0]
                           - torch.as_tensor(labels).reshape(-1)) ** 2)
        return (loss, res) if return_residuals else loss


def _weights(specs=SPECS, seed=0):
    rng = np.random.RandomState(seed)
    w = [rng.randn(v, d).astype(np.float32) * 0.1 for v, d, _ in specs]
    head = rng.randn(sum(d for _, d, _ in specs), 1).astype(np.float32)
    return w, head


def _batches(steps, specs=SPECS, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        cats = [rng.randint(0, v, size=(BATCH, K)).astype(np.int32)
                for v, _, _ in specs]
        cats[WEIGHTED] = (cats[WEIGHTED], rng.uniform(
            0.5, 1.5, size=(BATCH, K)).astype(np.float32))
        out.append((np.zeros((BATCH, 1), np.float32), cats,
                    rng.randn(BATCH).astype(np.float32)))
    return out


def _sequential(optimizer, batches, **kw):
    model = TinyModel(**kw)
    init, step = make_sparse_train_step(model, optimizer, lr=LR)
    state = init(model)
    losses = []
    for num, cats, labels in batches:
        _, state, loss = step(model, state, torch.from_numpy(num),
                              [tuple(map(torch.as_tensor, c))
                               if isinstance(c, tuple) else
                               torch.as_tensor(c) for c in cats],
                              torch.from_numpy(labels))
        losses.append(float(loss))
    return model, state, losses


def _ahead(optimizer, batches, reset_at=None, **engine_kw):
    model = TinyModel()
    eng = LookaheadEngine(model, optimizer, lr=LR, **engine_kw)
    eng.init()
    losses = []
    for i, b in enumerate(batches):
        if i == reset_at:
            eng.reset()
        losses.append(float(eng.step(
            b, batches[i + 1] if i + 1 < len(batches) else None)))
    return model, eng, losses


def _state_leaves(state) -> list:
    out = []
    if torch.is_tensor(state):
        return [state]
    if isinstance(state, dict):
        for k in sorted(state):
            out += _state_leaves(state[k])
    elif isinstance(state, (list, tuple)):
        for v in state:
            out += _state_leaves(v)
    return out


def _assert_same_run(a_model, a_state, b_model, b_state):
    for t, (x, y) in enumerate(zip(a_model.embedding.get_weights(),
                                   b_model.embedding.get_weights())):
        np.testing.assert_array_equal(x, y, err_msg=f"table {t}")
    assert torch.equal(a_model.head, b_model.head)
    la, lb = _state_leaves(a_state), _state_leaves(b_state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_lookahead_bit_equal_to_sequential(optimizer):
    batches = _batches(STEPS)
    model, state, want = _sequential(optimizer, batches)
    m2, eng, got = _ahead(optimizer, batches, patch_capacity=BATCH)
    assert got == want
    _assert_same_run(model, state, m2, eng.opt_state)
    assert eng.stats["patched_steps"] > 0
    assert eng.stats["cold_fills"] == 1 and eng.stats["steps"] == STEPS


def test_patch_overflow_reset_and_cold_restart():
    """A capacity below the stale set falls back to a fresh prefetch; a
    reset mid-run and a carry that is not the batch's cold-fill; all
    bit-equal to the sequential run."""
    batches = _batches(STEPS)
    model, state, want = _sequential("adagrad", batches)
    m2, eng, got = _ahead("adagrad", batches, patch_capacity=1)
    assert got == want and eng.stats["patch_overflows"] > 0
    _assert_same_run(model, state, m2, eng.opt_state)
    m3, eng, got = _ahead("adagrad", batches, reset_at=2)
    assert got == want and eng.stats["cold_fills"] == 2
    _assert_same_run(model, state, m3, eng.opt_state)
    # a copy of the prefetched batch is another batch: a fresh prefetch
    m4 = TinyModel()
    eng = LookaheadEngine(m4, "adagrad", lr=LR)
    eng.init()
    got = [float(eng.step(batches[0], batches[1])),
           float(eng.step(tuple(list(batches[1])), None))]
    assert got == want[:2] and eng.stats["cold_fills"] == 2


def test_stale_ok_and_depth_zero():
    batches = _batches(STEPS)
    _, _, want = _sequential("adagrad", batches)
    _, eng, got = _ahead("adagrad", batches, stale_ok=True)
    assert all(np.isfinite(got)) and eng.stats["patched_steps"] == 0
    assert max(abs(a - b) for a, b in zip(got, want)) < 1.0
    model, state, _ = _sequential("adagrad", batches)
    m2, eng, got = _ahead("adagrad", batches, lookahead=0)
    assert got == want and eng.stats["steps"] == 0
    _assert_same_run(model, state, m2, eng.opt_state)


def test_fit_lookahead_matches_sequential():
    batches = _batches(6, seed=3)
    runs = []
    for lookahead in (0, 1):
        model = TinyModel()
        _, state, hist = fit(model, list(batches), 6, "adagrad", lr=LR,
                             log_every=0, lookahead=lookahead)
        runs.append((model, state, hist))
    assert runs[0][2]["loss"] == runs[1][2]["loss"]
    _assert_same_run(runs[0][0], runs[0][1], runs[1][0], runs[1][1])
    st = runs[1][2]["lookahead_stats"]
    assert st["steps"] == 6 and st["cold_fills"] == 1
    assert "lookahead_stats" not in runs[0][2]


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_lookahead_matches_jax_engine(optimizer):
    """The port's ``lookahead=1`` against the JAX engine's on a 1-device
    mesh (its default strategy), from the same weights and batches."""
    batches = _batches(STEPS)
    mesh = create_mesh(jax.devices()[:1])
    jm = JaxTinyModel(mesh, specs=SPECS)
    w, head = _weights()
    params = {"embedding": jm.embedding.set_weights(w),
              "head": {"w": jnp.asarray(head)}}
    jeng = JaxLookaheadEngine(jm, optimizer, lr=LR, donate=False,
                              patch_capacity=BATCH)
    state = jeng.init(params)
    jb = [(jnp.asarray(n), [tuple(map(jnp.asarray, c))
                            if isinstance(c, tuple) else jnp.asarray(c)
                            for c in cats], jnp.asarray(lbl))
          for n, cats, lbl in batches]
    want = []
    for i, b in enumerate(jb):
        params, state, loss = jeng.step(params, state, b,
                                        jb[i + 1] if i + 1 < STEPS else None)
        want.append(float(loss))
    model, eng, got = _ahead(optimizer, batches, patch_capacity=BATCH)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for t, (a, b) in enumerate(zip(model.embedding.get_weights(),
                                   jm.embedding.get_weights(
                                       params["embedding"]))):
        np.testing.assert_allclose(a, b, err_msg=f"table {t}", **STATE_TOL)
    np.testing.assert_allclose(model.head.detach().numpy(),
                               np.asarray(params["head"]["w"]), **STATE_TOL)
    assert eng.stats["patched_steps"] == jeng.stats["patched_steps"]
    assert eng.stats["patched_samples"] == jeng.stats["patched_samples"]


def test_stale_mask_and_patch_match_a_fresh_prefetch():
    """`prefetch_stale_mask` equals the JAX layer's for the same ids and
    touched keys; a carry patched at its stale samples after an update
    equals a fresh prefetch on the updated tables bit for bit."""
    batches = _batches(2)
    model = TinyModel()
    emb = model.embedding
    jl = JaxDistributedEmbedding(
        [JaxEmbedding(v, d, combiner=c) for v, d, c in SPECS],
        mesh=create_mesh(jax.devices()[:1]))
    def jax_cats(cats):
        return [tuple(map(jnp.asarray, c)) if isinstance(c, tuple)
                else jnp.asarray(c) for c in cats]
    # the rows of two samples of the first batch: some samples of the
    # second read them
    first = [tuple(a[:2] for a in c) if isinstance(c, tuple) else c[:2]
             for c in batches[0][1]]
    mask = emb.prefetch_stale_mask(batches[1][1],
                                   emb.touched_row_keys(first))
    np.testing.assert_array_equal(mask, jl.prefetch_stale_mask(
        jax_cats(batches[1][1]), jl.touched_row_keys(jax_cats(first))))
    assert 0 < mask.sum() < BATCH
    eng = LookaheadEngine(model, "sgd", lr=LR)
    carry = eng._prefetch(eng._stager(batches[1]))
    with torch.no_grad():
        for t in emb.tp:
            t.mul_(1.5)
    fresh = eng._prefetch(eng._stager(batches[1]))
    emb.patch_staged_carry(carry["ex"], carry["res"], np.arange(BATCH))
    for a, b in zip(carry["ex"], fresh["ex"]):
        assert torch.equal(a, b)


def test_double_buffer_slots():
    slots = DoubleBufferSlots()
    assert slots.current is None and slots.take() is None
    assert slots.stage("a", tag=1) is None
    assert slots.stage("b", tag=2) is None
    assert (slots.current, slots.tag) == ("b", 2)
    assert slots.stage("c", tag=3) == "a"
    assert slots.take() == "c" and slots.current is None
    slots.clear()
    assert slots.stage("d") is None


# the JAX engine's refusals at world 1 and the port's: (the layer's
# arguments, the error, its reason)
REFUSALS = {
    "hot_rows": (dict(hot_rows=8), NotImplementedError, "hot-row"),
    "offload": (dict(gpu_embedding_size=2000), NotImplementedError,
                "host-offloaded"),
    "quantized": (dict(storage_dtype="int8"), NotImplementedError,
                  "quantized"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(name):
    kw, err, reason = REFUSALS[name]
    jm = JaxTinyModel(create_mesh(jax.devices()[:1]), specs=SPECS, **kw)
    with pytest.raises(err, match=reason):
        JaxLookaheadEngine(jm, "adagrad", lr=LR)
    with pytest.raises(err, match=reason):
        LookaheadEngine(TinyModel(**kw), "adagrad", lr=LR)


def test_step_and_fit_refusals():
    model = TinyModel()
    with pytest.raises(ValueError, match="lookahead=2"):
        LookaheadEngine(model, "adagrad", lookahead=2)
    eng = LookaheadEngine(model, "adagrad", lr=LR)
    eng.init()
    num, cats, labels = _batches(1)[0]
    ragged = RaggedIds(np.arange(BATCH * K, dtype=np.int32),
                       np.arange(0, BATCH * K + 1, K, dtype=np.int32))
    with pytest.raises(NotImplementedError, match="dense id inputs"):
        eng.step((num, [ragged] + cats[1:], labels))
    batches = _batches(2)

    class _FakeVocab:
        emb = model.embedding
    with pytest.raises(NotImplementedError, match="vocab_every"):
        fit(model, batches, 2, lookahead=1, vocab=_FakeVocab(),
            vocab_every=4, log_every=0)
    with pytest.raises(NotImplementedError, match="hot-row"):
        fit(model, batches, 2, lookahead=1, hot_sync_every=2, log_every=0)
    with pytest.raises(ValueError, match="sparse"):
        fit(model, batches, 2, lookahead=1, sparse=False, log_every=0)
    # the registry (A15a) is ported: the engine's counters land in it
    from distributed_embeddings_tpu_torch.obs import MetricRegistry
    reg = MetricRegistry()
    fit(model, batches, 2, lookahead=1, registry=reg, log_every=0)
    counters = reg.snapshot()["counters"]
    assert counters["lookahead/steps"] == counters["train/steps"] == 2
    assert counters["lookahead/cold_fills"] == 1


def test_jax_engine_refuses_dp_tables_alike():
    """The refusals that need dp tables, which a single rank never plans:
    the JAX engine's reasons on an 8-device mesh, which the port's ranks
    give (`tests/torch_multigpu_worker.py`'s ``raises``)."""
    from test_torch_multigpu import LOOKAHEAD_REFUSALS, _JaxScaled
    mesh = create_mesh(jax.devices()[:8])
    for name, (tables, kw, reason) in LOOKAHEAD_REFUSALS.items():
        jl = JaxDistributedEmbedding(
            [(_JaxScaled if scaled else JaxEmbedding)(v, d, combiner=c)
             for v, d, c, scaled in tables], mesh=mesh, **kw)
        with pytest.raises(Exception, match=reason):
            JaxLookaheadEngine(SimpleNamespace(embedding=jl), "adagrad",
                               lr=LR)
