"""The port's sparse train step and `fit` against the JAX package's.

Cut-down Tiny V3 (tables at most 1,000 rows; widths, hotness and sharing as
published) and a small DLRM, batch 64, weights carried across from the JAX
package with `convert.params_from_jax`, the same numpy-seeded batches in
both. The JAX step runs its ``sort`` strategy, which the JAX package pins
bit-exact to its fused Pallas strategy. Three steps each: losses within
rtol 1e-5; tables, optimizer state and MLPs within rtol 1e-4 / atol 1e-6
(the MLPs run through different CPU BLAS libraries, and XLA and PyTorch
round rsqrt differently in the last place). Adam is compared step by step
from the same state, see `_assert_adam_step_close`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.models import dlrm as jax_dlrm  # noqa: E402
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu_torch import convert  # noqa: E402
from distributed_embeddings_tpu_torch import training as pt_training  # noqa: E402
from distributed_embeddings_tpu_torch.models import dlrm as pt_dlrm  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402
from distributed_embeddings_tpu_torch.ops import cuda_lookup, cuda_sparse  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=0)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
# a gradient below this share of the sum of its terms' magnitudes is a sum
# that cancels (`training.gradient_scale`)
ILL_SCALE = 1e-3
BATCH = 64
STEPS = 3
LR = 0.01


def _cut(cfg):
    return cfg._replace(embedding_configs=[
        e._replace(num_rows=min(e.num_rows, 1000))
        for e in cfg.embedding_configs])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tiny():
    jm = jax_synth.SyntheticModel(_cut(jax_synth.SYNTHETIC_MODELS["tiny"]))
    params = jm.init(jax.random.PRNGKey(0))
    pm = pt_synth.SyntheticModel(_cut(pt_synth.SYNTHETIC_MODELS["tiny"]),
                                 device="cpu")
    pm.load_state_dict(convert.params_from_jax(_np(params), pm))
    gen = pt_synth.InputGenerator(_cut(pt_synth.SYNTHETIC_MODELS["tiny"]),
                                  BATCH, alpha=1.05, num_batches=STEPS,
                                  seed=0)
    batches = [(n.numpy(), [c.numpy() for c in cs], lab.numpy())
               for n, cs, lab in gen]
    return jm, params, pm, batches


def _dlrm():
    sizes = [40, 7, 300, 25, 1000]
    kw = dict(embedding_dim=16, bottom_mlp_dims=(32, 16),
              top_mlp_dims=(32, 1), num_numerical_features=5)
    jm = jax_dlrm.DLRM(sizes, **kw)
    params = jm.init(jax.random.PRNGKey(5))
    pm = pt_dlrm.DLRM(sizes, device="cpu", **kw)
    pm.load_state_dict(convert.params_from_jax(_np(params), pm))
    rng = np.random.RandomState(14)
    batches = []
    for _ in range(STEPS):
        num = rng.rand(BATCH, 5).astype(np.float32)
        # some ids repeat across the batch, so rows aggregate
        cats = [rng.randint(0, min(v, 30), size=BATCH).astype(np.int32)
                for v in sizes]
        labels = rng.randint(0, 2, size=(BATCH, 1)).astype(np.float32)
        batches.append((num, cats, labels))
    return jm, params, pm, batches


def _assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        for key in want:
            _assert_tree_close(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, f"{path}/{i}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **STATE_TOL)


def _jax_dense_state(state) -> dict:
    """The JAX optax chain state as the port's field dict."""
    out = {}
    for part in state:
        fields = getattr(part, "_fields", ())
        for field in ("sum_of_squares", "mu", "nu"):
            if field in fields:
                out[field] = getattr(part, field)
        if "count" in fields:
            key = "count" if "mu" in fields else "schedule_count"
            out[key] = int(part.count)
    return out


def _run_both(build, optimizer, jax_lr, port_lr):
    jm, params, pm, batches = build()
    j_init, j_step = jax_training.make_sparse_train_step(
        jm, optimizer, lr=jax_lr, strategy="sort")
    p_init, p_step = pt_training.make_sparse_train_step(
        pm, optimizer, lr=port_lr, strategy="sort")
    j_state, p_state = j_init(params), p_init(pm)
    j_losses, p_losses = [], []
    for num, cats, labels in batches:
        params, j_state, loss = j_step(
            params, j_state, jnp.asarray(num), [jnp.asarray(c) for c in cats],
            jnp.asarray(labels))
        j_losses.append(float(loss))
        pm, p_state, loss = p_step(pm, p_state, torch.from_numpy(num),
                                   [torch.from_numpy(c) for c in cats],
                                   torch.from_numpy(labels))
        p_losses.append(float(loss))
    return (_np(params), _np(j_state), j_losses, pm, p_state, p_losses)


# name -> (model builder, optimizer, JAX lr, port lr)
CASES = {
    "tiny-sgd": (_tiny, "sgd", LR, LR),
    "tiny-adagrad": (_tiny, "adagrad", LR, LR),
    "tiny-adam": (_tiny, "adam", LR, LR),
    "tiny-adagrad-schedule": (_tiny, "adagrad",
                              jax_dlrm.make_lr_schedule(0.05, 2, 2, 4),
                              pt_dlrm.make_lr_schedule(0.05, 2, 2, 4)),
    "dlrm-adagrad": (_dlrm, "adagrad", LR, LR),
}


def _leaf(tree, name):
    """A trained array of a params tree by the port's parameter name."""
    parts = name.split(".")
    if parts[0] == "embedding":
        return np.asarray(tree["embedding"]["tp"][int(parts[2])])[0]
    return np.asarray(tree[parts[0]][int(parts[1])][parts[2]])


def _assert_adam_step_close(got, want, g, scale, lr, name):
    """One adam step from the same state on both sides. Adam moves an
    element by lr * m_hat / (sqrt(v_hat) + eps), which does not scale with
    g: where g is a float32 sum that cancels (|g| < ILL_SCALE * scale,
    `scale` the sum of its terms' magnitudes) its low digits, which the
    summation order sets (XLA's and PyTorch's CPU BLAS differ), move the
    element by a share of lr. Those elements are held to 1e-2 * lr; every
    other element to STATE_TOL."""
    ill = (scale > 0) & (np.abs(g) < ILL_SCALE * scale)
    np.testing.assert_allclose(got[~ill], want[~ill], err_msg=name,
                               **STATE_TOL)
    err = np.where(ill, np.abs(got - want), 0.0)
    worst = np.unravel_index(np.argmax(err), err.shape)
    assert err[worst] <= 1e-2 * lr, (
        f"{name}{list(worst)}: off by {err[worst] / lr:.3g} lr with g "
        f"{g[worst]:.3e} from terms of total magnitude {scale[worst]:.3e}")


def _check_adam_steps(build, lr):
    """Adam, each step from the JAX step's state (differences of one step
    are not carried into the next, where they would move the gradients of
    well-conditioned elements too)."""
    jm, params, pm, batches = build()
    j_init, j_step = jax_training.make_sparse_train_step(jm, "adam", lr=lr,
                                                         strategy="sort")
    _, p_step = pt_training.make_sparse_train_step(pm, "adam", lr=lr,
                                                   strategy="sort")
    j_state = j_init(params)
    for num, cats, labels in batches:
        pm.load_state_dict(convert.params_from_jax(_np(params), pm))
        p_state = convert.opt_state_from_jax(_np(j_state), pm)
        p_batch = (torch.from_numpy(num), [torch.from_numpy(c) for c in cats],
                   torch.from_numpy(labels))
        scale = pt_training.gradient_scale(pm, *p_batch)
        params, j_state, j_loss = j_step(
            params, j_state, jnp.asarray(num), [jnp.asarray(c) for c in cats],
            jnp.asarray(labels))
        pm, p_state, p_loss = p_step(pm, p_state, *p_batch)
        np.testing.assert_allclose(float(p_loss), float(j_loss), **LOSS_TOL)
        got, want = convert.params_to_numpy(pm), _np(params)
        assert len(scale) == len(list(pm.parameters()))
        for name, (g, t) in scale.items():
            _assert_adam_step_close(_leaf(got, name), _leaf(want, name),
                                    g.numpy(), t.numpy(), lr, name)
        p_np = convert.opt_state_to_numpy(p_state, pm)
        _assert_tree_close(p_np["emb"], _np(j_state)["emb"])
        _assert_tree_close(p_np["dense"],
                           _jax_dense_state(_np(j_state)["dense"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(case):
    build, optimizer, _, port_lr = CASES[case]
    if optimizer == "adam":
        _check_adam_steps(build, port_lr)
        return
    j_params, j_state, j_losses, pm, p_state, p_losses = _run_both(
        *CASES[case])
    np.testing.assert_allclose(p_losses, j_losses, **LOSS_TOL)
    _assert_tree_close(convert.params_to_numpy(pm), j_params)
    p_np = convert.opt_state_to_numpy(p_state, pm)
    _assert_tree_close(p_np["emb"], j_state["emb"])
    _assert_tree_close(p_np["dense"], _jax_dense_state(j_state["dense"]))
    if "count" in j_state:
        assert p_np["count"] == int(j_state["count"]) == STEPS


def test_gradient_scale_bounds_each_gradient():
    """`gradient_scale` returns the step's own gradients, and the sum of
    the terms' magnitudes is never below the magnitude of their sum."""
    _, _, pm, batches = _tiny()
    num, cats, labels = (torch.from_numpy(batches[0][0]),
                         [torch.from_numpy(c) for c in batches[0][1]],
                         torch.from_numpy(batches[0][2]))
    scale = pt_training.gradient_scale(pm, num, cats, labels)
    loss = pm.loss_fn(num, cats, labels)
    dense = {n: p for n, p in pm.named_parameters() if p.requires_grad}
    for name, g in zip(dense, torch.autograd.grad(loss, list(dense.values()))):
        assert torch.equal(scale[name][0], g), name
    rows = 0
    for name, (g, t) in scale.items():
        assert g.shape == t.shape == dict(pm.named_parameters())[name].shape
        assert bool((g.abs() <= t * (1 + 1e-5) + 1e-30).all()), name
        if name.startswith("embedding"):
            rows += int((t.amax(1) > 0).sum())
    assert rows > 0


def test_lr_schedule_matches_jax():
    """Bit-equal to the JAX schedule run eagerly (a jitted JAX step may
    rewrite its divisions by constants as reciprocal products)."""
    for args in [(0.01, 7, 20, 13), (24.0, 8000, 48000, 24000, 2),
                 (0.3, 3, 3, 5, 3)]:
        want = jax_dlrm.make_lr_schedule(*args)
        got = pt_dlrm.make_lr_schedule(*args)
        for step in list(range(60)) + list(range(7990, 72100, 977)):
            assert np.float32(got(step)) == np.float32(want(step)), (args,
                                                                     step)


def test_opt_state_round_trips_through_jax_layout():
    jm, params, pm, batches = _tiny()
    j_init, _ = jax_training.make_sparse_train_step(jm, "adam", lr=LR,
                                                    strategy="sort")
    j_state = _np(j_init(params))
    state = convert.opt_state_from_jax(j_state, pm)
    assert [len(e) for e in state["emb"]["tp"]] == [3, 3]
    back = convert.opt_state_to_numpy(state, pm)
    _assert_tree_close(back["emb"], j_state["emb"])
    _assert_tree_close(back["dense"], _jax_dense_state(j_state["dense"]))


def test_cpu_step_launches_no_kernel():
    """On CPU tensors every kernel wrapper takes its plain version."""
    _, _, pm, batches = _tiny()
    init, step = pt_training.make_sparse_train_step(pm, "adagrad")
    before = dict(cuda_sparse.launches), dict(cuda_lookup.launches)
    num, cats, labels = batches[0]
    step(pm, init(pm), num, cats, labels)
    assert (dict(cuda_sparse.launches), cuda_lookup.launches) == before


def test_fit_matches_the_step_loop():
    _, _, pm, batches = _tiny()
    ref = pt_synth.SyntheticModel(_cut(pt_synth.SYNTHETIC_MODELS["tiny"]),
                                  device="cpu")
    ref.load_state_dict(pm.state_dict())
    logged = []
    model, state, hist = pt_training.fit(pm, batches, STEPS, "adagrad",
                                         lr=LR, log_every=2,
                                         log_fn=logged.append)
    init, step = pt_training.make_sparse_train_step(ref, "adagrad", lr=LR)
    ref_state = init(ref)
    losses = []
    for num, cats, labels in batches:
        _, ref_state, loss = step(ref, ref_state, num, cats, labels)
        losses.append(float(loss))
    assert model is pm and hist["loss"] == losses
    assert len(logged) == 2
    for a, b in zip(pm.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(a, b)


def test_fit_takes_a_callable_and_callbacks():
    _, _, pm, batches = _tiny()
    seen = []

    class Cb:
        def on_train_begin(self, model):
            seen.append("begin")

        def on_step(self, step, model, loss):
            seen.append(step)

    _, _, hist = pt_training.fit(pm, lambda s: batches[s], 2, "sgd",
                                 log_every=0, callbacks=[Cb()])
    assert seen == ["begin", 0, 1] and len(hist["loss"]) == 2
