"""The sorted-stream train steps and sort folding against the JAX package.

Two paths, three steps each, weights carried across from the JAX package
with `convert.params_from_jax` and the same numpy-seeded batches in both;
``DET_LOOKUP_PATH`` is set on the JAX side only (the port takes
``lookup_path=``):

* cut-down Tiny V3 (tables at most 1,000 rows; widths, hotness and sharing
  as published), ``lookup_path="fused"`` with the ``pallas`` strategy and
  adagrad, against the JAX package's fused + pallas step: losses within
  rtol 1e-5, tables, state and MLPs within rtol 1e-4 / atol 1e-6;
* the criteo shape cut down (26 tables of 300 rows, width 16 instead of
  128, the published MLP), ``lookup_path="tiled"`` with the ``tiled``
  strategy, against the JAX tiled + tiled step at rtol 1e-4 / atol 1e-5:
  sgd and adagrad over three steps; adam on the tables step by step from
  the JAX step's state, its elements whose gradient is a sum that cancels
  held to 1e-2 * lr (`test_torch_training._check_adam_steps`' rule), with
  sgd on the MLP: adam's MLP step does not scale with the gradient, and at
  this shape some MLP gradients that the rule calls well-conditioned
  differ by 1e-4 of their terms' magnitude between XLA's and PyTorch's CPU
  BLAS (the JAX package's further from a float64 reference), which moves
  them by 1e-3 * lr. Dense adam is held against JAX on Tiny in
  `test_torch_training`.

Then ``fold_sort`` on and off give bit-identical tables and losses, with
the sorts per step counted under the profiler.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import optax  # noqa: E402

from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu_torch import convert  # noqa: E402
from distributed_embeddings_tpu_torch import training as pt_training  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402
from distributed_embeddings_tpu_torch.ops import cuda_lookup, cuda_tiled  # noqa: E402

from test_torch_training import (_assert_adam_step_close,  # noqa: E402
                                 _jax_dense_state, _leaf)

LOSS_TOL = dict(rtol=1e-5, atol=0)
BATCH = 64
STEPS = 3
LR = 0.01


def _cut(name):
    cfg = jax_synth.SYNTHETIC_MODELS[name]
    if name == "tiny":
        return cfg._replace(embedding_configs=[
            e._replace(num_rows=min(e.num_rows, 1000))
            for e in cfg.embedding_configs])
    return cfg._replace(embedding_configs=[
        e._replace(num_rows=300, width=16) for e in cfg.embedding_configs])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(name, lookup_path):
    cfg = _cut(name)
    jm = jax_synth.SyntheticModel(cfg)
    params = jm.init(jax.random.PRNGKey(3))
    pm = pt_synth.SyntheticModel(cfg, device="cpu", lookup_path=lookup_path)
    pm.load_state_dict(convert.params_from_jax(_np(params), pm))
    gen = pt_synth.InputGenerator(cfg, BATCH, alpha=1.05, num_batches=STEPS,
                                  seed=1)
    batches = [(n.numpy(), [c.numpy() for c in cs], lab.numpy())
               for n, cs, lab in gen]
    return jm, params, pm, batches


def _torch_batch(batch):
    num, cats, labels = batch
    return (torch.from_numpy(num), [torch.from_numpy(c) for c in cats],
            torch.from_numpy(labels))


def _close_tree(got, want, tol, path=""):
    if isinstance(want, dict):
        for key in want:
            _close_tree(got[key], want[key], tol, f"{path}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, tol, f"{path}/{i}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **tol)


# name -> (model, lookup path, strategy, optimizer, tolerance)
CASES = {
    "tiny-fused-pallas-adagrad": ("tiny", "fused", "pallas", "adagrad",
                                  dict(rtol=1e-4, atol=1e-6)),
    "criteo-tiled-tiled-sgd": ("criteo", "tiled", "tiled", "sgd",
                               dict(rtol=1e-4, atol=1e-5)),
    "criteo-tiled-tiled-adagrad": ("criteo", "tiled", "tiled", "adagrad",
                                   dict(rtol=1e-4, atol=1e-5)),
    "criteo-tiled-tiled-adam": ("criteo", "tiled", "tiled", "adam",
                                dict(rtol=1e-4, atol=1e-5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_stream_steps_match_jax(case, monkeypatch):
    name, path, strategy, optimizer, tol = CASES[case]
    monkeypatch.setenv("DET_LOOKUP_PATH", path)
    jm, params, pm, batches = _models(name, path)
    dense = ((optax.sgd(LR), pt_training.sgd(LR)) if optimizer == "adam"
             else (None, None))
    j_init, j_step = jax_training.make_sparse_train_step(
        jm, optimizer, lr=LR, strategy=strategy, dense_optimizer=dense[0])
    _, p_step = pt_training.make_sparse_train_step(
        pm, optimizer, lr=LR, strategy=strategy, dense_optimizer=dense[1])
    j_state = j_init(params)
    p_state = convert.opt_state_from_jax(_np(j_state), pm)
    for batch in batches:
        if optimizer == "adam":
            # each step from the JAX step's state (see _check_adam_steps)
            pm.load_state_dict(convert.params_from_jax(_np(params), pm))
            p_state = convert.opt_state_from_jax(_np(j_state), pm)
            scale = pt_training.gradient_scale(pm, *_torch_batch(batch))
        params, j_state, j_loss = j_step(
            params, j_state, *[jnp.asarray(batch[0]),
                               [jnp.asarray(c) for c in batch[1]],
                               jnp.asarray(batch[2])])
        pm, p_state, p_loss = p_step(pm, p_state, *_torch_batch(batch))
        np.testing.assert_allclose(float(p_loss), float(j_loss), **LOSS_TOL)
        if optimizer == "adam":
            got, want = convert.params_to_numpy(pm), _np(params)
            for pname, (g, t) in scale.items():
                if pname.startswith("embedding"):
                    _assert_adam_step_close(_leaf(got, pname),
                                            _leaf(want, pname), g.numpy(),
                                            t.numpy(), LR, pname)
            _close_tree(got["mlp"], want["mlp"], tol)
    if optimizer != "adam":
        _close_tree(convert.params_to_numpy(pm), _np(params), tol)
    p_np = convert.opt_state_to_numpy(p_state, pm)
    _close_tree(p_np["emb"], _np(j_state)["emb"], tol)
    _close_tree(p_np["dense"], _jax_dense_state(_np(j_state)["dense"]), tol)


def _top_level_sorts(prof) -> int:
    return sum(1 for e in prof.events() if e.name == "aten::sort"
               and (e.cpu_parent is None or e.cpu_parent.name != "aten::sort"))


# name -> (lookup path, strategy, optimizer, sorts per step folded, unfolded)
FOLD_CASES = {
    "tiny-fused-pallas-adagrad": ("tiny", "fused", "pallas", "adagrad", 6, 6),
    # cut Tiny's buckets are small: "auto" takes the dense strategy for
    # both, whose update wants no sort, so the step sorts nothing
    "tiny-auto-auto-adagrad": ("tiny", "auto", "auto", "adagrad", 0, 0),
    "criteo-tiled-tiled-sgd": ("criteo", "tiled", "tiled", "sgd", 1, 2),
    "criteo-fused-tiled-adam": ("criteo", "fused", "tiled", "adam", 1, 2),
    "criteo-auto-sort-adagrad": ("criteo", "auto", "sort", "adagrad", 1, 1),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_sort_is_bit_identical(case):
    """fold_sort on and off: the same losses, tables and state bit for
    bit, and the sorts per step counted under the profiler (Tiny's buckets
    hold two exchange groups each, so only a sorted lookup folds there;
    criteo's one group folds a sorted lookup's and its update's sorts into
    one, and with the gather-combine lookup the one sort moves into the
    forward)."""
    name, path, strategy, optimizer, folded, unfolded = FOLD_CASES[case]
    cfg = _cut(name)
    runs = []
    for fold in (True, False):
        pm = pt_synth.SyntheticModel(cfg, device="cpu", lookup_path=path)
        init, step = pt_training.make_sparse_train_step(
            pm, optimizer, lr=LR, strategy=strategy, fold_sort=fold)
        state = init(pm)
        losses, sorts = [], []
        for batch in pt_synth.InputGenerator(cfg, BATCH, alpha=1.05,
                                             num_batches=2, seed=4):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                _, state, loss = step(pm, state, *batch)
            losses.append(float(loss))
            sorts.append(_top_level_sorts(prof))
        runs.append((losses, pm.state_dict(), state, sorts))
    (l1, d1, s1, n1), (l2, d2, s2, n2) = runs
    assert n1 == [folded] * 2 and n2 == [unfolded] * 2
    assert l1 == l2
    for key in d1:
        assert torch.equal(d1[key], d2[key]), key
    for a, b in zip(s1["emb"]["tp"], s2["emb"]["tp"]):
        for x, y in zip(a, b):
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y


def test_sorted_paths_launch_no_kernel_on_the_cpu():
    """On CPU tensors the sorted-stream wrappers take their plain
    versions."""
    pm = pt_synth.SyntheticModel(_cut("criteo"), device="cpu",
                                 lookup_path="tiled")
    init, step = pt_training.make_sparse_train_step(pm, "adagrad",
                                                    strategy="tiled")
    before = dict(cuda_tiled.launches), dict(cuda_lookup.launches)
    num, cats, labels = pt_synth.InputGenerator(_cut("criteo"), 16,
                                                num_batches=1)[0]
    step(pm, init(pm), num, cats, labels)
    assert (dict(cuda_tiled.launches), cuda_lookup.launches) == before


def test_lookup_path_is_checked_and_reaches_the_layer():
    for path in ("xla", "pallas", "tiled", "fused"):
        pm = pt_synth.SyntheticModel(_cut("criteo"), device="cpu",
                                     lookup_path=path)
        assert pm.embedding.lookup_path == path
    with pytest.raises(ValueError, match="lookup_path"):
        pt_synth.SyntheticModel(_cut("criteo"), device="cpu",
                                lookup_path="onehot")


def test_fit_trains_through_the_layer_path():
    """`fit` on a fused-path model equals the step loop on it."""
    cfg = _cut("tiny")
    batches = list(pt_synth.InputGenerator(cfg, BATCH, alpha=1.05,
                                           num_batches=2, seed=0))
    models = [pt_synth.SyntheticModel(cfg, device="cpu", lookup_path="fused")
              for _ in range(2)]
    _, _, hist = pt_training.fit(models[0], batches, 2, "adagrad", lr=LR,
                                 log_every=0)
    init, step = pt_training.make_sparse_train_step(models[1], "adagrad",
                                                    lr=LR)
    state, losses = init(models[1]), []
    for batch in batches:
        _, state, loss = step(models[1], state, *batch)
        losses.append(float(loss))
    assert hist["loss"] == losses
    for a, b in zip(models[0].state_dict().values(),
                    models[1].state_dict().values()):
        assert torch.equal(a, b)
