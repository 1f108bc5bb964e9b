"""The port's Criteo on-the-fly vocabulary flow
(`tools/criteo_example.py`) against examples/criteo/main.py: its
synthetic key stream bit for bit; 3 adam steps (CPU, 3 features,
max_tokens 64, width 8, MLP 16-1, batch 64) against a JAX step built as
the example builds it (main.py:164-191) from the same weights, the keys
translated by each package's IntegerLookup; the pipelined run equal to
the serial one."""

import importlib.util
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.layers.embedding import (
    Embedding as JaxEmbedding, IntegerLookup as JaxIntegerLookup)
from distributed_embeddings_tpu.models.dlrm import _mlp_apply, _mlp_init
from distributed_embeddings_tpu_torch.native import loader
from distributed_embeddings_tpu_torch.tools import criteo_example

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CAT, N_NUM, MAX_TOKENS, DIM, MLP, BATCH, LR = 3, 13, 64, 8, [16, 1], 64, 1e-3
STEPS = 3
LOSS_TOL = dict(rtol=1e-5, atol=0.0)


def _example():
    spec = importlib.util.spec_from_file_location(
        "criteo_main", os.path.join(REPO, "examples", "criteo", "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(seed=0, n=STEPS):
    return list(itertools.islice(criteo_example.synthetic_batches(
        BATCH, N_NUM, N_CAT, seed), n))


def test_synthetic_batches_match_the_example():
    """The zipf keys times 2654435761, int64 wrap included, bit for bit."""
    ours = itertools.islice(criteo_example.synthetic_batches(
        4096, 13, 26, 0), 3)
    ref = itertools.islice(_example().synthetic_batches(4096, 13, 26, 0), 3)
    wrapped = False
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        wrapped |= bool((a[1] < 0).any())
    assert wrapped                      # some products wrap past int64


def test_args_match_the_example():
    """The example's flags and defaults; --device defaults to the card,
    and --force_cpu is --device cpu."""
    ours = vars(criteo_example.parse_args([]))
    ref = vars(_example().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ref.pop("force_cpu") is False
    assert ours == ref
    assert criteo_example.parse_args(["--force_cpu"]).device == "cpu"
    assert criteo_example.parse_args(["--device", "cpu"]).device == "cpu"


def _jax_flow(seed=0):
    """The example's parameters and jitted adam step, at the test's
    sizes."""
    tables = [JaxEmbedding(MAX_TOKENS + 1, DIM) for _ in range(N_CAT)]
    keys = jax.random.split(jax.random.PRNGKey(seed), N_CAT + 1)
    params = {"tables": [t.init(k) for t, k in zip(tables, keys[:-1])],
              "mlp": _mlp_init(keys[-1], MLP, N_NUM + N_CAT * DIM)}

    def loss_fn(p, numerical, idx, labels):
        embs = [tables[i](p["tables"][i], idx[:, i]) for i in range(N_CAT)]
        x = jnp.concatenate([numerical] + embs, axis=1)
        logits = _mlp_apply(p["mlp"], x)[:, 0]
        y = labels.reshape(-1)
        return jnp.mean(jnp.maximum(logits, 0) - logits * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))

    opt = optax.adam(LR)

    @jax.jit
    def step(p, s, numerical, idx, labels):
        loss, g = jax.value_and_grad(loss_fn)(p, numerical, idx, labels)
        updates, s = opt.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, updates), s, loss
    return params, opt.init(params), step


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("use_native", [True, False])
def test_adam_steps_match_the_jax_example(use_native):
    params, opt_state, jstep = _jax_flow()
    model = criteo_example.CriteoModel(N_CAT, MAX_TOKENS, DIM, MLP, N_NUM,
                                       device="cpu")
    model.params_from_numpy(_np_tree(params))
    opt, step = criteo_example.make_step(LR)
    state = opt.init(dict(model.named_parameters()))
    ours = criteo_example.make_lookups(N_CAT, MAX_TOKENS, use_native)
    ref = [JaxIntegerLookup(MAX_TOKENS, use_native=use_native)
           for _ in range(N_CAT)]
    translate = criteo_example.lookup_stage(ours)
    before = loader.calls["integer_lookup"]
    for numerical, raw, labels in _batches():
        _, idx, _ = translate((numerical, raw, labels))
        want_idx = np.stack([ref[j](raw[:, j]) for j in range(N_CAT)],
                            axis=1).astype(np.int32)
        assert idx.dtype == np.int32
        np.testing.assert_array_equal(idx, want_idx)
        params, opt_state, jloss = jstep(params, opt_state, numerical,
                                         want_idx, labels)
        model, state, loss = step(model, state, torch.from_numpy(numerical),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    assert (loader.calls["integer_lookup"] - before
            == (STEPS * N_CAT if use_native else 0))
    for a, b in zip(ours, ref):
        assert a.get_vocabulary() == b.get_vocabulary()
        np.testing.assert_array_equal(a.counts(), b.counts())
    want = _np_tree(params)
    for i, t in enumerate(want["tables"]):
        np.testing.assert_allclose(
            model.tables[i].embeddings.detach().numpy(), t["embeddings"],
            rtol=1e-4, atol=1e-6)
    for i, layer in enumerate(want["mlp"]):
        np.testing.assert_allclose(model.mlp[i].w.detach().numpy(),
                                   layer["w"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(model.mlp[i].b.detach().numpy(),
                                   layer["b"], rtol=1e-4, atol=1e-6)
    assert not any(p.requires_grad for p in (t.embeddings
                                             for t in model.tables))


def test_pipelined_equals_serial():
    """`train` through the ingest pipeline and inline: the same losses,
    vocabularies and tables bit for bit, each from the same weights."""
    runs = []
    for serial in (False, True):
        model = criteo_example.CriteoModel(N_CAT, MAX_TOKENS, DIM, MLP, N_NUM,
                                           device="cpu", seed=4)
        lookups = criteo_example.make_lookups(N_CAT, MAX_TOKENS)
        out = criteo_example.train(
            model, lookups, criteo_example.synthetic_batches(
                BATCH, N_NUM, N_CAT, 1), 6, lr=LR, serial=serial,
            log_every=0)
        assert set(out["stage_ms"]) == {"read", "lookup", "stage"}
        assert len(out["losses"]) == 6
        runs.append((out, {k: v.clone() for k, v in
                           model.state_dict().items()}))
    (a, ma), (b, mb) = runs
    assert a["losses"] == b["losses"]
    assert a["vocab"] == b["vocab"]
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_main_runs_on_the_cpu(capsys):
    out = criteo_example.main(
        ["--synthetic", "--steps", "2", "--force_cpu", "--batch_size", "32",
         "--num_categorical", "2", "--max_tokens", "50", "--embedding_dim",
         "4", "--mlp", "8,1"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "samples/sec" in capsys.readouterr().out
    rec = criteo_example.bench_lookup(4096, 1024, 10_000, 26,
                                      log_fn=lambda m: None)
    assert rec["native_keys_per_sec"] > 0 and rec["numpy_keys_per_sec"] > 0
    assert rec["native_vocab_after"] == rec["numpy_vocab_after"]
