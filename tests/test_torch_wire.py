"""The exchange wire formats in the port against the JAX package's.

The encoders bit for bit on the same arrays (`encode_fwd`, `encode_bwd`
at every wire, `stochastic_round_bf16` with its flat-position hash,
`encode_ids` / `decode_ids` with clipped values), NaN (of either sign),
infinities, -0, negative values, values at the edge of bfloat16's range
and subnormals among them; the byte model and the plan's wire choice.
Then one spawn of gloo ranks a world, W = 2 and W = 4, on the CPU (the
ranks run `tests/torch_multigpu_worker.py` and import no jax; the JAX
package runs here, in `shard_map` on ``jax.devices()[:W]``):

* every wired collective (all_to_all, tiled all_gather, tiled
  reduce-scatter) at bf16 and bf16-sr, its forward and the gradient
  autograd gives bit-equal to the JAX package's value and gradient, the
  explicit transposes and the int16 id collectives too (the compressed
  reduce-scatter adds the W decoded blocks in rank order; XLA on the CPU
  reduces them in the same order here, so no tolerance is needed);
* at W = 2, hot rows over the bf16 and the bf16-sr wire: three adagrad
  steps of a model whose loss is linear in the outputs (the JAX package's
  keys admitted before the second) against the JAX package's hot step
  on the mesh, at the bars of tests/test_hotrows.py (losses rtol 1e-5 /
  atol 1e-6, tables, hot rows and their state rtol 1e-4 / atol 1e-5);
  the losses' bar widened by one bfloat16 rounding of each term (2^-8 of
  the sum of the terms' magnitudes): an output the two packages compute
  an f32 rounding apart can round to neighbouring bfloat16 values on the
  wire. The output gradients are the same bits in both packages, so the
  gradient wire, stochastic rounding included, rounds them alike. Every
  float payload is bfloat16, every int16 bucket's ids cross as 2 bytes
  an id; and ``sync_hot_rows(admit=True)`` admits rank 0's top keys on
  every rank.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from distributed_embeddings_tpu import compat  # noqa: E402
from distributed_embeddings_tpu import training as jax_training  # noqa: E402
from distributed_embeddings_tpu.ops import wire as jax_wire  # noqa: E402
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu_torch.ops import wire  # noqa: E402

from test_torch_hotrows import (BATCH, HOT, LOSS_TOL, LR, SPECS,  # noqa: E402
                                TABLE_TOL, _JaxModel, _batches, _jax_cats,
                                _layer, _weights)
from test_torch_multigpu import _spawn  # noqa: E402

WORLDS = (2, 4)
WIRES = ("bf16", "bf16-sr")
# one bfloat16 rounding of a term, relative to it
BF16_TERM = 2.0 ** -8
HOT_WIRE_STEPS = 3
HOT_WIRE_ADMIT = 1


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    return x.view(np.uint32)


def _values(rng, shape):
    """float32 values across 40 binades, both signs, with NaN of either
    sign, infinities, -0, +0, values at bfloat16's overflow edge and a
    subnormal at the front."""
    x = (rng.randn(*shape) * 2.0 ** rng.randint(-20, 20, size=shape)
         ).astype(np.float32)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0,
                        3.3895313e38, -3.3895313e38, 3.39e38, 1e-41],
                       np.float32)
    flat = x.reshape(-1)
    flat[:min(len(special), flat.size)] = special[:flat.size]
    return x


# ------------------------------------------------------------- encoders
@pytest.mark.parametrize("shape", [(7,), (3, 17, 5), (2, 4, 6, 8)])
@pytest.mark.parametrize("name", ["fwd", "bwd"])
@pytest.mark.parametrize("fmt", ["f32", "bf16", "bf16-sr"])
def test_encoders_bit_equal_jax(fmt, name, shape):
    x = _values(np.random.RandomState(len(shape)), shape)
    enc = {"fwd": (wire.encode_fwd, jax_wire.encode_fwd),
           "bwd": (wire.encode_bwd, jax_wire.encode_bwd)}[name]
    got = enc[0](torch.from_numpy(x), fmt)
    want = np.asarray(enc[1](jnp.asarray(x), fmt))
    if fmt == "f32":
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        return
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("salt", [None, 12345])
def test_stochastic_round_bf16_bit_equal_jax(salt):
    """The keyless hash reads each element's flat position in the block,
    so equal blocks give equal draws; rounding lands on a neighbour."""
    x = _values(np.random.RandomState(9), (4, 33, 9))
    kw = {} if salt is None else {"salt": salt}
    got = wire.stochastic_round_bf16(torch.from_numpy(x), **kw)
    want = np.asarray(jax_wire.stochastic_round_bf16(jnp.asarray(x), **kw))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    # a 16-bit input takes the plain cast, as in the JAX package
    with np.errstate(over="ignore"):
        half = x.astype(np.float16)
    got = wire.stochastic_round_bf16(torch.from_numpy(half), **kw)
    want = np.asarray(jax_wire.stochastic_round_bf16(jnp.asarray(half),
                                                     **kw))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_keyless_uniform_shares_the_hash():
    """The row codec's draw and the wire's rounding read one hash."""
    y = torch.from_numpy(_values(np.random.RandomState(4), (6, 7)))
    h = wire._keyless_hash(y, wire.SR_SALT)
    assert torch.equal(wire.keyless_uniform(y),
                       (h & 0xFFFF).to(torch.float32) / 65536.0)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_id_encoders_bit_equal_jax(dtype):
    ids = np.array([[-70000, -32769, -32768, -5, 0, 100, 16000, 32766,
                     32767, 32768, 40000]], dtype)
    got = wire.encode_ids(torch.from_numpy(ids), "int16")
    want = np.asarray(jax_wire.encode_ids(jnp.asarray(ids), "int16"))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    back = wire.decode_ids(got, "int16", torch.from_numpy(ids).dtype)
    assert back.dtype == torch.from_numpy(ids).dtype
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_wire.decode_ids(jnp.asarray(want),
                                                     "int16")))
    t = torch.from_numpy(ids)
    assert wire.encode_ids(t, "int32") is t
    assert wire.decode_ids(t, "int32") is t
    for v in (-1, 0, 32765, 32766, 32767, 40000):
        assert wire.int16_id_wire_ok(v) == jax_wire.int16_id_wire_ok(v)


def test_byte_model_and_formats_match_jax():
    assert wire.WIRE_FORMATS == jax_wire.WIRE_FORMATS
    assert wire.ID_WIRE_FORMATS == jax_wire.ID_WIRE_FORMATS
    assert wire.INT16_ID_MAX == jax_wire.INT16_ID_MAX
    for name in (None, "", "f32", "bf16", "bf16-sr"):
        assert wire.resolve_wire(name) == jax_wire.resolve_wire(name)
        assert wire.wire_itemsize(name) == jax_wire.wire_itemsize(name)
    for name in ("int32", "int16"):
        assert wire.id_wire_itemsize(name) == jax_wire.id_wire_itemsize(name)
    with pytest.raises(ValueError):
        wire.resolve_wire("fp8")


@pytest.mark.parametrize("fmt", ["bf16", "bf16-sr"])
def test_layer_plans_the_wire(fmt):
    """A compressed wire on every combined bucket and row table; the
    passthrough (combiner None) bucket keeps float32, as in the JAX
    package; small buckets' ids go int16."""
    layer = _layer([(96, 8, "sum"), (50, 8, None), (100, 8, "mean")],
                   exchange_wire=fmt)
    by_comb = {b.combiner: b.wire_dtype for b in layer.plan.tp_buckets}
    assert by_comb == {"sum": fmt, None: "f32", "mean": fmt}
    assert all(b.id_wire_dtype == "int16" for b in layer.plan.tp_buckets)


# ------------------------------------------------- the spawns (W = 2, 4)
def _shard_map(mesh, fn):
    return compat.shard_map(fn, mesh=mesh, in_specs=(P("mp"),),
                            out_specs=P("mp"), check_vma=False)


def _wire_case(world):
    """The collectives' inputs per rank and the JAX package's outputs and
    gradients on the mesh."""
    mesh = create_mesh(jax.devices()[:world])
    rng = np.random.RandomState(40 + world)
    n, w = 3, 5
    shapes = {"all_to_all": ((world, n, w), (world, n, w)),
              "all_gather": ((n, w), (world * n, w)),
              "psum_scatter": ((world * n, w), (n, w))}
    spec, ref = {"wires": WIRES}, {}
    for name, (xs, ys) in shapes.items():
        x = (rng.randn(world, *xs) * 2.0 ** rng.randint(
            -8, 8, size=(world,) + xs)).astype(np.float32)
        c = rng.randn(world, *ys).astype(np.float32)
        spec[name] = {"x": x, "c": c}
        for fmt in WIRES:
            op = {"all_to_all": lambda v, f=fmt: jax_wire.wire_all_to_all(
                      v, "mp", f),
                  "all_gather": lambda v, f=fmt: jax_wire.wire_all_gather(
                      v, "mp", f, world),
                  "psum_scatter": lambda v, f=fmt: jax_wire.wire_psum_scatter(
                      v, "mp", f, world)}[name]

            def loss(xg, cg, op=op):
                out = _shard_map(mesh, op)(xg)
                return jnp.sum(out * cg), out
            (_, out), g = jax.value_and_grad(loss, has_aux=True)(
                jnp.asarray(x.reshape((-1,) + xs[1:])),
                jnp.asarray(c.reshape((-1,) + ys[1:])))
            ref[(fmt, name)] = (np.asarray(out).reshape((world,) + ys),
                                np.asarray(g).reshape((world,) + xs))
    for name, fn in (("all_to_all_t", jax_wire.wire_all_to_all_t),
                     ("psum_scatter_t", jax_wire.wire_psum_scatter_t)):
        shape = (world, n, w) if name == "all_to_all_t" else (n, w)
        g = rng.randn(world, *shape).astype(np.float32)
        spec[name] = g
        for fmt in WIRES:
            args = (() if name == "all_to_all_t" else (world,))
            out = _shard_map(mesh, lambda v, f=fmt, fn=fn: fn(
                v, "mp", f, *args))(jnp.asarray(g.reshape((-1,) + shape[1:])))
            ref[(fmt, name)] = np.asarray(out).reshape((world, -1, w))
    ids = rng.randint(-40000, 40000, size=(world, world, 4, 2)).astype(
        np.int32)
    ids[:, :, 0, 0] = [-70000, 32767] * (world // 2)
    spec["ids_a2a"] = ids
    ref["id_all_to_all"] = np.asarray(_shard_map(
        mesh, lambda v: jax_wire.wire_id_all_to_all(v, "mp", "int16"))(
        jnp.asarray(ids.reshape(-1, 4, 2)))).reshape(world, world, 4, 2)
    ids_ag = ids[:, 0]
    spec["ids_ag"] = ids_ag
    ref["id_all_gather"] = np.asarray(_shard_map(
        mesh, lambda v: jax_wire.wire_id_all_gather(v, "mp", "int16"))(
        jnp.asarray(ids_ag.reshape(-1, 2)))).reshape(world, world * 4, 2)
    return spec, ref


class _JaxLinear:
    """The JAX side of the worker's `_Linear`: the mean over the batch of
    the outputs times fixed coefficients. Its output gradients are the
    coefficients over the (power-of-two) batch in both packages, the same
    bits, so the wire rounds the same gradients the same way, and
    stochastic rounding, which hashes each value's bits, draws alike."""

    def __init__(self, layer, coefs):
        self.embedding, self.coefs = layer, coefs

    def loss_fn(self, params, numerical, cats, labels, taps=None,
                return_residuals=False):
        outs, res = self.embedding.apply(params["embedding"], cats,
                                         taps=taps, return_residuals=True)
        loss = sum(jnp.sum(o * c) for o, c in zip(outs, self.coefs)) / BATCH
        return (loss, res) if return_residuals else loss


def _hot_wire_case(fmt):
    """At W = 2: the JAX package's hot step over the `fmt` wire on the
    mesh, adagrad, with the keys its tracker (the global batch) admits
    before step `HOT_WIRE_ADMIT`."""
    mesh = create_mesh(jax.devices()[:2])
    kw = dict(hot_rows=HOT, exchange_wire=fmt)
    rng = np.random.RandomState(33)
    coefs = [rng.randn(BATCH, w).astype(np.float32) for _, w, _ in SPECS]
    model = _JaxLinear(_JaxModel(mesh=mesh, **kw).embedding, coefs)
    emb = model.embedding
    params = {"embedding": emb.set_weights(_weights())}
    init_fn, step_fn = jax_training.make_sparse_train_step(model, "adagrad",
                                                           lr=LR)
    state = init_fn(params)
    batches = [c for c, _ in _batches(False, None, seed=31)]
    losses, keys = [], None
    for s, cats in enumerate(batches[:HOT_WIRE_STEPS]):
        emb.observe_hot_ids(_jax_cats(cats))
        if s == HOT_WIRE_ADMIT:
            keys = {b: tr.top_keys() for b, tr in emb._hot_trackers.items()}
            p, st = emb.sync_hot_rows(params["embedding"], state["emb"],
                                      new_keys=keys)
            params, state = {**params, "embedding": p}, {**state, "emb": st}
        params, state, loss = step_fn(params, state, jnp.zeros((BATCH, 1)),
                                      _jax_cats(cats), jnp.zeros((BATCH,)))
        losses.append(float(loss))
    spec = {"tables": SPECS, "kw": kw, "weights": _weights(),
            "optimizer": "adagrad", "lr": LR, "coefs": coefs,
            "batches": batches[:HOT_WIRE_STEPS], "admit_at": HOT_WIRE_ADMIT,
            "keys": keys}
    ref = {"losses": losses,
           "weights": emb.get_weights(params["embedding"]),
           "hot": {b: (np.asarray(params["embedding"]["hot"][b]["ids"]),
                       np.asarray(params["embedding"]["hot"][b]["rows"]))
                   for b in emb._hot_buckets},
           "hot_state": [[np.asarray(x) for x in entry
                          if getattr(x, "ndim", 0) == 2]
                         for entry in state["emb"]["hot"]],
           "wires": [(b.wire_dtype, b.id_wire_dtype)
                     for b in emb.plan.tp_buckets]}
    return spec, ref


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    """world -> (each rank's results, the JAX package's), one spawn a
    world for the module."""
    runs = {}

    def get(world):
        if world not in runs:
            spec, ref = _wire_case(world)
            cases = {"parity": ("wire_parity", spec)}
            refs = {"parity": ref}
            if world == 2:
                for fmt in WIRES:
                    spec, refs[f"hot:{fmt}"] = _hot_wire_case(fmt)
                    cases[f"hot:{fmt}"] = ("hot_wire", spec)
            ranks = _spawn(world, cases,
                           tmp_path_factory.mktemp(f"wire{world}"))
            runs[world] = (ranks, refs)
        return runs[world]
    return get


@pytest.mark.parametrize("fmt", WIRES)
@pytest.mark.parametrize("name", ["all_to_all", "all_gather",
                                  "psum_scatter"])
@pytest.mark.parametrize("world", WORLDS)
def test_wired_collective_matches_jax(world_run, world, name, fmt):
    ranks, refs = world_run(world)
    want_y, want_g = refs["parity"][(fmt, name)]
    for r, res in enumerate(ranks):
        y, g = res["parity"][(fmt, name)]
        assert y.dtype == g.dtype == np.float32
        np.testing.assert_array_equal(_bits(y), _bits(want_y[r]),
                                      err_msg=f"rank {r} forward")
        np.testing.assert_array_equal(_bits(g), _bits(want_g[r]),
                                      err_msg=f"rank {r} gradient")


@pytest.mark.parametrize("fmt", WIRES)
@pytest.mark.parametrize("name", ["all_to_all_t", "psum_scatter_t"])
@pytest.mark.parametrize("world", WORLDS)
def test_explicit_transposes_match_jax(world_run, world, name, fmt):
    ranks, refs = world_run(world)
    for r, res in enumerate(ranks):
        got = res["parity"][(fmt, name)]
        np.testing.assert_array_equal(
            _bits(got.reshape(refs["parity"][(fmt, name)][r].shape)),
            _bits(refs["parity"][(fmt, name)][r]), err_msg=f"rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_int16_id_collectives_match_jax(world_run, world):
    """The ids cross as their bytes and come back clipped, as in the JAX
    package's int16 wire."""
    ranks, refs = world_run(world)
    for r, res in enumerate(ranks):
        for name in ("id_all_to_all", "id_all_gather"):
            got = res["parity"][name]
            assert got.dtype == np.int32
            np.testing.assert_array_equal(
                got.reshape(refs["parity"][name][r].shape),
                refs["parity"][name][r], err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("fmt", WIRES)
def test_hot_rows_over_the_wire_match_jax(world_run, fmt):
    ranks, refs = world_run(2)
    ref = refs[f"hot:{fmt}"]
    for r, res in enumerate(ranks):
        got = res[f"hot:{fmt}"]
        # one bfloat16 rounding of an output moves the loss by 2^-8 of its
        # term: the ranks' sum of the terms' magnitudes
        loss_bar = LOSS_TOL["atol"] + BF16_TERM * np.asarray(
            got["loss_scales"])
        assert got["wires"] == ref["wires"]
        assert all(w == fmt for w, _ in got["wires"])
        err = np.abs(np.asarray(got["losses"]) - ref["losses"])
        assert (err <= loss_bar + LOSS_TOL["rtol"] * np.abs(
            ref["losses"])).all(), (got["losses"], ref["losses"])
        for t, (a, b) in enumerate(zip(got["weights"], ref["weights"])):
            np.testing.assert_allclose(a, b, err_msg=f"rank {r} table {t}",
                                       **TABLE_TOL)
        for b, (ids, rows) in ref["hot"].items():
            np.testing.assert_array_equal(got["hot"][b][0], ids)
            np.testing.assert_allclose(got["hot"][b][1], rows,
                                       err_msg=f"rank {r} hot rows {b}",
                                       **TABLE_TOL)
        for i, (a_l, b_l) in enumerate(zip(got["hot_state"],
                                           ref["hot_state"])):
            for a, b in zip(a_l, b_l):
                np.testing.assert_allclose(a, b, err_msg=f"hot state {i}",
                                           **TABLE_TOL)


@pytest.mark.parametrize("fmt", WIRES)
def test_hot_wire_payloads(world_run, fmt):
    """Every float payload of a step is bfloat16, and each exchange
    group's id block crosses at the plan's id wire: an int16 bucket's as
    2 bytes an id (``uint8``, twice the ids), half the int32 block."""
    ranks, _ = world_run(2)
    for res in ranks:
        got = res[f"hot:{fmt}"]
        want = [("torch.uint8", 2 * n) if id_wire == "int16"
                else ("torch.int32", 4 * n) for id_wire, n in got["id_blocks"]]
        assert any(id_wire == "int16" for id_wire, _ in got["id_blocks"])
        for step in got["payloads"]:
            floats = {d for _, d, _ in step if "float" in d}
            assert floats == {"torch.bfloat16"}, step
            ids = [(d, nb) for n, d, nb in step
                   if n == "all_to_all_single" and "float" not in d]
            assert ids == want, (ids, want)


def test_hot_admission_takes_rank_zeros_keys(world_run):
    """``sync_hot_rows(admit=True)`` at W = 2: every rank admits rank 0's
    top keys (each rank observed its own slice), sorted and padded with
    the sentinel."""
    ranks, _ = world_run(2)
    for fmt in WIRES:
        zero = ranks[0][f"hot:{fmt}"]
        for res in ranks:
            got = res[f"hot:{fmt}"]
            for b, ids in got["admitted"].items():
                np.testing.assert_array_equal(ids, zero["admitted"][b])
                keys = np.sort(zero["top_keys"][b])
                np.testing.assert_array_equal(ids[:len(keys)], keys)
        assert any(not np.array_equal(ranks[0][f"hot:{fmt}"]["top_keys"][b],
                                      ranks[1][f"hot:{fmt}"]["top_keys"][b])
                   for b in zero["top_keys"])
