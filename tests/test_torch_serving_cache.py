"""The port's hot-row cache and cached engine against the JAX package's.

tests/test_serving.py's tables (SPECS: one fused width-16 bucket whose two
5000-row tables pass the device BUDGET and go to the host) at world 1, the
JAX side on a one-device mesh, the same weights (numpy, from a seed) in
both packages:

* `miss_only_ids` and `masked_two_source_gather` equal to the JAX
  functions;
* `HotRowCache` fed the same key stream as the JAX cache: the same slot
  for every key, the same hits, misses, promotions and evictions after
  every admission, the slots holding the table's rows, the counters pruned
  to the same keys;
* the cached engine on zipf traffic (sum, mean and weighted multi-hot):
  every output bit-equal to the port's uncached host path and to the JAX
  cached engine (weighted: within rtol 1e-6 / atol 1e-7 of it, since XLA's
  CPU fuses each weight product into its add, where the port rounds the
  product first, as it does on the card), and `cache_stats` equal to the
  JAX engine's;
* a bucket of two exchange groups (hotness 1 and 3) under eviction: the
  cache admits once a request, before both groups' lookups, so a lane is
  never served another key's row (the JAX engine admits before each
  group's lookup and serves one wrong output on this request stream);
* the refresh contract: a sparse step makes the cached rows stale, and
  `refresh()` restores bit-equality;
* an int8 bucket through the decode seam: cached serving bit-equal to the
  port's uncached decode-at-gather path and to the JAX cached engine (its
  path is green on a one-device mesh), the slots bit-equal to the rows the
  JAX cache decodes for the same keys;
* at world size > 1: a rank fills, patches and refreshes only the slots
  of its own world slice's keys; the engine's `_group_keys` (every
  shard's keys, ``[world, B * f * k]``) against the JAX engine's on a
  2- and a 4-device mesh (the serving path across ranks runs in
  `tests/test_torch_multigpu.py`'s spawns); no new module importing jax.
"""

import ast
import os
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
from distributed_embeddings_tpu.ops import embedding_ops as jax_ops  # noqa: E402
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu.serving import (  # noqa: E402
    HotRowCache as JaxHotRowCache)
from distributed_embeddings_tpu.serving import (  # noqa: E402
    InferenceEngine as JaxEngine)
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry  # noqa: E402
from distributed_embeddings_tpu_torch.ops import embedding_ops  # noqa: E402
from distributed_embeddings_tpu_torch.parallel.plan import (  # noqa: E402
    lower_strategy)
from distributed_embeddings_tpu_torch.parallel.planner import (  # noqa: E402
    DistEmbeddingStrategy)
from distributed_embeddings_tpu_torch.serving import (  # noqa: E402
    HotRowCache, InferenceEngine)
from distributed_embeddings_tpu_torch.training import (  # noqa: E402
    make_sparse_train_step)

from test_serving import BUDGET, SPECS, _zipf  # noqa: E402

BATCH = 16
MEAN_SPECS = [(5000, 16, "mean"), (40, 16, "mean"), (5000, 16, "sum"),
              (64, 16, "mean"), (128, 16, "sum"), (96, 16, "mean"),
              (80, 16, "sum"), (72, 16, "mean")]
# the weighted sum against XLA's fused multiply-adds: one rounding of
# each of the k products apart
WEIGHTED_TOL = dict(rtol=1e-6, atol=1e-7)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ["serving/cache.py", "serving/engine.py", "serving/batcher.py",
               "serving/__init__.py", "fleet/__init__.py", "fleet/ring.py",
               "fleet/admission.py", "fleet/rollout.py", "fleet/router.py"]


def _layer(specs=SPECS, **kw):
    return DistributedEmbedding(
        [Embedding(v, w, combiner=c, device="meta") for v, w, c in specs],
        device="cpu", gpu_embedding_size=BUDGET, **kw)


def _jax_layer(specs=SPECS, **kw):
    return JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner=c) for v, w, c in specs],
        mesh=create_mesh(jax.devices()[:1]), gpu_embedding_size=BUDGET, **kw)


def _weights(specs=SPECS, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(v, w).astype(np.float32) * 0.1 for v, w, _ in specs]


def _pair(specs=SPECS, seed=1, **kw):
    """The port's layer and the JAX layer with its params, the same
    weights in both."""
    w = _weights(specs, seed)
    layer = _layer(specs, **kw)
    layer.set_weights(w)
    jl = _jax_layer(specs, **kw)
    return layer, jl, jl.set_weights(w)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _assert_bit_equal(got, want, what):
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(_bits(np.asarray(b)),
                                      _bits(np.asarray(a)),
                                      err_msg=f"{what}: output {i}")


# ------------------------------------------------------------ the gathers
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_source_gather_matches_jax(seed):
    rng = np.random.RandomState(seed)
    slots = rng.randn(6, 4).astype(np.float32)
    slot_idx = rng.randint(-2, 6, size=(3, 5)).astype(np.int32)
    fallback = rng.randn(3, 5, 4).astype(np.float32)
    ids = rng.randint(0, 1000, size=(3, 5)).astype(np.int64)
    got = embedding_ops.masked_two_source_gather(
        torch.from_numpy(slots), torch.from_numpy(slot_idx),
        torch.from_numpy(fallback))
    want = jax_ops.masked_two_source_gather(
        jnp.asarray(slots), jnp.asarray(slot_idx), jnp.asarray(fallback))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        embedding_ops.miss_only_ids(torch.from_numpy(ids),
                                    torch.from_numpy(slot_idx)).numpy(),
        np.asarray(jax_ops.miss_only_ids(jnp.asarray(ids),
                                         jnp.asarray(slot_idx))))


@pytest.mark.parametrize("k,weighted", [(1, False), (3, False), (4, True)])
def test_ordered_row_sum_adds_left_to_right(k, weighted):
    """The fixed order: each weight product rounded, then the terms added
    left to right, against a float32 numpy loop of the same order."""
    rng = np.random.RandomState(k)
    rows = (rng.randn(7, k, 5) * 10.0 ** rng.randint(-4, 4, (7, k, 1))
            ).astype(np.float32)
    w = rng.rand(7, k).astype(np.float32) if weighted else None
    got = embedding_ops.ordered_row_sum(
        torch.from_numpy(rows), None if w is None else torch.from_numpy(w))
    terms = [rows[:, j] if w is None else rows[:, j] * w[:, j, None]
             for j in range(k)]
    want = terms[0].copy()
    for t in terms[1:]:
        want = (want + t).astype(np.float32)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ------------------------------------------------------------ the policy
def test_cache_policy_matches_jax_key_for_key():
    """The same key stream through both caches: the same slot for every
    key after every admission (capacity-bound promotions, a strictly
    hotter newcomer evicting the coldest), the same stats, invalid lanes
    uncounted, and the slots holding the table's rows."""
    layer, jl, params = _pair()
    b = layer.offloaded_buckets[0]
    port = HotRowCache(layer, b, capacity=3, promote_threshold=2)
    ref = JaxHotRowCache(jl, b, capacity=3, promote_threshold=2)
    rng = np.random.RandomState(6)
    table = np.asarray(params["tp"][b])[0]
    for r in range(12):
        keys = rng.choice([10, 11, 12, 13, 99, 4000], size=5)
        if r == 8:
            keys = np.asarray([99] * 5)
        valid = rng.rand(5) > 0.2
        np.testing.assert_array_equal(
            port.lookup_slots(keys, valid), ref.lookup_slots(keys, valid))
        assert port.admit() == ref.admit(params["tp"][b])
        assert port._index == ref._index
        assert port.stats() == ref.stats()
        for key, slot in port._index.items():
            np.testing.assert_array_equal(port.slots[slot].numpy(),
                                          table[key])
    assert port.evictions > 0 and port.promotions > 3
    before = port.hits + port.misses
    out = port.lookup_slots(np.asarray([99, 99]),
                            valid=np.asarray([True, False]))
    assert out[1] == -1 and port.hits + port.misses == before + 1


@pytest.mark.parametrize("decay", [None, 0.9])
def test_tracker_eviction_matches_jax_under_churn(decay):
    """The port's tracker picks a full set's coldest slot from a heap; the
    JAX tracker scans every slot. On a churning zipf stream (evictions in
    most rounds, ties among equal counts) both plan the same (slot, key)
    pairs round for round and end with the same counters."""
    from distributed_embeddings_tpu.utils.hotness import (
        HotnessTracker as JaxTracker)
    from distributed_embeddings_tpu_torch.utils.hotness import HotnessTracker
    port = HotnessTracker(32, promote_threshold=2, max_tracked=512,
                          decay=decay)
    ref = JaxTracker(32, promote_threshold=2, max_tracked=512, decay=decay)
    rng = np.random.RandomState(3)
    for r in range(60):
        keys = (_zipf(rng, 400, 64, alpha=1.1).astype(np.int64)
                + 400 * (r // 20))               # the hot set drifts
        np.testing.assert_array_equal(port.lookup_slots(keys),
                                      ref.lookup_slots(keys))
        plan = port.plan_admissions()
        assert plan == ref.plan_admissions(), f"round {r}"
        assert port.commit_admissions(plan) == ref.commit_admissions(plan)
        assert port._index == ref._index
    assert port.evictions == ref.evictions > 20
    assert port.stats() == ref.stats()


def test_cache_counter_pruning_matches_jax():
    layer, jl, params = _pair()
    b = layer.offloaded_buckets[0]
    port = HotRowCache(layer, b, capacity=4, promote_threshold=1,
                       max_tracked=64)
    ref = JaxHotRowCache(jl, b, capacity=4, promote_threshold=1,
                         max_tracked=64)
    hot = np.asarray([1, 2, 3, 4], np.int64)
    for cache in (port, ref):
        for _ in range(5):
            cache.lookup_slots(hot)
    port.admit()
    ref.admit(params["tp"][b])
    rng = np.random.RandomState(0)
    for _ in range(40):
        keys = rng.randint(100, 3000, size=8).astype(np.int64)
        port.lookup_slots(keys)
        ref.lookup_slots(keys)
    assert len(port._counts) <= 64
    assert port._counts == ref._counts
    assert set(hot.tolist()) <= set(port._counts)


# ------------------------------------------------------- the cached engine
def _requests(rng, specs, steps, hotness, weighted):
    out = []
    for _ in range(steps):
        if hotness == 1:
            out.append([_zipf(rng, v, BATCH) for v, _, _ in specs])
        else:
            out.append([(_zipf(rng, v, BATCH * hotness).reshape(
                BATCH, hotness),
                np.abs(rng.rand(BATCH, hotness)).astype(np.float32))
                if weighted else
                _zipf(rng, v, BATCH * hotness).reshape(BATCH, hotness)
                for v, _, _ in specs])
    return out


@pytest.mark.parametrize("specs,hotness,weighted", [
    pytest.param(SPECS, 1, False, id="sum"),
    pytest.param(MEAN_SPECS, 3, False, id="mean-multihot"),
    pytest.param(MEAN_SPECS, 3, True, id="weighted-mean-multihot"),
])
def test_cached_engine_matches_uncached_and_jax(specs, hotness, weighted):
    """Zipf traffic through the cached engine: every output bit-equal to
    the port's uncached forward (the host path) and to the JAX cached
    engine's, and `cache_stats` equal to the JAX engine's."""
    layer, jl, params = _pair(specs)
    reg = MetricRegistry()
    eng = InferenceEngine(layer, device="cpu", cache_capacity=512,
                          promote_threshold=1, registry=reg)
    jeng = JaxEngine(jl, params, cache_capacity=512, promote_threshold=1)
    assert set(eng.caches) == set(jeng.caches) == set(
        layer.offloaded_buckets)
    assert reg.gauge("serve/cache_bypassed_buckets").value == 0
    rng = np.random.RandomState(2)
    for step, cats in enumerate(_requests(rng, specs, 6, hotness,
                                          weighted)):
        got = eng.predict(cats)
        with torch.no_grad():
            plain = layer(cats)
        _assert_bit_equal(got, plain, f"step {step}: the uncached forward")
        want = jeng.predict(cats)
        if not weighted:
            _assert_bit_equal(got, want, f"step {step}: the JAX cached engine")
            continue
        # XLA's CPU contracts the weighted sum into fused multiply-adds;
        # the port rounds each product (the order it holds on the card)
        for i, (a, b) in enumerate(zip(want, got)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       err_msg=f"step {step} output {i}",
                                       **WEIGHTED_TOL)
    stats = eng.cache_stats()
    assert stats == jeng.cache_stats()
    assert stats["hits"] > 0 and stats["buckets"][
        layer.offloaded_buckets[0]]["promotions"] > 0


def test_two_hotness_groups_of_one_bucket_admit_once():
    """A cached bucket whose inputs form two exchange groups (table 0
    one-hot, table 2 at hotness 3), one slot: the second request hits key
    X once in the first group while key W passes X's count there. The
    cache admits once a request, before both groups' lookups, so X's lane
    reads X's row; an admission before the second group's lookup (the
    JAX engine's order) would evict X for W and serve that lane W's row.
    Every output bit-equal to the uncached forward."""
    layer, _, _ = _pair()
    assert layer.offloaded_buckets == [0]
    eng = InferenceEngine(layer, device="cpu", cache_capacity=1,
                          promote_threshold=1)
    rng = np.random.RandomState(0)

    def request(x_lanes, w_lanes):
        cats = [rng.randint(0, v, BATCH).astype(np.int32)
                for v, _, _ in SPECS]
        cats[0] = np.asarray([5] * x_lanes + [7] * w_lanes, np.int32)
        cats[2] = rng.randint(100, 200, (BATCH, 3)).astype(np.int32)
        return cats
    for step, cats in enumerate((request(10, 6), request(1, 15),
                                 request(8, 8))):
        with torch.no_grad():
            want = layer(cats)
        _assert_bit_equal(eng.predict(cats), want, f"request {step}")
    cache = eng.caches[0]
    assert cache.evictions == 1 and cache.hits > 0
    assert list(cache._index) == [7]


def test_padding_rows_never_count():
    """A request padded to the warmed shape: its padding rows reach no
    counter (the same hits and misses as the JAX engine, and as many
    lookups as the request's true rows hold)."""
    layer, jl, params = _pair()
    eng = InferenceEngine(layer, device="cpu", cache_capacity=64,
                          promote_threshold=1)
    jeng = JaxEngine(jl, params, cache_capacity=64, promote_threshold=1)
    assert eng.warmup([BATCH]) == jeng.warmup([BATCH]) == [BATCH]
    assert eng.cache_stats()["hits"] + eng.cache_stats()["misses"] == 0
    rng = np.random.RandomState(4)
    for n in (5, 3, 11):
        cats = [_zipf(rng, v, n) for v, _, _ in SPECS]
        _assert_bit_equal(eng.predict(cats), jeng.predict(cats),
                          f"{n} rows")
    stats = eng.cache_stats()
    assert stats == jeng.cache_stats()
    assert stats["hits"] + stats["misses"] == 2 * (5 + 3 + 11)
    assert eng.rows_padded == 3 * BATCH - 19


class _Tiny(torch.nn.Module):
    """The JAX test's `TinyModel` in the port: the outputs concatenated,
    a linear head, the mean squared error."""

    def __init__(self, layer):
        super().__init__()
        self.embedding = layer
        self.w = torch.nn.Parameter(torch.from_numpy(
            np.random.RandomState(7).randn(
                sum(w for _, w, _ in SPECS), 1).astype(np.float32)))

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
        return torch.cat([o.reshape(o.shape[0], -1) for o in outs],
                         1) @ self.w


def test_refresh_restores_bit_equal_serving():
    """A sparse step mutates the offloaded bucket: the cached rows are
    stale until `refresh()`, after which serving is bit-equal to the
    forward on the new tables."""
    layer, _, _ = _pair()
    model = _Tiny(layer)
    eng = InferenceEngine(model, device="cpu", cache_capacity=1024,
                          promote_threshold=1)
    num = np.zeros((BATCH, 1), np.float32)
    hot = [np.tile(np.arange(4, dtype=np.int32), BATCH // 4) for _ in SPECS]
    for _ in range(3):
        eng.predict((num, hot))
    assert eng.cache_stats()["hits"] > 0
    init, step = make_sparse_train_step(model, "sgd", lr=0.5)
    state = init(model)
    labels = np.random.RandomState(3).randn(BATCH).astype(np.float32)
    step(model, state, torch.zeros((BATCH, 1)), hot, labels)
    with torch.no_grad():
        fresh = model(num, hot)
    stale = eng.predict((num, hot))
    assert not torch.equal(stale, fresh), \
        "the cached rows must be stale after the table changed"
    assert eng.refresh() > 0
    assert torch.equal(eng.predict((num, hot)), fresh)
    for cache in eng.caches.values():
        assert cache.refreshed_version == eng.store.version


def test_int8_bucket_serves_through_the_decode_seam():
    """An int8 offloaded bucket: the slots hold decoded float32 rows, bit
    for bit the rows the JAX cache reads for the same keys, and cached
    serving is bit-equal to the port's uncached decode-at-gather forward
    and to the JAX cached engine (green on a one-device mesh), with the
    same `cache_stats`."""
    layer, jl, params = _pair(storage_dtype="int8")
    jeng = JaxEngine(jl, params, cache_capacity=1024, promote_threshold=1)
    b = layer.offloaded_buckets[0]
    assert layer._bucket_store_dtype(b) == "int8"
    reg = MetricRegistry()
    eng = InferenceEngine(layer, device="cpu", cache_capacity=1024,
                          promote_threshold=1, registry=reg)
    cache = eng.caches[b]
    assert cache.store_dtype == "int8"
    assert cache.slots.dtype == torch.float32
    assert reg.gauge("serve/cache_bypassed_buckets").value == 0
    rng = np.random.RandomState(12)
    for step in range(6):
        cats = [_zipf(rng, v, BATCH) for v, _, _ in SPECS]
        got = eng.predict(cats)
        with torch.no_grad():
            want = layer(cats)
        _assert_bit_equal(got, want, f"step {step}")
        _assert_bit_equal(got, jeng.predict(cats), f"step {step}: JAX")
    assert eng.cache_stats() == jeng.cache_stats()
    assert eng.cache_stats()["hit_rate"] > 0.5
    resident = np.flatnonzero(cache._slot_keys >= 0)
    ref = JaxHotRowCache(jl, b, capacity=4)._read_rows(
        params["tp"][b], cache._slot_keys[resident],
        scale=params["tp_scale"][b])
    np.testing.assert_array_equal(_bits(cache.slots.numpy()[resident]),
                                  _bits(ref))


def test_cache_fills_only_its_ranks_keys():
    """At world size > 1 each rank fills and refreshes only the slots of
    keys in its own world slice, from its own shard, while its tracker
    admits every key the request carries (the same admissions on every
    rank): here the layer's rank is set to 1 of 2, so keys ``rows_max +
    row`` are its own and the row keys of slice 0 are another rank's.
    A bucket on the card is refused."""
    layer, _, _ = _pair()
    b = layer.offloaded_buckets[0]
    rows_max = layer.plan.tp_buckets[b].rows_max
    cache = HotRowCache(layer, b, capacity=8, promote_threshold=1)
    layer.world_size, layer.rank = 2, 1
    try:
        own = np.arange(3, dtype=np.int64) + rows_max + 5
        other = np.arange(3, dtype=np.int64) + 7
        cache.lookup_slots(np.concatenate([own, other]))
        assert cache.admit() == 6
        slot_own = cache.lookup_slots(own, observe=False)
        slot_other = cache.lookup_slots(other, observe=False)
        assert (slot_own >= 0).all() and (slot_other >= 0).all()
        table = layer.tp[b].detach()
        np.testing.assert_array_equal(cache.slots.numpy()[slot_own],
                                      table[own - rows_max].numpy())
        np.testing.assert_array_equal(cache.slots.numpy()[slot_other], 0.0)
        patch = np.full((6, cache.width), 3.0, np.float32)
        assert cache.apply_rows(np.concatenate([own, other]), patch) == 3
        np.testing.assert_array_equal(cache.slots.numpy()[slot_other], 0.0)
        assert cache.refresh() == 3
        np.testing.assert_array_equal(cache.slots.numpy()[slot_own],
                                      table[own - rows_max].numpy())
        assert cache.stats()["resident"] == 6
    finally:
        layer.world_size, layer.rank = 1, 0
    with pytest.raises(ValueError, match="not host-offloaded"):
        HotRowCache(layer, [i for i in range(len(layer.tp))
                            if i != b][0], capacity=4)


class _PlanOnly:
    """What `DistributedEmbedding._exchange_groups_for_key` reads of a
    layer: the port's plan of `specs` at `world` ranks, built without a
    process group."""

    def __init__(self, specs, world, **kw):
        strat = DistEmbeddingStrategy(
            [Embedding(v, w, combiner=c, device="meta") for v, w, c in specs],
            world, "auto", **kw)
        self.strategy, self.plan = strat, lower_strategy(strat)
        self.world_size, self.rank = world, 0
        self.device = torch.device("cpu")
        self._groups_cache, self._hot_buckets = {}, []

    def _id_dtype(self, b):
        return torch.int32


@pytest.mark.parametrize("world", [2, 4])
def test_group_keys_match_jax_across_ranks(world):
    """The engine's host mirror of every shard's exchanged ids at W > 1
    (`_group_keys`: ``[world, B * f * k]`` keys ``r * rows_max + row``
    and their validity) equals the JAX engine's on a W-device mesh, for
    every exchange group of a request padded from 13 rows to 16 (multi-hot
    and one-hot inputs, ids past their tables clipped)."""
    rng = np.random.RandomState(world)
    specs = MEAN_SPECS
    hot = [3, 1, 3, 1, 2, 1, 1, 3]
    cats = [rng.randint(0, v + 4, size=(13, k) if k > 1 else (13,))
            .astype(np.int32) for (v, _, _), k in zip(specs, hot)]
    jl = JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner=c) for v, w, c in specs],
        mesh=create_mesh(jax.devices()[:world]), gpu_embedding_size=BUDGET)
    jeng = JaxEngine(jl, jl.set_weights(_weights(specs)), cache_capacity=8)
    key, jtp = jeng._tp_key(jeng._normalize(cats))
    jgroups, _ = jl._exchange_groups_for_key(key)
    stub = _PlanOnly(specs, world, gpu_embedding_size=BUDGET)
    tp = [cats[i] for i in stub.strategy.input_groups[1]]
    groups, _ = DistributedEmbedding._exchange_groups_for_key(stub, key)
    assert len(groups) == len(jgroups) > 1
    eng = SimpleNamespace(embedding=stub)
    for grp, jgrp in zip(groups, jgroups):
        keys, valid = InferenceEngine._group_keys(eng, grp, tp, 16, 13)
        jkeys, jvalid = jeng._group_keys(jgrp, jtp, 16, 13)
        assert keys.shape == (world, 16 * grp.f_max * grp.k)
        np.testing.assert_array_equal(keys, jkeys)
        np.testing.assert_array_equal(valid, jvalid)


def test_new_modules_import_no_jax():
    """The slice's modules import neither jax nor the JAX package."""
    bad = []
    for rel in NEW_MODULES:
        path = os.path.join(REPO, "distributed_embeddings_tpu_torch", rel)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            bad += [(rel, n) for n in names if n.split(".")[0] in (
                "jax", "jaxlib", "distributed_embeddings_tpu")]
    assert bad == []
