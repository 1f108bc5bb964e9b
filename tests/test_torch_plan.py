"""The port's planner and lowering against the JAX package's.

Bucket order, row offsets, placements and input groups must be equal: the
weights carried across from JAX and get/set_weights depend on them. The
planner is pure Python, so the plans are compared at world sizes beyond the
port's runtime (which serves world size 1) as well.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_embeddings_tpu.layers import dist_model_parallel as jax_dmp  # noqa: E402
from distributed_embeddings_tpu.layers.embedding import Embedding as JaxEmbedding  # noqa: E402
from distributed_embeddings_tpu.models import synthetic as jax_synth  # noqa: E402
from distributed_embeddings_tpu.parallel import plan as jax_plan  # noqa: E402
from distributed_embeddings_tpu.parallel import planner as jax_planner  # noqa: E402
from distributed_embeddings_tpu_torch.layers import dist_model_parallel as pt_dmp  # noqa: E402
from distributed_embeddings_tpu_torch.layers.embedding import Embedding as PtEmbedding  # noqa: E402
from distributed_embeddings_tpu_torch.models import synthetic as pt_synth  # noqa: E402
from distributed_embeddings_tpu_torch.parallel import plan as pt_plan  # noqa: E402
from distributed_embeddings_tpu_torch.parallel import planner as pt_planner  # noqa: E402

# Criteo-1TB MLPerf vocab sizes (examples/dlrm/main.py CRITEO_TABLE_SIZES)
CRITEO_TABLE_SIZES = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36,
]


def _config(name):
    """(tables [(rows, width, combiner)], input_table_map, hotness,
    strategy) for one of the configurations under test."""
    if name == "dlrm":
        return ([(v, 128, None) for v in CRITEO_TABLE_SIZES], None, None,
                "memory_balanced")
    cfg = jax_synth.SYNTHETIC_MODELS[name]
    tables, tmap, hot = jax_synth.expand_embedding_configs(cfg)
    return [(r, w, "sum") for r, w in tables], tmap, hot, "auto"


def _strip(cfg: dict) -> dict:
    """A planner config without its object-valued entries and the JAX
    layer's kernel toggle (the port has one lookup path)."""
    return {k: v for k, v in cfg.items()
            if k not in ("layer_class", "embeddings_initializer", "dtype",
                         "use_custom_kernel")}


def _strategies(name, world):
    tables, tmap, hot, strategy = _config(name)
    kw = dict(input_table_map=tmap, input_hotness=hot)
    js = jax_planner.DistEmbeddingStrategy(
        [JaxEmbedding(r, w, combiner=c) for r, w, c in tables], world,
        strategy, **kw)
    ps = pt_planner.DistEmbeddingStrategy(
        [PtEmbedding(r, w, combiner=c, device="meta") for r, w, c in tables],
        world, strategy, **kw)
    return js, ps


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("name", ["tiny", "criteo", "dlrm"])
def test_planner_matches_jax(name, world):
    js, ps = _strategies(name, world)
    for attr in ("strategy", "table_groups", "input_groups", "map_groups",
                 "rev_group_ids", "table_ids", "input_ids_list", "local_maps",
                 "local_input_offsets", "local_group_list",
                 "local_weight_offsets", "widths_list_flat", "rev_tp_ids",
                 "sliced_out_ranges"):
        assert getattr(ps, attr) == getattr(js, attr), attr
    for jr, pr in zip(js.local_configs, ps.local_configs):
        assert [_strip(c) for c in pr] == [_strip(c) for c in jr]


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("name", ["tiny", "criteo", "dlrm"])
def test_lowered_plan_matches_jax(name, world):
    js, ps = _strategies(name, world)
    jp, pp = jax_plan.lower_strategy(js), pt_plan.lower_strategy(ps)
    assert len(pp.tp_buckets) == len(jp.tp_buckets)
    for jb, pb in zip(jp.tp_buckets, pp.tp_buckets):
        for attr in ("width", "combiner", "offload", "rows", "rows_max",
                     "f_max", "hot_rows", "wire_dtype", "id_wire_dtype",
                     "storage_dtype", "slack_rows"):
            assert getattr(pb, attr) == getattr(jb, attr), attr
        assert [[(s.tp_input, s.row_offset) for s in r] for r in pb.slots] \
            == [[(s.tp_input, s.row_offset) for s in r] for r in jb.slots]
        assert [[seg[:3] for seg in r] for r in pb.init_segments] \
            == [[seg[:3] for seg in r] for r in jb.init_segments]
    assert [tuple(vars(p).values()) for p in pp.tp_placements] \
        == [tuple(vars(p).values()) for p in jp.tp_placements]
    assert pp.tp_input_slots == jp.tp_input_slots
    assert pp.row_tables == [] and jp.row_tables == []


@pytest.mark.parametrize("name", ["tiny", "criteo", "dlrm"])
def test_exchange_groups_match_jax_at_world_one(name):
    """The full-size layers: the port's on the meta device (no memory)."""
    tables, tmap, hot, strategy = _config(name)
    jl = jax_dmp.DistributedEmbedding(
        [JaxEmbedding(r, w, combiner=c) for r, w, c in tables],
        strategy=strategy, input_table_map=tmap, input_max_hotness=hot)
    pl_ = pt_dmp.DistributedEmbedding(
        [PtEmbedding(r, w, combiner=c, device="meta") for r, w, c in tables],
        strategy=strategy, input_table_map=tmap, input_max_hotness=hot,
        device="meta")
    ks = hot or [1] * len(tables)
    key = tuple((k, False) for k in ks)
    jg, ja = jl._exchange_groups_for_key(key)
    pg, pa = pl_._exchange_groups_for_key(key)
    assert pa == ja
    assert [(g.bucket, g.k, g.class_inputs, g.f_max, g.need_w) for g in pg] \
        == [(g.bucket, g.k, g.class_inputs, g.f_max, g.need_w) for g in jg]
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a.sel, b.sel)
        np.testing.assert_array_equal(a.offs, b.offs)
    assert [tuple(t.shape) for t in pl_.tp] == [
        (b.rows_max, b.width) for b in jl.plan.tp_buckets]


def test_tiny_plan_is_the_documented_slice():
    """Tiny at world size 1: a width-8 bucket of 60,160 rows, a width-16
    bucket of 70.2M rows, and four (bucket, hotness) groups."""
    tables, tmap, hot, _ = _config("tiny")
    layer = pt_dmp.DistributedEmbedding(
        [PtEmbedding(r, w, combiner=c, device="meta") for r, w, c in tables],
        input_table_map=tmap, input_max_hotness=hot, device="meta")
    assert [(b.width, b.rows_max) for b in layer.plan.tp_buckets] == [
        (8, 60_160), (16, 70_200_000)]
    groups, _ = layer._exchange_groups_for_key(
        tuple((k, False) for k in hot))
    assert [(g.bucket, g.k, g.f_max) for g in groups] == [
        (0, 1, 31), (0, 10, 1), (1, 1, 24), (1, 10, 2)]
    assert len(pt_synth.expand_embedding_configs(
        pt_synth.SYNTHETIC_MODELS["tiny"])[1]) == 58
