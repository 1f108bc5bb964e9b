"""Lowering: planner output -> stacked per-rank bucket parameterization.

Counterpart of ``distributed_embeddings_tpu/parallel/plan.py``. All tables a
rank owns with the same (width, combiner, offload) key are concat-fused
into one tall table, a "bucket" ``[world, rows_max, width]``; per-rank
differences (which inputs a rank serves, each table's row offset inside the
fused table) are small integer records. The bucket order and every row
offset here equal the JAX package's, so weights map across one to one.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from distributed_embeddings_tpu_torch.parallel.planner import (
    DistEmbeddingStrategy)

Config = Dict[str, Any]

# clip ceiling of the int16 id wire (the JAX package's ops/wire.py)
INT16_ID_MAX = 2**15 - 1


@dataclasses.dataclass(frozen=True)
class TPSlot:
    """One (rank, bucket) lookup slot serving one table-parallel input."""
    tp_input: int     # index within the tp input group
    row_offset: int   # row offset of the backing table in the fused bucket


@dataclasses.dataclass(frozen=True)
class TPPlacement:
    """Where one column-slice of one tp table lives; drives
    get/set_weights."""
    table_id: int     # index within the col (tp) table group
    rank: int
    bucket: int
    row_offset: int
    rows: int
    col_start: int
    col_end: int


@dataclasses.dataclass
class TPBucket:
    """One stacked parameter [world, rows_max, width]."""
    width: int
    combiner: Optional[str]
    offload: bool
    rows: List[int]                 # true (unpadded) rows per rank
    rows_max: int
    slots: List[List[TPSlot]]       # per rank, in exchange slot order
    f_max: int
    # per-rank list of (table_id, row_offset, rows, initializer, dtype)
    init_segments: List[List[Tuple[int, int, int, Any, Any]]]
    hot_rows: int = 0               # replicated hot-shard capacity
    wire_dtype: str = "f32"         # float exchange wire
    id_wire_dtype: str = "int32"    # dp->mp id wire
    storage_dtype: str = "f32"      # at-rest row storage
    slack_rows: int = 0             # dynamic-vocabulary growth rows


@dataclasses.dataclass
class RowTablePlan:
    """One row-sliced (vocab-sharded) table [world, rows_max, width]."""
    table_id: int
    width: int
    combiner: Optional[str]
    rows_per_rank: List[int]
    rows_max: int
    row_base: np.ndarray            # [world] global row base per rank
    initializer: Any
    dtype: Any
    wire_dtype: str = "f32"
    id_wire_dtype: str = "int32"
    storage_dtype: str = "f32"


@dataclasses.dataclass
class ShardedPlan:
    world_size: int
    strategy: DistEmbeddingStrategy
    tp_buckets: List[TPBucket]
    tp_placements: List[TPPlacement]
    # per tp input: its slots in rank order: (rank, bucket_idx, slot_idx)
    tp_input_slots: List[List[Tuple[int, int, int]]]
    row_tables: List[RowTablePlan]


def _bucket_key(config: Config) -> Tuple[int, Optional[str], bool]:
    return (config["output_dim"], config.get("combiner"),
            bool(config.get("cpu_offload", False)))


def _hot_capacity(bucket: TPBucket, hot_rows: int, world: int) -> int:
    """Hot-shard capacity for one bucket, 0 when ineligible (offloaded,
    combiner None, or a flat key space that overflows int32)."""
    if hot_rows <= 0 or bucket.offload or bucket.combiner is None:
        return 0
    rows_max = max(bucket.rows_max, 1)
    if (world + 1) * rows_max + hot_rows >= 2**31 - 1:
        return 0
    return min(hot_rows, max(sum(bucket.rows), 1))


def _wire_eligibility(combiner: Optional[str], offload: bool,
                      requested: str) -> str:
    """Float wire format for one bucket/table: passthrough (combiner None)
    and offloaded buckets keep f32."""
    if combiner is None or offload:
        return "f32"
    return requested


def _storage_eligibility(requested: str, hot_rows: int = 0) -> str:
    """At-rest storage dtype for one bucket: hot-sharded buckets stay f32."""
    if hot_rows > 0:
        return "f32"
    return requested


def _id_wire_dtype(rows_max: int) -> str:
    """'int16' where every legal wire value (ids and the hot sentinel
    rows_max) sits strictly below the int16 clip ceiling."""
    if 0 <= max(rows_max, 1) < INT16_ID_MAX:
        return "int16"
    return "int32"


def lower_strategy(strategy: DistEmbeddingStrategy) -> ShardedPlan:
    """Lower a planner result to the stacked plan."""
    world = strategy.world_size

    # ---------------- table-parallel buckets --------------------------------
    bucket_index: Dict[Tuple, int] = {}
    buckets: List[TPBucket] = []
    placements: List[TPPlacement] = []
    # running column cursor per tp table (col slices consumed in rank order)
    col_cursor: Dict[int, int] = {}
    # per (rank, local_table_pos) -> (bucket_idx, row_offset)
    local_pos_info: List[List[Tuple[int, int]]] = []
    slack_per: Dict[Tuple[int, int], int] = {}

    for rank in range(world):
        table_ids = strategy.table_ids[rank] if strategy.table_ids else []
        configs = (strategy.local_preconcat_configs[rank]
                   if strategy.local_preconcat_configs else [])
        rank_info = []
        for table_id, cfg in zip(table_ids, configs):
            key = _bucket_key(cfg)
            if key not in bucket_index:
                bucket_index[key] = len(buckets)
                buckets.append(TPBucket(
                    width=cfg["output_dim"], combiner=cfg.get("combiner"),
                    offload=bool(cfg.get("cpu_offload", False)),
                    rows=[0] * world, rows_max=0,
                    slots=[[] for _ in range(world)], f_max=0,
                    init_segments=[[] for _ in range(world)]))
            b = bucket_index[key]
            bucket = buckets[b]
            row_offset = bucket.rows[rank]
            bucket.rows[rank] += cfg["input_dim"]
            slack_per[(b, rank)] = (slack_per.get((b, rank), 0)
                                    + int(cfg.get("vocab_slack", 0)))
            bucket.init_segments[rank].append(
                (table_id, row_offset, cfg["input_dim"],
                 cfg.get("embeddings_initializer", "uniform"),
                 cfg.get("dtype")))
            col_start = col_cursor.get(table_id, 0)
            col_end = col_start + cfg["output_dim"]
            col_cursor[table_id] = col_end
            placements.append(TPPlacement(
                table_id=table_id, rank=rank, bucket=b,
                row_offset=row_offset, rows=cfg["input_dim"],
                col_start=col_start, col_end=col_end))
            rank_info.append((b, row_offset))
        local_pos_info.append(rank_info)

    for b, bucket in enumerate(buckets):
        bucket.rows_max = max(bucket.rows) if bucket.rows else 0
        bucket.slack_rows = max((slack_per.get((b, r), 0)
                                 for r in range(world)), default=0)

    # ---------------- input slots -------------------------------------------
    n_tp_inputs = len(strategy.input_groups[1]) if strategy.input_groups else 0
    tp_input_slots: List[List[Tuple[int, int, int]]] = [
        [] for _ in range(n_tp_inputs)]
    for rank in range(world):
        if not strategy.table_ids:
            break
        # the reference's per-rank input enumeration order: tables outer,
        # inputs inner
        for local_pos, table_idx in enumerate(strategy.table_ids[rank]):
            for inp_pos, mapped_idx in enumerate(strategy.map_groups[1]):
                if table_idx == mapped_idx:
                    b, row_offset = local_pos_info[rank][local_pos]
                    bucket = buckets[b]
                    slot_idx = len(bucket.slots[rank])
                    bucket.slots[rank].append(
                        TPSlot(tp_input=inp_pos, row_offset=row_offset))
                    tp_input_slots[inp_pos].append((rank, b, slot_idx))

    for bucket in buckets:
        bucket.f_max = max((len(s) for s in bucket.slots), default=0)
        bucket.hot_rows = _hot_capacity(bucket, strategy.hot_rows, world)
        bucket.wire_dtype = _wire_eligibility(
            bucket.combiner, bucket.offload, strategy.exchange_wire)
        bucket.id_wire_dtype = _id_wire_dtype(bucket.rows_max)
        bucket.storage_dtype = _storage_eligibility(strategy.storage_dtype,
                                                    bucket.hot_rows)

    # ---------------- row-sliced tables -------------------------------------
    row_tables: List[RowTablePlan] = []
    for t in range(len(strategy.table_groups[2])):
        per_rank = [strategy.row_sliced_configs[r][t] for r in range(world)]
        rows = [cfg["input_dim"] for cfg in per_rank]
        # the positive global base row of each rank's slice
        base = np.asarray([-strategy.row_inputs_offsets[r][t]
                           for r in range(world)], dtype=np.int32)
        cfg0 = per_rank[0]
        row_tables.append(RowTablePlan(
            table_id=t, width=cfg0["output_dim"],
            combiner=cfg0.get("combiner"),
            rows_per_rank=rows, rows_max=max(rows), row_base=base,
            initializer=cfg0.get("embeddings_initializer", "uniform"),
            dtype=cfg0.get("dtype"),
            wire_dtype=_wire_eligibility(cfg0.get("combiner"), False,
                                         strategy.exchange_wire),
            id_wire_dtype=_id_wire_dtype(sum(rows))))

    return ShardedPlan(
        world_size=world, strategy=strategy, tp_buckets=buckets,
        tp_placements=placements, tp_input_slots=tp_input_slots,
        row_tables=row_tables)
