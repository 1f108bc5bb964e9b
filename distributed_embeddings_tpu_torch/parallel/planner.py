"""Sharding planner: decides where every embedding table (or slice) lives.

Counterpart of ``distributed_embeddings_tpu/parallel/planner.py`` (itself a
port of the reference's ``DistEmbeddingStrategy``). Pure Python over config
dicts, so the plan is identical to the JAX package's for the same tables:
the fused bucket order and every table's row offset in its bucket follow
from it, and weights carried across from JAX depend on both.

Groups:
  group 0 — data-parallel: tables with <= data_parallel_threshold elements.
  group 1 — column-slice + table-parallel: tables optionally split along
            output_dim into power-of-2 slices, then whole slices placed
            onto ranks by one of the strategies.
  group 2 — row-slice: tables with >= row_slice_threshold elements, split
            evenly along input_dim across all ranks.
"""

from typing import Any, Dict, List, Optional, Sequence

from distributed_embeddings_tpu_torch.ops.wire import (resolve_store_dtype,
                                                      resolve_wire)
from distributed_embeddings_tpu_torch.utils.initializers import (
    ConcatInitializer)

Config = Dict[str, Any]

def _table_size(config: Config) -> int:
    return config["input_dim"] * config["output_dim"]


def _stable_argsort(values, key=None, reverse=False):
    if key is None:
        key = lambda v: v
    order = sorted(range(len(values)), key=lambda i: key(values[i]),
                   reverse=reverse)
    return [values[i] for i in order], order


class DistEmbeddingStrategy:
    """Computes the global placement plan for a list of embedding tables.

    Arguments and attributes mirror the JAX package's class. Requests the
    JAX package resolves from environment knobs (hot_rows, exchange_wire,
    vocab_slack, storage_dtype) default to their off values here.
    """

    def __init__(self,
                 embeddings: Sequence,
                 world_size: int,
                 strategy: str = "basic",
                 input_table_map: Optional[Sequence[int]] = None,
                 column_slice_threshold: Optional[int] = None,
                 row_slice_threshold: Optional[int] = None,
                 data_parallel_threshold: Optional[int] = None,
                 gpu_embedding_size: Optional[int] = None,
                 input_hotness: Optional[Sequence[Optional[int]]] = None,
                 hot_rows: Optional[int] = None,
                 exchange_wire: Optional[str] = None,
                 vocab_slack: Optional[int] = None,
                 storage_dtype: Optional[str] = None):
        if strategy not in ("auto", "basic", "memory_balanced",
                            "memory_optimized", "comm_balanced"):
            raise ValueError(f"Unsupported shard strategy {strategy}")
        if strategy == "auto":
            # multi-hot models pay real exchange padding — minimize it;
            # one-hot models only care about memory -> 'basic'
            strategy = ("comm_balanced"
                        if input_hotness is not None
                        and any((h or 1) > 1 for h in input_hotness)
                        else "basic")
        # single process: the plan degenerates like the reference's
        self.strategy = "basic" if world_size == 1 else strategy
        self.world_size = world_size
        self.column_slice_threshold = column_slice_threshold
        self.row_slice_threshold = row_slice_threshold
        self.data_parallel_threshold = data_parallel_threshold
        self.gpu_embedding_size = gpu_embedding_size
        self.hot_rows = 0 if hot_rows is None else max(0, int(hot_rows))
        self.exchange_wire = resolve_wire(exchange_wire)
        # the port's default stays f32 (the JAX package's DET_STORE_DTYPE
        # seam is ROADMAP Queue A15c)
        self.storage_dtype = resolve_store_dtype(storage_dtype)

        self.global_configs = []
        for emb in embeddings:
            cfg = dict(emb.get_config())
            cfg["layer_class"] = type(emb)
            self.global_configs.append(cfg)
        if input_table_map is None:
            input_table_map = list(range(len(self.global_configs)))
        self.input_table_map = list(input_table_map)
        if input_hotness is not None and \
                len(input_hotness) != len(self.input_table_map):
            raise ValueError(
                f"input_hotness has {len(input_hotness)} entries but there "
                f"are {len(self.input_table_map)} inputs")
        self.input_hotness = (list(input_hotness)
                              if input_hotness is not None
                              else [None] * len(self.input_table_map))

        self.table_groups = self.init_table_groups(self.global_configs)
        # dynamic-vocabulary slack: inflate every table-parallel table by
        # `vocab_slack` rows after grouping and before slicing/fusion, so
        # every downstream structure sees the physical capacity
        self.vocab_slack = 0 if vocab_slack is None else max(0,
                                                             int(vocab_slack))
        if self.vocab_slack:
            for i in self.table_groups[1]:
                cfg = self.global_configs[i]
                cfg["vocab_base_rows"] = cfg["input_dim"]
                cfg["vocab_slack"] = self.vocab_slack
                cfg["input_dim"] += self.vocab_slack
        (self.input_groups, self.map_groups,
         self.rev_group_ids) = self.init_input_and_map_groups(
            self.table_groups, self.input_table_map)

        # group 0: data parallel
        self.dp_configs = [self.global_configs[i] for i in self.table_groups[0]]

        # group 2: row slice
        if self.table_groups[2]:
            self.row_sliced_configs, self.row_inputs_offsets = (
                self.create_row_sliced_configs(
                    [self.global_configs[i] for i in self.table_groups[2]],
                    world_size))
        else:
            self.row_sliced_configs = [[] for _ in range(world_size)]
            self.row_inputs_offsets = [[] for _ in range(world_size)]

        # group 1: column slice + table parallel
        self.sliced_out_ranges: List[List[int]] = []
        self.input_ids_list: List[List[int]] = []
        self.local_maps: List[List[int]] = []
        self.local_configs: List[List[Config]] = []
        self.local_input_offsets: List[List[int]] = []
        self.local_weight_offsets: List[List[List[int]]] = []
        self.local_group_list: List[List[List[int]]] = []
        self.table_ids: List[List[int]] = []
        # per-rank slice configs after merge+offload, before concat fusion —
        # the lowering (parallel/plan.py) builds its buckets from these
        self.local_preconcat_configs: List[List[Config]] = []
        self.widths_list_flat: List[int] = []
        self.rev_tp_ids: List[int] = []
        if not self.table_groups[1]:
            return

        sliced_configs, self.sliced_out_ranges = self.create_col_sliced_configs(
            [self.global_configs[i] for i in self.table_groups[1]],
            world_size, self.column_slice_threshold, self.map_groups[1])

        divided_ids = self.apply_strategy(self.strategy, world_size,
                                          sliced_configs)

        for rank_table_ids in divided_ids:
            rank_table_ids, rank_configs = self._merge_slices(rank_table_ids,
                                                              sliced_configs)
            self.table_ids.append(rank_table_ids)

            rank_input_ids, rank_input_map = [], []
            for local_pos, table_idx in enumerate(rank_table_ids):
                for inp_pos, mapped_idx in enumerate(self.map_groups[1]):
                    if table_idx == mapped_idx:
                        rank_input_ids.append(inp_pos)
                        rank_input_map.append(local_pos)

            rank_configs = self._maybe_offload(rank_configs)
            self.local_preconcat_configs.append([dict(c) for c in rank_configs])
            (rank_configs, rank_input_map, input_offsets, group,
             weight_offsets) = self._create_concat(rank_configs, rank_input_map)

            self.input_ids_list.append(rank_input_ids)
            self.local_configs.append(rank_configs)
            self.local_maps.append(rank_input_map)
            self.local_input_offsets.append(input_offsets)
            self.local_group_list.append(group)
            self.local_weight_offsets.append(weight_offsets)

        for configs, input_map in zip(self.local_configs, self.local_maps):
            self.widths_list_flat += [configs[m]["output_dim"]
                                      for m in input_map]

        worker_order = [i for rank_ids in self.input_ids_list for i in rank_ids]
        self.rev_tp_ids = [
            pos for _, pos in sorted(zip(worker_order,
                                         range(len(worker_order))))
        ]

    # ---------------------------------------------------------------- groups
    def init_table_groups(self, configs: Sequence[Config]) -> List[List[int]]:
        """Partition tables into [dp, col, row] id groups by element count."""
        dp, col, row = [], [], []
        for i, config in enumerate(configs):
            n = _table_size(config)
            if self.data_parallel_threshold and n <= self.data_parallel_threshold:
                dp.append(i)
            elif self.row_slice_threshold and n >= self.row_slice_threshold:
                row.append(i)
            else:
                col.append(i)
        return [dp, col, row]

    def init_input_and_map_groups(self, table_groups, input_table_map):
        """Split inputs along the same grouping; compute reorder indices to
        restore the original input order."""
        dp, col, row = table_groups
        inputs = [[], [], []]
        maps = [[], [], []]
        for inp_pos, table_idx in enumerate(input_table_map):
            for gid, group in enumerate((dp, col, row)):
                if table_idx in group:
                    inputs[gid].append(inp_pos)
                    maps[gid].append(group.index(table_idx))
                    break
            else:
                raise ValueError("input_table_map entry matches no table group")
        flat = inputs[0] + inputs[1] + inputs[2]
        rev = [pos for _, pos in sorted(zip(flat, range(len(flat))))]
        return inputs, maps, rev

    # ------------------------------------------------------------- col slice
    def maybe_slice_table_column(self, orig_config: Config,
                                 column_slice_threshold: Optional[int],
                                 world_size: int) -> List[Config]:
        """Split a table along output_dim into the smallest power-of-2 number
        of even slices that puts each slice under the threshold, capped at
        min(N, world_size, output_dim)."""
        if column_slice_threshold is None:
            column_slice_threshold = float("inf")
        size = _table_size(orig_config)
        num_slices = 1
        while size > column_slice_threshold:
            num_slices *= 2
            size /= 2
        if num_slices == 1:
            return [dict(orig_config)]
        num_slices = min(num_slices, world_size, orig_config["output_dim"])
        base = orig_config["output_dim"] // num_slices
        rem = orig_config["output_dim"] % num_slices
        slices = []
        for i in range(num_slices):
            cfg = dict(orig_config)
            cfg["output_dim"] = base + (1 if i < rem else 0)
            slices.append(cfg)
        return slices

    def create_col_sliced_configs(self, global_col_configs, world_size,
                                  column_slice_threshold, input_table_map):
        """Maybe-slice every col-group table; also compute which output
        ranges must be re-concatenated after the exchange. With fewer tables
        than workers and no explicit threshold, halve the largest table until
        there are at least world_size slices."""
        if column_slice_threshold is None:
            sizes = [_table_size(c) for c in global_col_configs]
            while world_size > len(sizes):
                sizes.sort()
                column_slice_threshold = sizes[-1] - 1
                largest = sizes.pop()
                sizes += [largest // 2, largest // 2]

        sliced_configs = [
            self.maybe_slice_table_column(cfg, column_slice_threshold,
                                          world_size)
            for cfg in global_col_configs
        ]

        sliced_out_ranges = []
        for input_id, table_id in enumerate(input_table_map):
            if len(sliced_configs[table_id]) > 1:
                sliced_out_ranges.append(
                    [input_id, input_id + len(sliced_configs[table_id])])
        return sliced_configs, sliced_out_ranges

    # ------------------------------------------------------------- row slice
    def create_row_sliced_configs(self, global_row_configs, world_size):
        """Evenly split each row-group table along input_dim across all
        ranks; offsets are the (negative) global row base of each slice."""
        per_table_configs, per_table_offsets = [], []
        for orig in global_row_configs:
            base = orig["input_dim"] // world_size
            rem = orig["input_dim"] % world_size
            configs, offsets, cursor = [], [], 0
            for i in range(world_size):
                cfg = dict(orig)
                cfg["input_dim"] = base + (1 if i < rem else 0)
                configs.append(cfg)
                offsets.append(cursor)
                cursor -= cfg["input_dim"]
            per_table_configs.append(configs)
            per_table_offsets.append(offsets)
        by_rank_configs = [list(t) for t in zip(*per_table_configs)]
        by_rank_offsets = [list(t) for t in zip(*per_table_offsets)]
        return by_rank_configs, by_rank_offsets

    # -------------------------------------------------------------- strategy
    def apply_strategy(self, mode: str, world_size: int,
                       sliced_configs) -> List[List[int]]:
        """Assign table slices to ranks: per-rank lists of table ids (a table
        id appears once per slice assigned to that rank)."""
        flat_ids, flat_sizes = [], []
        for table_id, slices in enumerate(sliced_configs):
            for cfg in slices:
                flat_ids.append(table_id)
                flat_sizes.append(_table_size(cfg))

        if mode == "basic":
            return [flat_ids[r::world_size] for r in range(world_size)]

        if mode == "memory_balanced":
            ordered = [tid for _, tid in
                       sorted(zip(flat_sizes, flat_ids), reverse=True)]
            return [
                ordered[r::2 * world_size]
                + ordered[(2 * world_size - 1 - r)::2 * world_size]
                for r in range(world_size)
            ]

        if mode == "memory_optimized":
            # greedy: the largest remaining slice goes to the least-loaded rank
            remaining = sorted(zip(flat_sizes, flat_ids))
            bins: List[List[Any]] = [[0, []] for _ in range(world_size)]
            while remaining:
                size, tid = remaining.pop()
                bins[0][0] += size
                bins[0][1].append(tid)
                bins = sorted(bins)
            return [b[1] for b in bins]

        if mode == "comm_balanced":
            return self._comm_balanced(world_size, sliced_configs)

        raise ValueError(f"Unsupported strategy {mode}")

    def _comm_balanced(self, world_size: int,
                       sliced_configs) -> List[List[int]]:
        """Greedy placement minimizing exchange-group padding: each slice,
        largest first, goes to the rank where it increases
        sum_class k * f_max the least, per-rank bytes breaking ties."""
        table_ks: List[List[int]] = [[] for _ in sliced_configs]
        for inp_pos, tidx in enumerate(self.map_groups[1]):
            orig = self.input_groups[1][inp_pos]
            table_ks[tidx].append(self.input_hotness[orig] or 1)

        flat = []
        for tid, slices in enumerate(sliced_configs):
            for cfg in slices:
                flat.append((_table_size(cfg), tid, cfg))
        flat.sort(key=lambda t: t[0], reverse=True)

        counts: List[Dict] = [{} for _ in range(world_size)]
        bytes_ = [0] * world_size
        out: List[List[int]] = [[] for _ in range(world_size)]
        cls_max: Dict = {}
        for size, tid, cfg in flat:
            tally: Dict = {}
            for k in (table_ks[tid] or [1]):
                c = (cfg["output_dim"], cfg.get("combiner"), k)
                tally[c] = tally.get(c, 0) + 1
            best, best_cost = 0, None
            for r in range(world_size):
                pad = sum(
                    c[2] * max(0, counts[r].get(c, 0) + n
                               - cls_max.get(c, 0))
                    for c, n in tally.items())
                cost = (pad, bytes_[r], len(out[r]))
                if best_cost is None or cost < best_cost:
                    best, best_cost = r, cost
            for c, n in tally.items():
                counts[best][c] = counts[best].get(c, 0) + n
                cls_max[c] = max(cls_max.get(c, 0), counts[best][c])
            bytes_[best] += size
            out[best].append(tid)
        return out

    # --------------------------------------------------------------- offload
    def _maybe_offload(self, configs: List[Config]) -> List[Config]:
        """Flag the largest tables for host offload so the on-device total
        stays within gpu_embedding_size."""
        configs = [dict(c) for c in configs]
        if self.gpu_embedding_size is None:
            for c in configs:
                c["cpu_offload"] = False
            return configs
        total = 0
        _, order = _stable_argsort(configs, key=_table_size)
        for idx in order:
            total += _table_size(configs[idx])
            configs[idx]["cpu_offload"] = total > self.gpu_embedding_size
        return configs

    # ---------------------------------------------------------------- concat
    def _create_concat(self, table_configs: List[Config],
                       input_maps: List[int]):
        """Fuse a rank's same-width same-combiner tables into one tall
        table; the fused table is one bucket's lookup target."""
        grouped_ids: List[List[int]] = []
        concat_configs: List[Config] = []
        for table_id, config in enumerate(table_configs):
            merged = False
            for group, ccfg in zip(grouped_ids, concat_configs):
                if (config["output_dim"] == ccfg["output_dim"]
                        and config.get("combiner") == ccfg.get("combiner")
                        and not (config["cpu_offload"] or ccfg["cpu_offload"])):
                    group.append(table_id)
                    ccfg["input_dim"] += config["input_dim"]
                    ccfg["input_dims"].append(config["input_dim"])
                    ccfg["offsets"].append(ccfg["offsets"][-1]
                                           + config["input_dim"])
                    merged = True
                    break
            if not merged:
                cfg = dict(config)
                cfg["input_dims"] = [config["input_dim"]]
                cfg["offsets"] = [0, config["input_dim"]]
                grouped_ids.append([table_id])
                concat_configs.append(cfg)

        new_input_map, input_offsets = [], []
        for m in input_maps:
            for gid, (group, ccfg) in enumerate(zip(grouped_ids,
                                                    concat_configs)):
                if m in group:
                    new_input_map.append(gid)
                    input_offsets.append(ccfg["offsets"][group.index(m)])
                    break

        for ccfg in concat_configs:
            input_dims = ccfg.pop("input_dims")
            if len(input_dims) > 1 and "embeddings_initializer" in ccfg:
                ccfg["embeddings_initializer"] = ConcatInitializer(
                    ccfg["embeddings_initializer"], input_dims)

        weight_offsets = [ccfg.pop("offsets", None) for ccfg in concat_configs]
        return (concat_configs, new_input_map, input_offsets, grouped_ids,
                weight_offsets)

    # ----------------------------------------------------------- slice merge
    def _merge_slices(self, rank_table_ids: List[int], sliced_configs):
        """Re-merge column slices of the same table that landed on one rank,
        consuming slices in rank visit order."""
        merged_ids: List[int] = []
        rank_configs: List[Config] = []
        for table_idx in rank_table_ids:
            if table_idx in merged_ids:
                extra = sliced_configs[table_idx].pop(0)
                pos = merged_ids.index(table_idx)
                rank_configs[pos] = dict(rank_configs[pos])
                rank_configs[pos]["output_dim"] += extra["output_dim"]
                for out_range in self.sliced_out_ranges:
                    if out_range[0] == table_idx:
                        out_range[-1] -= 1
            else:
                merged_ids.append(table_idx)
                rank_configs.append(sliced_configs[table_idx].pop(0))
        return merged_ids, rank_configs
