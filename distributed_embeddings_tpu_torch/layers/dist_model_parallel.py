"""Distributed embedding: planned, fused table-parallel lookups.

Counterpart of ``distributed_embeddings_tpu/layers/dist_model_parallel.py``
`DistributedEmbedding`, as an ``nn.Module`` that owns its rank's fused
bucket tables. This slice covers data-parallel input with every table in
the table-parallel group: tables of one (width, combiner) key are fused
into one bucket, and the forward runs one gather-combine per (bucket,
hotness) exchange group through the CUDA kernel of `ops.cuda_lookup` (its
plain version when the tables are on the CPU), or, with
``lookup_path="tiled"`` or ``"fused"``, through the sorted-stream lookups
of `ops.cuda_tiled`.

The group structure is the JAX package's: inputs of one bucket and hotness
are stacked into ``[B_l, f, k]``, moved dp->mp as ``[world, B_l, f_max, k]``
blocks (`ops.wire.wire_id_all_to_all`), their row offsets inside the fused
table are added, one lookup serves the whole group over the global batch,
and the ``[world, B_l, f_max, w]`` result goes back mp->dp
(`ops.wire.wire_all_to_all`, whose backward carries the gradients back)
and is sliced into per-input outputs. At world size 1 both exchanges are
the identity. The ranks are those of the default ``torch.distributed``
process group (`parallel.mesh.initialize_distributed`); each rank passes
its own slice of the global batch (`parallel.staging.stage_dp_batch`).
The dp group, column slicing at world > 1, row slicing, offload, hot rows
and quantized storage come in later slices (ROADMAP Queue A) and raise
NotImplementedError here.

Training: a tapped forward (`make_taps`, ``forward(taps=...,
return_residuals=True)``) makes each group's mp-side output a leaf of the
autograd graph, whose ``.grad`` is the JAX package's tap gradient on the
owning rank; `sparse_update` turns those into row-wise updates of this
rank's tables through `ops.sparse_update`. Inside `residual_sort_scope`
(the train step's, with ``fold_sort``), a tapped forward sorts each
exchange group's id stream once (`embedding_ops.canonical_id_sort`); the
sorted lookups and the sparse update of a one-group bucket consume that
sort instead of sorting again.
"""

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from distributed_embeddings_tpu_torch.layers.embedding import Embedding
from distributed_embeddings_tpu_torch.ops import (cuda_lookup, cuda_tiled,
                                                  embedding_ops, wire)
from distributed_embeddings_tpu_torch.ops.embedding_ops import (
    GroupSort, RaggedIds, SparseIds, canonical_id_sort)
from distributed_embeddings_tpu_torch.ops.sparse_update import (
    SparseOptimizer, SparseRowGrad, concat_grads, update_consumes_sort)
from distributed_embeddings_tpu_torch.parallel import mesh as pg
from distributed_embeddings_tpu_torch.parallel.plan import (ShardedPlan,
                                                            lower_strategy)
from distributed_embeddings_tpu_torch.parallel.planner import (
    DistEmbeddingStrategy)
from distributed_embeddings_tpu_torch.utils.device import (
    DeviceLike, check_compute_dtype, default_generator, resolve_device)
from distributed_embeddings_tpu_torch.utils.initializers import (
    get_initializer)

__all__ = ["DistEmbeddingStrategy", "DistributedEmbedding", "TapResiduals",
           "LOOKUP_PATHS", "broadcast_variables"]

# the JAX package's DET_LOOKUP_PATH values: "auto", "xla" and "pallas" take
# the gather-combine kernel, "tiled" and "fused" the sorted-stream lookups
LOOKUP_PATHS = ("auto", "xla", "pallas", "tiled", "fused")


def _combine(emb: torch.Tensor, weights: Optional[torch.Tensor],
             combiner: Optional[str]) -> torch.Tensor:
    """Reduce the hotness axis (second-to-last) of `emb` [..., K, w];
    weights [..., K] carry 0 for padded slots, mean divides by the
    (weighted) count."""
    if combiner is None:
        return emb.reshape(emb.shape[:-2] + (emb.shape[-2] * emb.shape[-1],))
    if weights is None:
        if combiner == "sum":
            return emb.sum(dim=-2)
        return emb.mean(dim=-2)
    out = torch.einsum("...k,...kw->...w", weights.to(emb.dtype), emb)
    if combiner == "mean":
        denom = weights.sum(dim=-1).clamp_min(1.0).to(out.dtype)
        out = out / denom[..., None]
    return out


def _effective_weights(weights: Optional[torch.Tensor], k: int,
                       combiner: Optional[str]):
    """Rewrite a (weights, combiner) pair as an explicit weighted sum:
    ``out[b] = scale * sum_k eff_w[b,k] * rows[b,k]`` (eff_w None = all
    ones). Returns (eff_w, scale)."""
    if combiner is None or combiner == "sum":
        return weights, 1.0
    if combiner != "mean":
        raise ValueError(f"Unknown combiner {combiner}")
    if weights is None:
        return None, 1.0 / max(k, 1)
    denom = weights.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return weights / denom, 1.0


def _overrides_forward(cls) -> bool:
    """True when a table's layer class carries its own forward semantics,
    which the fused bucket lookup would silently ignore."""
    if cls is None or getattr(cls, "det_gather_semantics", False):
        return False
    return getattr(cls, "forward", None) not in (None, Embedding.forward,
                                                 nn.Module.forward)


class TapResiduals:
    """Residuals of a tapped forward, consumed by `sparse_update`: per
    exchange group the absolute row ids after the exchange and the row
    offset add, ``tp_ids[g]`` ``[1, B, f_g, k_g]`` (B the global batch,
    this rank's stacked shard of the JAX package's array), the effective
    combine weights ``tp_w[g]`` (None = uniform; the scale is recomputed
    from the group), and ``tp_sort[g]``, the `GroupSort` of the group's
    flattened ids when the forward sorted them (sort folding; None
    otherwise, and the update sorts afresh). `key` is the exchange-group
    cache key. The JAX package's row-sliced fields are not ported (ROADMAP
    Queue A4)."""

    __slots__ = ("key", "tp_ids", "tp_w", "tp_sort")

    def __init__(self, key, tp_ids, tp_w, tp_sort=None):
        self.key = key
        self.tp_ids = tp_ids
        self.tp_w = tp_w
        self.tp_sort = tp_sort


class _PreparedInput:
    """A normalized input: dense ids [B, k] (+ optional weights [B, k])."""

    __slots__ = ("ids", "weights", "orig_1d", "k")

    def __init__(self, ids, weights, orig_1d, k):
        self.ids = ids
        self.weights = weights
        self.orig_1d = orig_1d
        self.k = k


class _ExchangeGroup:
    """The slots of one tp bucket whose inputs share hotness k: one
    gather-combine. `sel`/`offs` are the JAX package's [world, f_max]
    planning constants; on the device, `sel_t` is `sel` flattened
    destination-major (the send block's member order) and `offs_t` this
    rank's row of `offs`."""

    __slots__ = ("bucket", "k", "class_inputs", "sel", "offs", "f_max",
                 "need_w", "sel_t", "offs_t")

    def __init__(self, bucket, k, class_inputs, sel, offs, f_max, need_w,
                 id_dtype, device, rank):
        self.bucket = bucket
        self.k = k
        self.class_inputs = class_inputs
        self.sel = sel
        self.offs = offs
        self.f_max = f_max
        self.need_w = need_w
        self.sel_t = torch.as_tensor(sel.reshape(-1), dtype=torch.int64,
                                     device=device)
        self.offs_t = torch.as_tensor(offs[rank], dtype=id_dtype,
                                      device=device)


class DistributedEmbedding(nn.Module):
    """Plans placement for a list of embedding tables and runs their fused
    lookups.

    Args mirror the JAX package's class. ``device`` (None = cuda) is where
    the fused bucket tables live; ``generator`` draws their initial values
    (default: seed 0 on `device`). ``lookup_path`` (one of `LOOKUP_PATHS`;
    the JAX package reads it from ``DET_LOOKUP_PATH``) picks the lookup of
    the combined groups: "auto", "xla" and "pallas" the gather-combine
    kernel, "tiled" the sorted gather then a weighted sum
    (`cuda_tiled.tiled_embedding_lookup`), "fused" the weighted sorted
    gather then a hotness sum (`cuda_tiled.fused_lookup_combine`).
    The world is the default process group's (`world_size`, if given,
    must equal it); in a group of more than one rank, every rank builds
    the layer with the same tables, and the forward and `get_weights` are
    collective. Parameters: ``tp[b]`` is this rank's shard of bucket b,
    ``[rows_max, width]`` (the JAX package's ``params['tp'][b][rank]``).

    Arguments of the JAX package that the port takes at their defaults
    only: ``use_custom_kernel`` (True; False, the JAX package's XLA
    lookup, has no counterpart: the port's lookups never fall back, ROADMAP
    North star), ``compute_dtype`` (None or float32; anything else is
    ROADMAP Queue A16, mixed precision), ``mesh`` (None; the ranks are the
    process group's, A3), ``dp_input`` (True), ``row_slice_threshold``
    (None, A4), ``gpu_embedding_size`` (None, A8), ``hot_rows`` (A7),
    ``exchange_wire`` / ``storage_dtype`` (f32, A6) and ``vocab_slack``
    (A12): any other value raises NotImplementedError naming its item.
    """

    def __init__(self,
                 embeddings: Sequence,
                 strategy: str = "auto",
                 column_slice_threshold: Optional[int] = None,
                 row_slice_threshold: Optional[int] = None,
                 dp_input: bool = True,
                 input_table_map: Optional[Sequence[int]] = None,
                 data_parallel_threshold: Optional[int] = None,
                 gpu_embedding_size: Optional[int] = None,
                 mesh=None,
                 world_size: Optional[int] = None,
                 input_max_hotness: Optional[Sequence[Optional[int]]] = None,
                 use_custom_kernel: bool = True,
                 compute_dtype=None,
                 hot_rows: Optional[int] = None,
                 exchange_wire: Optional[str] = None,
                 vocab_slack: Optional[int] = None,
                 storage_dtype: Optional[str] = None,
                 *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 lookup_path: str = "auto"):
        super().__init__()
        if lookup_path not in LOOKUP_PATHS:
            raise ValueError(f"lookup_path must be one of {LOOKUP_PATHS}, "
                             f"got {lookup_path!r}")
        if not use_custom_kernel:
            raise NotImplementedError(
                "use_custom_kernel=False has no counterpart in the port: its "
                "lookups run their hand-written kernels on the card and never "
                "fall back (ROADMAP, North star: no silent fallback)")
        check_compute_dtype(compute_dtype, "DistributedEmbedding")
        if mesh is not None:
            raise NotImplementedError(
                "a mesh is not ported (ROADMAP Queue A3, multi-GPU "
                "exchange): the port's ranks are a torch.distributed "
                "process group; start one with "
                "parallel.mesh.initialize_distributed and leave mesh=None")
        world = pg.world_size()
        if world_size is not None and world_size != world:
            raise ValueError(
                f"world_size={world_size}, but the process group has "
                f"{world} rank(s); start one with "
                "parallel.mesh.initialize_distributed")
        unported = [
            (not dp_input, "dp_input=False", "A4 (remaining placement)"),
            (row_slice_threshold is not None, "row slicing",
             "A4 (remaining placement)"),
            (gpu_embedding_size is not None, "host offload "
             "(gpu_embedding_size)", "A8 (offload)"),
            (bool(hot_rows), "hot_rows", "A7 (hot-row replication)"),
            (exchange_wire not in (None, "f32"), "a non-f32 exchange_wire",
             "A6 (wire formats and quantized storage)"),
            (storage_dtype not in (None, "f32"), "a non-f32 storage_dtype",
             "A6 (wire formats and quantized storage)"),
            (bool(vocab_slack), "vocab_slack", "A12 (store and vocab)"),
            (world > 1 and data_parallel_threshold is not None,
             "the data-parallel group (data_parallel_threshold) at world "
             "size > 1", "A4 (remaining placement)"),
        ]
        for hit, what, item in unported:
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP Queue {item})")
        self.device = resolve_device(device)
        self.world_size = world
        self.rank = pg.rank()
        # the dp and row groups stay empty: no threshold reaches the
        # planner (world size 1 plans pure table-parallel, like the
        # reference)
        self.strategy = DistEmbeddingStrategy(
            embeddings, self.world_size, strategy,
            input_table_map=input_table_map,
            column_slice_threshold=column_slice_threshold,
            input_hotness=input_max_hotness)
        self.plan: ShardedPlan = lower_strategy(self.strategy)
        if world > 1 and len(self.plan.tp_placements) > len(
                self.strategy.table_groups[1]):
            raise NotImplementedError(
                "column slicing at world size > 1 is not ported yet (ROADMAP "
                "Queue A4 (remaining placement)); the plan slices a table "
                "into columns when there are fewer tables than ranks or "
                "with column_slice_threshold")
        for gtid in self.strategy.table_groups[1]:
            cls = self.strategy.global_configs[gtid].get("layer_class")
            if _overrides_forward(cls):
                raise ValueError(
                    f"table {gtid}: layer class {cls.__name__} overrides "
                    "forward, but the fused bucket lookup implements plain "
                    "gather+combine; set `det_gather_semantics = True` on "
                    "the class if its forward is a plain gather+combine")
        self.input_max_hotness = (list(input_max_hotness)
                                  if input_max_hotness is not None else None)
        self._n_inputs = len(self.strategy.input_table_map)
        self._groups_cache: dict = {}
        self.lookup_path = lookup_path
        # True while a train step's forward runs inside
        # `residual_sort_scope`: tapped forwards carry their groups' sorts
        self._fold_sort = False
        self.tp = nn.ParameterList([
            nn.Parameter(torch.empty((max(b.rows_max, 1), b.width),
                                     dtype=torch.float32, device=self.device),
                         requires_grad=False)
            for b in self.plan.tp_buckets])
        self.init(generator)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Fill this rank's bucket tables in place on its device: each
        fused table's segment from its own table's initializer, the rows
        past this rank's tables with zeros. A layer on the ``meta`` device
        (plan introspection only) holds nothing to fill."""
        if self.device.type == "meta":
            return
        gen = default_generator(self.device, generator)
        for b, bucket in enumerate(self.plan.tp_buckets):
            tbl = self.tp[b]
            for (_, row_offset, rows, init_spec,
                 _) in bucket.init_segments[self.rank]:
                get_initializer(init_spec)(tbl[row_offset:row_offset + rows],
                                           gen)
            tbl[bucket.rows[self.rank]:].zero_()

    # ----------------------------------------------------------- input prep
    def _prepare_one(self, x, max_hotness: Optional[int]) -> _PreparedInput:
        dev = self.device
        if isinstance(x, tuple) and len(x) == 2 and not isinstance(
                x, RaggedIds):
            ids = torch.as_tensor(x[0], device=dev)
            weights = torch.as_tensor(x[1], dtype=torch.float32, device=dev)
            return _PreparedInput(ids, weights, False, ids.shape[1])
        if isinstance(x, RaggedIds):
            if max_hotness is None:
                raise ValueError(
                    "RaggedIds input requires input_max_hotness")
            x = RaggedIds(torch.as_tensor(x.values, device=dev),
                          torch.as_tensor(x.row_splits, device=dev))
            ids, weights = embedding_ops.ragged_to_padded(x, max_hotness)
            return _PreparedInput(ids, weights, False, max_hotness)
        if isinstance(x, SparseIds):
            batch, k = int(x.dense_shape[0]), int(x.dense_shape[1])
            values = torch.as_tensor(x.values, device=dev)
            idx = torch.as_tensor(x.indices, device=dev).long()
            ids = torch.zeros((batch, k), dtype=values.dtype, device=dev)
            ids[idx[:, 0], idx[:, 1]] = values
            weights = torch.zeros((batch, k), dtype=torch.float32, device=dev)
            weights[idx[:, 0], idx[:, 1]] = 1.0
            return _PreparedInput(ids, weights, False, k)
        ids = torch.as_tensor(x, device=dev)
        if ids.dim() == 1:
            return _PreparedInput(ids[:, None], None, True, 1)
        if ids.dim() != 2:
            raise ValueError(
                f"Expected 1-D or 2-D ids, got shape {tuple(ids.shape)}")
        return _PreparedInput(ids, None, False, ids.shape[1])

    def _prepare_inputs(self, inputs) -> List[_PreparedInput]:
        if len(inputs) != self._n_inputs:
            raise ValueError(
                f"Expected {self._n_inputs} inputs, got {len(inputs)}")
        prepped = []
        for i, x in enumerate(inputs):
            mh = (self.input_max_hotness[i]
                  if self.input_max_hotness is not None else None)
            prepped.append(self._prepare_one(x, mh))
        return prepped

    def _id_dtype(self, b: int) -> torch.dtype:
        """int32 ids like the JAX package, int64 where offset ids of this
        bucket could pass the int32 range."""
        rows = self.plan.tp_buckets[b].rows_max
        return torch.int32 if rows < 2**31 else torch.int64

    def _exchange_groups(self, tp_prep: Sequence[_PreparedInput]):
        """The (bucket, hotness) exchange groups and the per-input assembly
        map for a set of prepared inputs (cached per hotness/weights
        signature)."""
        key = tuple((p.k, p.weights is not None) for p in tp_prep)
        return self._exchange_groups_for_key(key)

    def _exchange_groups_for_key(self, key):
        hit = self._groups_cache.get(key)
        if hit is not None:
            return hit
        world = self.world_size
        per_bk: dict = {}   # (bucket, k) -> per-rank [(slot_idx, TPSlot)...]
        order: List[Tuple[int, int]] = []
        for b, bucket in enumerate(self.plan.tp_buckets):
            for r, slots in enumerate(bucket.slots):
                for j, s in enumerate(slots):
                    k = key[s.tp_input][0]
                    if (b, k) not in per_bk:
                        per_bk[(b, k)] = [[] for _ in range(world)]
                        order.append((b, k))
                    per_bk[(b, k)][r].append((j, s))
        groups: List[_ExchangeGroup] = []
        slot_map: dict = {}  # (bucket, rank, slot_idx_in_bucket) -> (g, j_g)
        for g, (b, k) in enumerate(order):
            ranks = per_bk[(b, k)]
            class_inputs = sorted({s.tp_input for lst in ranks
                                   for (_, s) in lst})
            pos = {i: c for c, i in enumerate(class_inputs)}
            f_max = max(len(lst) for lst in ranks)
            sel = np.zeros((world, f_max), np.int32)
            offs = np.zeros((world, f_max), np.int64)
            for r, lst in enumerate(ranks):
                for j_g, (j, s) in enumerate(lst):
                    sel[r, j_g] = pos[s.tp_input]
                    offs[r, j_g] = s.row_offset
                    slot_map[(b, r, j)] = (g, j_g)
            need_w = any(key[i][1] for i in class_inputs)
            groups.append(_ExchangeGroup(b, k, class_inputs, sel, offs,
                                         f_max, need_w, self._id_dtype(b),
                                         self.device, self.rank))
        assembly = [
            [(rank, *slot_map[(bb, rank, jj)]) for (rank, bb, jj) in slots]
            for slots in self.plan.tp_input_slots
        ]
        self._groups_cache[key] = res = (groups, assembly)
        return res

    # ---------------------------------------------------------- sort folding
    @contextlib.contextmanager
    def residual_sort_scope(self, enabled: bool = True,
                            optimizer: Optional[str] = None,
                            strategy: str = "auto"):
        """Within the scope, tapped forwards (``return_residuals=True``)
        sort each exchange group's id stream once wherever the sorted
        lookups or the sparse update will consume it, and carry the sorts
        in `TapResiduals.tp_sort`; ``enabled=False`` turns folding off.
        `make_sparse_train_step` wraps its forward in it (``fold_sort``).
        As in the JAX package, (`optimizer`, `strategy`) say whether the
        update consumes a sort (`sparse_update.update_consumes_sort`: the
        dense routes do not); None assumes it does. Re-entrant, not
        thread-safe."""
        prev = self._fold_sort
        self._fold_sort = (optimizer, strategy) if enabled else False
        try:
            yield self
        finally:
            self._fold_sort = prev

    def _fwd_tiled_active(self, bucket, k: int) -> bool:
        """Does `_group_lookup` take a sorted lookup ("tiled" or "fused")
        for this (bucket, hotness)? Both consume the group's sort (its
        sid and perm)."""
        if self.lookup_path not in ("tiled", "fused"):
            return False
        return bucket.combiner is not None or k == 1

    def _sort_plan(self, groups) -> List[bool]:
        """Per exchange group: does the tapped forward sort its id stream
        (`canonical_id_sort`: sid, perm and segment starts)? Yes for a
        sorted lookup, and for the sparse update of a one-group bucket; a
        bucket whose update concatenates several groups gets no sort for
        it alone: one group's sort cannot serve the concatenated stream."""
        if not self._fold_sort:
            return [False] * len(groups)
        kind, strategy = self._fold_sort
        per_bucket: dict = {}
        for grp in groups:
            per_bucket[grp.bucket] = per_bucket.get(grp.bucket, 0) + 1

        def update_sorts(b):
            if kind is None:
                return True
            return update_consumes_sort(kind, strategy, *self.tp[b].shape)
        return [self._fwd_tiled_active(self.plan.tp_buckets[grp.bucket],
                                       grp.k)
                or (per_bucket[grp.bucket] == 1 and update_sorts(grp.bucket))
                for grp in groups]

    # --------------------------------------------------------------- lookup
    def _group_lookup(self, table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor],
                      combiner: Optional[str],
                      presorted: Optional[GroupSort] = None) -> torch.Tensor:
        """Local fused-bucket lookup: ids [B, f, k] -> [B, f, wf]. A
        combined group ('sum': `_tp_group_out` has already folded mean into
        the weights or the scale) is one gather-combine kernel launch, or
        under lookup_path "tiled" / "fused" one sorted lookup, which takes
        the group's `presorted` sort (its sid and perm) when the forward
        made one; the combiner-None passthrough is a plain gather
        (at hotness 1 the combined paths take it as a sum, the same
        result)."""
        b_sz, f, k = ids.shape
        path = self.lookup_path
        if combiner is None and k == 1 and path in ("pallas", "tiled",
                                                    "fused"):
            combiner = "sum"
        if combiner is not None and path in ("tiled", "fused"):
            lookup = (cuda_tiled.fused_lookup_combine if path == "fused"
                      else cuda_tiled.tiled_embedding_lookup)
            w = (weights if weights is not None
                 else torch.ones(ids.shape, dtype=torch.float32,
                                 device=ids.device))
            ps = (None if presorted is None
                  else (presorted.sid, presorted.perm))
            out = lookup(table, ids.reshape(b_sz * f, k),
                         w.reshape(b_sz * f, k), combiner, presorted=ps)
            return out.reshape(b_sz, f, out.shape[-1])
        if combiner is None:
            rows = table[ids.clamp(0, table.shape[0] - 1)]   # [B, f, k, w]
            return _combine(rows, None, None)
        w = None if weights is None else weights.reshape(b_sz * f, k)
        if table.requires_grad and torch.is_grad_enabled():
            # the dense step (`training.make_train_step`): the kernel with
            # the JAX package's `_fused_bwd` as its backward
            out = cuda_lookup.fused_embedding_lookup(
                table, ids.reshape(b_sz * f, k), w)
            return out.reshape(b_sz, f, out.shape[-1])
        out = cuda_lookup.lookup_combine(
            table, ids.reshape(b_sz * f, k).contiguous(),
            None if w is None else w.contiguous())
        return out.reshape(b_sz, f, out.shape[-1])

    def _tp_group_out(self, grp: _ExchangeGroup, ids_x: torch.Tensor,
                      w_x: Optional[torch.Tensor],
                      presorted: Optional[GroupSort] = None) -> torch.Tensor:
        """One exchange group's bucket output [B, f, w_out], via the
        explicit weighted-sum form: effective weights into the kernel, the
        unweighted-mean scale applied after the sum."""
        bucket = self.plan.tp_buckets[grp.bucket]
        eff_w, scale = _effective_weights(w_x, grp.k, bucket.combiner)
        out = self._group_lookup(self.tp[grp.bucket], ids_x, eff_w,
                                 None if bucket.combiner is None else "sum",
                                 presorted=presorted)
        if scale != 1.0:
            out = out * scale
        return out

    def _padded_id_exchange(self, grp: _ExchangeGroup, ids: torch.Tensor,
                            w: Optional[torch.Tensor]):
        """Fixed-shape dp->mp id (+weight) exchange: the group's member
        inputs selected into the send block [world, B_l, f_max, k],
        destination-major (block r holds rank r's slots), through
        `wire.wire_id_all_to_all` (weights through `wire.wire_all_to_all`).
        The blocks arrive source-major, so flattening them gives the
        global batch in order: [B, f_max, k]. At world size 1 the
        selection alone."""
        world, b_l = self.world_size, ids.shape[0]
        ids_x = ids.index_select(1, grp.sel_t)
        w_x = None if w is None else w.index_select(1, grp.sel_t)
        if world == 1:
            return ids_x, w_x
        bucket = self.plan.tp_buckets[grp.bucket]

        def block(x):
            return x.reshape(b_l, world, grp.f_max, grp.k).transpose(0, 1)
        ids_x = wire.wire_id_all_to_all(block(ids_x), bucket.id_wire_dtype)
        if w_x is not None:
            w_x = wire.wire_all_to_all(block(w_x), bucket.wire_dtype)
            w_x = w_x.reshape(-1, grp.f_max, grp.k)
        return ids_x.reshape(-1, grp.f_max, grp.k), w_x

    def _tp_bucket_exchange(self, out: torch.Tensor,
                            wire_dtype: str = "f32") -> torch.Tensor:
        """mp->dp movement of one group's output blocks [world_dst, B_l, f,
        wf] -> [world_src, B_l, f, wf] through `wire.wire_all_to_all`,
        whose backward moves the gradients back; the identity at world
        size 1."""
        if self.world_size == 1:
            return out
        return wire.wire_all_to_all(out, wire_dtype)

    def _forward_local(self, group_ids, group_w, groups, taps=None,
                       res_ids=None, res_w=None, res_sort=None,
                       sort_plan=None) -> List[torch.Tensor]:
        """Per exchange group: id exchange, row-offset add, fused lookup
        over the global batch, exchange back. Returns per group the
        [world_src, B_l, f_max, wf] block. With `taps`, each mp-side
        output, [world_dst, B_l, f_max, wf], is detached into a leaf that
        requires grad and appended to ``taps["tp"]`` before it is
        exchanged; with `res_ids`/`res_w`/`res_sort`, the group's absolute
        ids, effective weights and its `GroupSort` (where its `sort_plan`
        entry asks for one, else None) are appended there."""
        ex_list = []
        for g, grp in enumerate(groups):
            bucket = self.plan.tp_buckets[grp.bucket]
            ids_x, w_x = self._padded_id_exchange(grp, group_ids[g],
                                                  group_w[g])
            ids_x = ids_x + grp.offs_t[None, :, None]
            sort_g = None
            if sort_plan is not None and sort_plan[g]:
                sort_g = canonical_id_sort(ids_x, max(bucket.rows_max, 1))
            out = self._tp_group_out(grp, ids_x, w_x, presorted=sort_g)
            out = out.reshape((self.world_size, -1) + tuple(out.shape[1:]))
            if taps is not None:
                out = out.detach().requires_grad_()
                taps["tp"].append(out)
            if res_ids is not None:
                eff_w, _ = _effective_weights(w_x, grp.k, bucket.combiner)
                res_ids.append(ids_x[None])
                res_w.append(None if eff_w is None else eff_w[None])
                res_sort.append(sort_g)
            ex_list.append(self._tp_bucket_exchange(out, bucket.wire_dtype))
        return ex_list

    def forward(self, inputs: Sequence, taps=None,
                return_residuals: bool = False):
        """Forward pass with data-parallel input: one [B_l] / [B_l, k] id
        array per feature (numpy or tensor), RaggedIds, SparseIds or
        (ids, weights) tuples, B_l this rank's slice of the global batch
        (the whole batch at world size 1). Returns one [B_l, width] tensor
        per input (or [B_l, k, width] for combiner=None multi-hot), in
        input order. Collective at world size > 1: every rank calls it,
        with the same batch size.

        taps: the container from `make_taps`. The forward fills
        ``taps["tp"]`` with one leaf per exchange group, the group's
        mp-side output over the global batch, ``[world, B_l, f_max,
        w_out]``, detached from the (gradient-free) tables and requiring
        grad, so that autograd delivers at each leaf the gradient the JAX
        package reads at its zero tap on this rank.
        return_residuals: also return the `TapResiduals` for
        `sparse_update`, as ``(outputs, residuals)``; inside
        `residual_sort_scope` they carry the groups' sorts."""
        if taps is not None:
            taps["tp"].clear()
            taps["row"].clear()
        prepped = self._prepare_inputs(inputs)
        strat = self.strategy
        batch = prepped[0].ids.shape[0]
        tp_prep = [prepped[i] for i in strat.input_groups[1]]

        # stack tp inputs per exchange group: [B, n_g, k_g] (+ weights where
        # any member input carries them)
        groups, assembly = ([], [])
        group_ids: List[torch.Tensor] = []
        group_w: List[Optional[torch.Tensor]] = []
        if tp_prep:
            groups, assembly = self._exchange_groups(tp_prep)
            for grp in groups:
                members = [tp_prep[i] for i in grp.class_inputs]
                dt = self._id_dtype(grp.bucket)
                group_ids.append(torch.stack(
                    [p.ids.to(dt) for p in members], dim=1))
                if grp.need_w:
                    group_w.append(torch.stack(
                        [(p.weights if p.weights is not None
                          else torch.ones((batch, p.k), dtype=torch.float32,
                                          device=self.device))
                         for p in members], dim=1))
                else:
                    group_w.append(None)

        res_ids = [] if return_residuals else None
        res_w = [] if return_residuals else None
        res_sort = [] if return_residuals else None
        sort_plan = self._sort_plan(groups) if return_residuals else None
        ex_list = self._forward_local(group_ids, group_w, groups, taps,
                                      res_ids, res_w, res_sort, sort_plan)
        outputs = self._assemble_tp_outputs(ex_list, tp_prep, batch, groups,
                                            assembly)
        outputs = [outputs[idx] for idx in strat.rev_group_ids]
        if return_residuals:
            key = tuple((p.k, p.weights is not None) for p in tp_prep)
            return outputs, TapResiduals(key, res_ids, res_w, res_sort)
        return outputs

    def _assemble_tp_outputs(self, ex_list, tp_preps, batch, groups,
                             assembly) -> List[torch.Tensor]:
        """Slice the group outputs back into per-input arrays: reorder by
        slot, re-concat column slices."""
        strat = self.strategy
        tp_final = []
        # one unbind per (group, rank) block: its backward is one stack,
        # where a slice per input would add a zero-filled block per input
        columns: dict = {}
        for i, p in enumerate(tp_preps):
            parts = []
            for (rank, g, j_g) in assembly[i]:
                grp = groups[g]
                bucket = self.plan.tp_buckets[grp.bucket]
                if (g, rank) not in columns:
                    columns[(g, rank)] = ex_list[g][rank].unbind(1)
                part = columns[(g, rank)][j_g]              # [B, wf]
                if bucket.combiner is None:
                    part = part.reshape(batch, grp.k, bucket.width)
                parts.append(part)
            out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            cfg = strat.global_configs[
                strat.table_groups[1][strat.map_groups[1][i]]]
            tp_final.append(self._restore_shape(out, p, cfg.get("combiner"),
                                                out.shape[-1]))
        return tp_final

    @staticmethod
    def _restore_shape(out, p: _PreparedInput, combiner, width):
        if combiner is not None:
            return out
        # combiner None: canonical shape [B, k, w]; 1-D inputs drop the axis
        if out.dim() == 2:
            out = out.reshape(out.shape[0], -1, width)
        if p.orig_1d:
            out = out[:, 0, :]
        return out

    # ------------------------------------------------- sparse training path
    def make_taps(self, inputs) -> dict:
        """The tap container for ``forward(inputs, taps=...)``: ``{"tp":
        [], "row": []}``. The JAX package returns zero arrays
        ``[world, B, f_max_g, w_out]`` that its forward adds to each group
        output; here the forward fills ``taps["tp"]`` with the rank's
        mp-side group outputs themselves, made leaves (the tables need no
        grad), whose ``.grad`` after backward is this rank's block of the
        tap gradient, reshaped ``[world, B_l, f_max_g, w_out]``. Saves a
        pass over a zeros tensor per group."""
        if len(inputs) != self._n_inputs:
            raise ValueError(
                f"Expected {self._n_inputs} inputs, got {len(inputs)}")
        return {"tp": [], "row": []}

    def init_sparse_state(self, opt: SparseOptimizer) -> dict:
        """Sparse-optimizer state for the bucket tables: ``{"tp":
        [opt.init(table) per bucket], "row": []}``. Table-shaped state
        (adagrad's accumulator, adam's moments) is allocated directly on
        the tables' device at bucket shape ``[rows_max, w]``."""
        return {"tp": [opt.init(t.data) for t in self.tp], "row": []}

    def _group_contrib(self, g: int, grp: _ExchangeGroup, res_tp_ids,
                       res_tp_w, tp_g) -> SparseRowGrad:
        """One exchange group's SparseRowGrad from the residual ids and
        effective weights and the tap gradient ``[world, B_l, f,
        w_out]``."""
        bucket = self.plan.tp_buckets[grp.bucket]
        ids_x = res_tp_ids[g][0]                       # [B, f, k]
        gtap = tp_g[g].reshape(tuple(ids_x.shape[:2]) + (-1,))  # [B, f, w]
        k, wf = grp.k, bucket.width
        lead = tuple(gtap.shape[:-1])
        if bucket.combiner is None:
            gk = gtap.reshape(lead + (k, wf))
        else:
            gk = gtap[..., None, :]
        eff = res_tp_w[g]
        if eff is None:
            _, scale = _effective_weights(None, k, bucket.combiner)
            gk = gk.float()
            if scale != 1.0:
                gk = gk * scale
            contrib = gk.expand(tuple(ids_x.shape) + (wf,))
        else:
            contrib = gk.float() * eff[0][..., None]
        return SparseRowGrad(ids_x.reshape(-1),
                             contrib.reshape(-1, wf).contiguous())

    @torch.no_grad()
    def sparse_update(self, opt_states: dict, tap_grads: dict,
                      residuals: TapResiduals,
                      opt: SparseOptimizer) -> dict:
        """Row-wise sparse optimizer step for this rank's bucket tables, IN
        PLACE (the JAX package returns new, donated arrays): per bucket, the
        SparseRowGrads of its exchange groups are concatenated and handed
        to ``opt.update``, which dedups them and updates each touched row
        of the table and its state once; a bucket of one group passes the
        group's sort from the residuals as ``presorted=`` when the forward
        made one. `tap_grads` is ``{"tp": [grad of each taps["tp"] leaf],
        "row": []}``. Returns the new state pytree (adam's step count is a
        new tuple entry; tensors are updated in place)."""
        groups, _ = self._exchange_groups_for_key(residuals.key)
        bucket_groups: dict = {}
        for g, grp in enumerate(groups):
            bucket_groups.setdefault(grp.bucket, []).append(g)
        new_tp = list(opt_states["tp"])
        for b, gs in bucket_groups.items():
            grads = [self._group_contrib(g, groups[g], residuals.tp_ids,
                                         residuals.tp_w, tap_grads["tp"])
                     for g in gs]
            sort_b = (residuals.tp_sort[gs[0]]
                      if len(gs) == 1 and residuals.tp_sort else None)
            # the keyword only with an artifact: an update callable of three
            # arguments keeps working wherever nothing was folded
            kw = {} if sort_b is None else {"presorted": sort_b}
            _, new_tp[b] = opt.update(self.tp[b].data, tuple(new_tp[b]),
                                      concat_grads(grads), **kw)
        return {**opt_states, "tp": new_tp}

    # --------------------------------------------------------- weights I/O
    # rows of a bucket gathered per collective: at most this many elements
    # over all ranks (the JAX package's DET_GATHER_CHUNK_ELEMS default)
    GATHER_CHUNK_ELEMS = 128 * 1024 * 1024

    def get_weights(self, all_ranks: bool = False
                    ) -> Optional[List[np.ndarray]]:
        """Global per-table weights in original table order, as numpy.

        Collective at world size > 1: every rank calls it. Each bucket's
        ``[world, rows_max, w]`` stack is gathered in row chunks of at most
        `GATHER_CHUNK_ELEMS` elements (`parallel.mesh.gather_stack`), one
        bucket at a time, and each chunk's rows are copied out to the
        tables on the host. With `all_ranks` False (the reference's
        default) only rank 0 assembles and returns the weights; the other
        ranks take part in the gathers and return None."""
        strat = self.strategy
        keep = all_ranks or self.rank == 0
        out: List[Optional[np.ndarray]] = [None] * len(strat.global_configs)
        if keep:
            for t_local, gtid in enumerate(strat.table_groups[1]):
                cfg = strat.global_configs[gtid]
                out[gtid] = np.empty((cfg["input_dim"], cfg["output_dim"]),
                                     np.float32)
        world = self.world_size
        for b, table in enumerate(self.tp):
            table = table.detach()
            rows, width = table.shape
            chunk = max(1, self.GATHER_CHUNK_ELEMS // max(world * width, 1))
            places = [p for p in self.plan.tp_placements if p.bucket == b]
            for r0 in range(0, rows, chunk):
                r1 = min(rows, r0 + chunk)
                stack = pg.gather_stack(table[r0:r1])
                if not keep:
                    continue
                host = stack.cpu().numpy()
                for pl_ in places:
                    lo = max(r0, pl_.row_offset)
                    hi = min(r1, pl_.row_offset + pl_.rows)
                    if lo >= hi:
                        continue
                    gtid = strat.table_groups[1][pl_.table_id]
                    out[gtid][lo - pl_.row_offset:hi - pl_.row_offset,
                              pl_.col_start:pl_.col_end] = \
                        host[pl_.rank, lo - r0:hi - r0]
        return out if keep else None

    @torch.no_grad()
    def set_weights(self, weights: Sequence) -> None:
        """Write global per-table weights (numpy arrays, tensors or .npy
        paths, which are memory-mapped) into this rank's bucket tables in
        place: every rank passes the same list and writes its own
        placements only."""
        strat = self.strategy
        if len(weights) != len(strat.global_configs):
            raise ValueError(f"Expected {len(strat.global_configs)} weights, "
                             f"got {len(weights)}")
        weights = [np.load(w, mmap_mode="r") if isinstance(w, str) else w
                   for w in weights]
        for w, cfg in zip(weights, strat.global_configs):
            expect = (cfg["input_dim"], cfg["output_dim"])
            if tuple(w.shape) != expect:
                raise ValueError(
                    f"Weight shape {tuple(w.shape)} != expected {expect}")
        for pl_ in self.plan.tp_placements:
            if pl_.rank != self.rank:
                continue
            w = weights[strat.table_groups[1][pl_.table_id]]
            src = torch.from_numpy(np.array(
                w[:, pl_.col_start:pl_.col_end], dtype=np.float32, order="C"))
            self.tp[pl_.bucket][pl_.row_offset:pl_.row_offset
                                + pl_.rows].copy_(src)


def _local_tables(module: nn.Module) -> set:
    """The ids of the rank-local bucket tables of every
    `DistributedEmbedding` inside `module`."""
    return {id(t) for m in module.modules()
            if isinstance(m, DistributedEmbedding) for t in m.tp}


@torch.no_grad()
def broadcast_variables(variables, root_rank: int = 0):
    """Rank `root_rank`'s values of `variables` on every rank, in place
    (the reference's broadcast of the initial data-parallel weights,
    which skips the model-parallel ones). `variables`: a module, whose
    parameters and buffers are broadcast except the rank-local bucket
    tables of its `DistributedEmbedding` layers, or a sequence of
    tensors. Collective: every rank calls it. Returns `variables`; at
    world size 1, untouched."""
    if pg.world_size() == 1:
        return variables
    if isinstance(variables, nn.Module):
        local = _local_tables(variables)
        tensors = [t for t in list(variables.parameters())
                   + list(variables.buffers()) if id(t) not in local]
    else:
        tensors = list(variables)
    for t in tensors:
        dist.broadcast(t.data, src=root_rank)
    return variables
