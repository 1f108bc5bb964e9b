"""Distributed embedding: planned, fused table-parallel lookups.

Counterpart of ``distributed_embeddings_tpu/layers/dist_model_parallel.py``
`DistributedEmbedding`, as an ``nn.Module`` that owns its fused bucket
tables. This slice covers world size 1 with data-parallel input: every
table sits in the table-parallel group, tables of one (width, combiner)
key are fused into one bucket, and the forward runs one gather-combine per
(bucket, hotness) exchange group through the CUDA kernel of
`ops.cuda_lookup` (its plain version when the tables are on the CPU).

The group structure is the JAX package's: inputs of one bucket and hotness
are stacked into ``[B, f, k]``, their row offsets inside the fused table
are added, one lookup serves the whole group, and the ``[1, B, f, w]``
result (the rank-0 block of the mp->dp exchange) is sliced back into
per-input outputs. Multi-GPU exchange, offload, hot rows and quantized
storage come in later slices (ROADMAP Queue A) and raise
NotImplementedError here.

Training: a tapped forward (`make_taps`, ``forward(taps=...,
return_residuals=True)``) makes each group output a leaf of the autograd
graph, whose ``.grad`` is the JAX package's tap gradient; `sparse_update`
turns those into row-wise table updates through `ops.sparse_update`.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from distributed_embeddings_tpu_torch.layers.embedding import Embedding
from distributed_embeddings_tpu_torch.ops import cuda_lookup, embedding_ops
from distributed_embeddings_tpu_torch.ops.embedding_ops import (RaggedIds,
                                                                SparseIds)
from distributed_embeddings_tpu_torch.ops.sparse_update import (
    SparseOptimizer, SparseRowGrad, concat_grads)
from distributed_embeddings_tpu_torch.parallel.plan import (ShardedPlan,
                                                            lower_strategy)
from distributed_embeddings_tpu_torch.parallel.planner import (
    DistEmbeddingStrategy)
from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           default_generator,
                                                           resolve_device)
from distributed_embeddings_tpu_torch.utils.initializers import (
    get_initializer)

__all__ = ["DistEmbeddingStrategy", "DistributedEmbedding", "TapResiduals"]


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
    offset add, ``tp_ids[g]`` ``[world, B, f_g, k_g]``, and the effective
    combine weights ``tp_w[g]`` (None = uniform; the scale is recomputed
    from the group). `key` is the exchange-group cache key. The JAX
    package's sort-folding and row-sliced fields are not ported (ROADMAP
    Queue A2, A4)."""

    __slots__ = ("key", "tp_ids", "tp_w")

    def __init__(self, key, tp_ids, tp_w):
        self.key = key
        self.tp_ids = tp_ids
        self.tp_w = tp_w


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
    planning constants; `sel_t`/`offs_t` their rank-0 rows on the device."""

    __slots__ = ("bucket", "k", "class_inputs", "sel", "offs", "f_max",
                 "need_w", "sel_t", "offs_t")

    def __init__(self, bucket, k, class_inputs, sel, offs, f_max, need_w,
                 id_dtype, device):
        self.bucket = bucket
        self.k = k
        self.class_inputs = class_inputs
        self.sel = sel
        self.offs = offs
        self.f_max = f_max
        self.need_w = need_w
        self.sel_t = torch.as_tensor(sel[0], dtype=torch.int64, device=device)
        self.offs_t = torch.as_tensor(offs[0], dtype=id_dtype, device=device)


class DistributedEmbedding(nn.Module):
    """Plans placement for a list of embedding tables and runs their fused
    lookups.

    Args mirror the JAX package's class. ``device`` (None = cuda) is where
    the fused bucket tables live; ``generator`` draws their initial values
    (default: seed 0 on `device`). Parameters: ``tp[b]`` is bucket b's fused
    table ``[rows_max, width]`` (the JAX package's ``params['tp'][b][0]``).
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
                 hot_rows: Optional[int] = None,
                 exchange_wire: Optional[str] = None,
                 vocab_slack: Optional[int] = None,
                 storage_dtype: Optional[str] = None,
                 *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        unported = [
            (mesh is not None or (world_size or 1) > 1,
             "world size > 1 or a mesh", "A3 (multi-GPU exchange)"),
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
        ]
        for hit, what, item in unported:
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP Queue {item})")
        self.device = resolve_device(device)
        self.world_size = 1
        # world size 1: pure table-parallel, like the reference; the dp and
        # row groups are empty by construction
        self.strategy = DistEmbeddingStrategy(
            embeddings, self.world_size, strategy,
            input_table_map=input_table_map,
            column_slice_threshold=column_slice_threshold,
            input_hotness=input_max_hotness)
        self.plan: ShardedPlan = lower_strategy(self.strategy)
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
        self.tp = nn.ParameterList([
            nn.Parameter(torch.empty((max(b.rows_max, 1), b.width),
                                     dtype=torch.float32, device=self.device),
                         requires_grad=False)
            for b in self.plan.tp_buckets])
        self.init(generator)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Fill every bucket table in place on its device: each fused
        table's segment from its own table's initializer. A layer on the
        ``meta`` device (plan introspection only) holds nothing to fill."""
        if self.device.type == "meta":
            return
        gen = default_generator(self.device, generator)
        for b, bucket in enumerate(self.plan.tp_buckets):
            tbl = self.tp[b]
            for (_, row_offset, rows, init_spec,
                 _) in bucket.init_segments[0]:
                get_initializer(init_spec)(tbl[row_offset:row_offset + rows],
                                           gen)
            tbl[bucket.rows[0]:].zero_()

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
                                         self.device))
        assembly = [
            [(rank, *slot_map[(bb, rank, jj)]) for (rank, bb, jj) in slots]
            for slots in self.plan.tp_input_slots
        ]
        self._groups_cache[key] = res = (groups, assembly)
        return res

    # --------------------------------------------------------------- lookup
    def _group_lookup(self, table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor],
                      combiner: Optional[str]) -> torch.Tensor:
        """Local fused-bucket lookup: ids [B, f, k] -> [B, f, wf]. A
        combined group ('sum': `_tp_group_out` has already folded mean into
        the weights or the scale) is one gather-combine kernel launch; the
        combiner-None passthrough is a plain gather."""
        b_sz, f, k = ids.shape
        if combiner is None:
            rows = table[ids.clamp(0, table.shape[0] - 1)]   # [B, f, k, w]
            return _combine(rows, None, None)
        w = None if weights is None else weights.reshape(b_sz * f, k)
        out = cuda_lookup.lookup_combine(
            table, ids.reshape(b_sz * f, k).contiguous(),
            None if w is None else w.contiguous())
        return out.reshape(b_sz, f, out.shape[-1])

    def _tp_group_out(self, grp: _ExchangeGroup, ids_x: torch.Tensor,
                      w_x: Optional[torch.Tensor]) -> torch.Tensor:
        """One exchange group's bucket output [B, f, w_out], via the
        explicit weighted-sum form: effective weights into the kernel, the
        unweighted-mean scale applied after the sum."""
        bucket = self.plan.tp_buckets[grp.bucket]
        eff_w, scale = _effective_weights(w_x, grp.k, bucket.combiner)
        out = self._group_lookup(self.tp[grp.bucket], ids_x, eff_w,
                                 None if bucket.combiner is None else "sum")
        if scale != 1.0:
            out = out * scale
        return out

    def _padded_id_exchange(self, grp: _ExchangeGroup, ids: torch.Tensor,
                            w: Optional[torch.Tensor]):
        """The dp->mp id (+weight) exchange at world size 1: select the
        group's member inputs into this rank's slot order, [B, f_max, k]."""
        ids_x = ids.index_select(1, grp.sel_t)
        w_x = None if w is None else w.index_select(1, grp.sel_t)
        return ids_x, w_x

    def _forward_local(self, group_ids, group_w, groups, taps=None,
                       res_ids=None, res_w=None) -> List[torch.Tensor]:
        """Per exchange group: id exchange, row-offset add, fused lookup.
        Returns per group the [world_src=1, B, f_max, wf] output block.
        With `taps`, each block is detached into a leaf that requires grad
        and appended to ``taps["tp"]``; with `res_ids`/`res_w`, the group's
        absolute ids and effective weights are appended there."""
        ex_list = []
        for g, grp in enumerate(groups):
            ids_x, w_x = self._padded_id_exchange(grp, group_ids[g],
                                                  group_w[g])
            ids_x = ids_x + grp.offs_t[None, :, None]
            out = self._tp_group_out(grp, ids_x, w_x)[None]
            if taps is not None:
                out = out.detach().requires_grad_()
                taps["tp"].append(out)
            if res_ids is not None:
                bucket = self.plan.tp_buckets[grp.bucket]
                eff_w, _ = _effective_weights(w_x, grp.k, bucket.combiner)
                res_ids.append(ids_x[None])
                res_w.append(None if eff_w is None else eff_w[None])
            ex_list.append(out)
        return ex_list

    def forward(self, inputs: Sequence, taps=None,
                return_residuals: bool = False):
        """Forward pass with data-parallel input: one [B] / [B, k] id
        array per feature (numpy or tensor), RaggedIds, SparseIds or
        (ids, weights) tuples. Returns one [B, width] tensor per input (or
        [B, k, width] for combiner=None multi-hot), in input order.

        taps: the container from `make_taps`. The forward fills
        ``taps["tp"]`` with one leaf per exchange group, the group's
        ``[1, B, f_max, w_out]`` output, detached from the (gradient-free)
        tables and requiring grad, so that autograd delivers at each leaf
        the gradient the JAX package reads at its zero tap.
        return_residuals: also return the `TapResiduals` for
        `sparse_update`, as ``(outputs, residuals)``."""
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
        ex_list = self._forward_local(group_ids, group_w, groups, taps,
                                      res_ids, res_w)
        outputs = self._assemble_tp_outputs(ex_list, tp_prep, batch, groups,
                                            assembly)
        outputs = [outputs[idx] for idx in strat.rev_group_ids]
        if return_residuals:
            key = tuple((p.k, p.weights is not None) for p in tp_prep)
            return outputs, TapResiduals(key, res_ids, res_w)
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
        output; here the forward fills ``taps["tp"]`` with the group outputs
        themselves, made leaves (the tables need no grad), whose ``.grad``
        after backward is the tap gradient. Saves a pass over a zeros
        tensor per group."""
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
        effective weights and the tap gradient ``[1, B, f, w_out]``."""
        bucket = self.plan.tp_buckets[grp.bucket]
        ids_x = res_tp_ids[g][0]                       # [B, f, k]
        gtap = tp_g[g][0]                              # [B, f, w_out]
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
        """Row-wise sparse optimizer step for the bucket tables, IN PLACE
        (the JAX package returns new, donated arrays): per bucket, the
        SparseRowGrads of its exchange groups are concatenated and handed
        to ``opt.update``, which dedups them and updates each touched row
        of the table and its state once. `tap_grads` is ``{"tp": [grad of
        each taps["tp"] leaf], "row": []}``. Returns the new state pytree
        (adam's step count is a new tuple entry; tensors are updated in
        place)."""
        groups, _ = self._exchange_groups_for_key(residuals.key)
        bucket_groups: dict = {}
        for g, grp in enumerate(groups):
            bucket_groups.setdefault(grp.bucket, []).append(g)
        new_tp = list(opt_states["tp"])
        for b, gs in bucket_groups.items():
            grads = [self._group_contrib(g, groups[g], residuals.tp_ids,
                                         residuals.tp_w, tap_grads["tp"])
                     for g in gs]
            _, new_tp[b] = opt.update(self.tp[b].data, tuple(new_tp[b]),
                                      concat_grads(grads))
        return {**opt_states, "tp": new_tp}

    # --------------------------------------------------------- weights I/O
    def get_weights(self) -> List[np.ndarray]:
        """Global per-table weights in original table order, as numpy."""
        strat = self.strategy
        out: List[Optional[np.ndarray]] = [None] * len(strat.global_configs)
        for t_local, gtid in enumerate(strat.table_groups[1]):
            cols = []
            for pl_ in sorted((p for p in self.plan.tp_placements
                               if p.table_id == t_local),
                              key=lambda p: p.col_start):
                cols.append(self.tp[pl_.bucket].detach()[
                    pl_.row_offset:pl_.row_offset + pl_.rows].cpu().numpy())
            out[gtid] = (np.concatenate(cols, axis=1) if len(cols) > 1
                         else cols[0])
        return out

    @torch.no_grad()
    def set_weights(self, weights: Sequence) -> None:
        """Write global per-table weights (numpy arrays, tensors or .npy
        paths, which are memory-mapped) into the bucket tables in place."""
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
            w = weights[strat.table_groups[1][pl_.table_id]]
            src = torch.from_numpy(np.array(
                w[:, pl_.col_start:pl_.col_end], dtype=np.float32, order="C"))
            self.tp[pl_.bucket][pl_.row_offset:pl_.row_offset
                                + pl_.rows].copy_(src)
