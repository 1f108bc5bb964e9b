"""Distributed embedding: planned, fused table-parallel lookups.

Counterpart of ``distributed_embeddings_tpu/layers/dist_model_parallel.py``
`DistributedEmbedding`, as an ``nn.Module`` that owns its rank's share of
the tables, in the JAX package's three placement groups:

  * data-parallel (``dp``): tables at most ``data_parallel_threshold``
    elements, replicated on every rank; each input is a plain local
    gather and combine over the rank's slice of the batch (a table whose
    layer class overrides ``forward`` runs that forward instead);
  * table-parallel (``tp``): tables of one (width, combiner) key are fused
    into one bucket per rank (column slices of a table may land on several
    ranks and in buckets of other widths), and the forward runs one
    gather-combine per (bucket, hotness) exchange group through the CUDA
    kernel of `ops.cuda_lookup` (its plain version when the tables are on
    the CPU), or, with ``lookup_path="tiled"`` or ``"fused"``, through the
    sorted-stream lookups of `ops.cuda_tiled`;
  * row-sliced (``row``): tables of at least ``row_slice_threshold``
    elements, split by rows over the ranks; each input's ids (and
    weights) are all-gathered, every rank looks up the ids that fall in
    its rows (the rest masked to weight 0) over the global batch with
    `ops.cuda_lookup`, and a reduce-scatter sums the partial outputs back
    to each rank's slice of the batch.

The tp group structure is the JAX package's: inputs of one bucket and
hotness are stacked into ``[B_l, f, k]``, moved dp->mp as ``[world, B_l,
f_max, k]`` blocks (`ops.wire.wire_id_all_to_all`), their row offsets
inside the fused table are added, one lookup serves the whole group over
the global batch, and the ``[world, B_l, f_max, w]`` result goes back
mp->dp (`ops.wire.wire_all_to_all`, whose backward carries the gradients
back) and is sliced into per-input outputs, the column slices of a table
read from their ranks' blocks and concatenated. At world size 1 the
exchanges are the identity, and, as in the JAX package, both thresholds
are ignored (every table table-parallel); so they are with
``dp_input=False``, where each rank passes the ids of its own features
at global batch size and the dp->mp exchange is skipped. The ranks are
those of the default ``torch.distributed`` process group
(`parallel.mesh.initialize_distributed`); with data-parallel input each
rank passes its own slice of the global batch
(`parallel.staging.stage_dp_batch`). Every exchange
takes its bucket's (or row table's) wire formats, ``wire_dtype`` and
``id_wire_dtype`` (`ops.wire`; ``exchange_wire`` picks the float one).

Host offload (``gpu_embedding_size=N``, the JAX package's offloaded
buckets, the reference's tables on ``/CPU:0``): the planner flags the
largest tables past a device budget of N elements; they form buckets of
their own (`offloaded_buckets`), which live in host memory and never on the
card: on a CUDA layer ``tp[b]`` (with ``tp_scale[b]`` and the optimizer
state) is a page-locked CPU tensor of exactly its size (`HostPin`), on a
CPU layer a plain one. ``.to()`` and ``.cuda()`` leave them where they
are. An offloaded group's ids cross the exchange on the card as every
group's do; then they come to the host, clamped into the bucket, and the
rows are gathered (decoded, at a quantized storage), combined in float32
into a pinned staging buffer and copied to the card without blocking
(`_offload_group_out`, the profiler range `OFFLOAD_LOOKUP_RANGE`); the
cast, the unweighted mean's scale and the tap follow on the card. The
sparse update deduplicates the bucket's rows on the card
(`ops.sparse_update.prepare_safe_grad`) and applies them to the host
buffers in place (`ops.sparse_update.host_apply_rows_inplace`, range
`OFFLOAD_UPDATE_RANGE`; a quantized bucket decodes its touched rows,
applies the rule and re-encodes them with stochastic rounding).

Hot rows (``hot_rows=H``, data-parallel input; the JAX package's hot
shard): each combined bucket keeps a replicated hot shard, the buffers
``hot_ids_{b}`` (its membership, flat keys ``rank * rows_max + row``
sorted and padded with the sentinel ``world * rows_max``) and
``hot_rows_{b}`` ``[H, w]``. A tp group of a hot bucket splits its send
block against the membership before the exchange: hit lanes are served
on the dp side from the hot rows, the misses take the exchange and the
lookup, and the hot rows train through their own taps, a dense sum over
the ranks and the optimizer's masked rule. `sync_hot_rows` writes them
back and admits a new set (`observe_hot_ids`' trackers, or given keys);
`get_weights` overlays them.

Quantized storage (``storage_dtype`` "int8" or "fp8", the JAX package's
HBM-resident quantized buckets): each tp bucket holds a 1-byte payload,
``tp[b]`` (``torch.int8`` or ``torch.float8_e4m3fn``), and a float32
per-row scale, ``tp_scale[b]`` ``[rows_max, 1]`` (`ops.wire`'s codec);
row-sliced and dp tables stay float32. A quantized bucket's lookup is the
JAX package's explicit form for it, whatever ``lookup_path`` says: the
payload rows and their scales gathered, decoded to float32, cast to the
compute dtype, combined (`_combine`). Its sparse update is
`ops.sparse_update.quantized_row_update` (sgd and adagrad; adam refuses):
decode the touched rows, the float32 rule, a stochastically rounded
re-encode. `init` and `set_weights` encode row chunks, rounding to nearest;
`get_weights` decodes to float32.

Mixed precision (``compute_dtype`` bfloat16 or float16; the JAX package's
policy): the tables, their optimizer state and the sums of the lookups stay
float32, and every output, every activation on the wire and every tap is
in the compute dtype, rounded where the JAX package rounds. The tp groups
take its kernel route: `lookup_combine` stores the compute dtype (the TPU
kernel, then one cast); the dp group and the row shards take its XLA
route: the gathered rows (and, in a row shard's kernel, the weights) are
rounded first, then combined in float32 and rounded once. The mean scale
of an unweighted group is rounded to the compute dtype before it
multiplies, as ``out * jnp.asarray(scale, out.dtype)`` does.

Training: a tapped forward (`make_taps`, ``forward(taps=...,
return_residuals=True)``) makes each tp group's mp-side output and each
row input's partial output a leaf of the autograd graph, whose ``.grad``
is the JAX package's tap gradient on the owning rank; `sparse_update`
turns those into row-wise updates of this rank's tp buckets and row
shards through `ops.sparse_update`. The dp tables require grad and train
with the dense parameters. Inside `residual_sort_scope` (the train
step's, with ``fold_sort``), a tapped forward sorts each exchange group's
id stream once (`embedding_ops.canonical_id_sort`); the sorted lookups and
the sparse update of a one-group bucket (or a one-input row table)
consume that sort instead of sorting again.
"""

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function

from distributed_embeddings_tpu_torch.layers.embedding import Embedding
from distributed_embeddings_tpu_torch.ops import (cuda_lookup, cuda_tiled,
                                                  embedding_ops, wire)
from distributed_embeddings_tpu_torch.ops.embedding_ops import (
    GroupSort, RaggedIds, SparseIds, canonical_id_sort)
from distributed_embeddings_tpu_torch.ops.sparse_update import (
    HOST_APPLY_KINDS, QUANTIZED_ROW_KINDS, SparseOptimizer, SparseRowGrad,
    _dense_sum, concat_grads, host_apply_rows_inplace, prepare_safe_grad,
    update_consumes_sort)
from distributed_embeddings_tpu_torch.parallel import mesh as pg
from distributed_embeddings_tpu_torch.parallel.plan import (ShardedPlan,
                                                            lower_strategy)
from distributed_embeddings_tpu_torch.parallel.planner import (
    DistEmbeddingStrategy)
from distributed_embeddings_tpu_torch.utils.device import (
    DeviceLike, HostPin, default_generator, pinned_empty,
    resolve_compute_dtype, resolve_device)
from distributed_embeddings_tpu_torch.utils.hotness import HotnessTracker
from distributed_embeddings_tpu_torch.utils.initializers import (
    ConcatInitializer, get_initializer)

__all__ = ["DistEmbeddingStrategy", "DistributedEmbedding", "TapResiduals",
           "LOOKUP_PATHS", "QUANTIZED_LOOKUP_RANGE", "HOT_SPLIT_RANGE",
           "HOT_GATHER_RANGE", "HOT_UPDATE_RANGE", "OFFLOAD_LOOKUP_RANGE",
           "OFFLOAD_UPDATE_RANGE", "broadcast_variables"]

# the profiler range of every quantized bucket's lookup (a no-op unless a
# profiler is on), so a trace reads its device time
QUANTIZED_LOOKUP_RANGE = "quantized:lookup"
# the hot split's ranges, likewise: the membership split of a send block,
# the hit lanes' gather and combine, a hot bucket's update
HOT_SPLIT_RANGE = "hot:split"
HOT_GATHER_RANGE = "hot:gather"
HOT_UPDATE_RANGE = "hot:update"
# the host halves of an offloaded bucket: its lookup (ids to the host, the
# gather and combine, the copy back) and its update's host apply
OFFLOAD_LOOKUP_RANGE = "offload:lookup"
OFFLOAD_UPDATE_RANGE = "offload:update"

# the JAX package's DET_LOOKUP_PATH values: "auto", "xla" and "pallas" take
# the gather-combine kernel, "tiled" and "fused" the sorted-stream lookups
LOOKUP_PATHS = ("auto", "xla", "pallas", "tiled", "fused")


def _combine(emb: torch.Tensor, weights: Optional[torch.Tensor],
             combiner: Optional[str]) -> torch.Tensor:
    """Reduce the hotness axis (second-to-last) of `emb` [..., K, w];
    weights [..., K] carry 0 for padded slots, mean divides by the
    (weighted) count. As XLA computes it for the JAX package: rows of a
    16-bit float type are summed (or weighted by the weights rounded to
    their type) in float32 and rounded once, and the weighted mean's
    divisor is rounded to their type."""
    if combiner is None:
        return emb.reshape(emb.shape[:-2] + (emb.shape[-2] * emb.shape[-1],))
    acc = emb.float()
    if weights is None:
        if combiner == "sum":
            return acc.sum(dim=-2).to(emb.dtype)
        return acc.mean(dim=-2).to(emb.dtype)
    out = torch.einsum("...k,...kw->...w", weights.to(emb.dtype).float(),
                       acc).to(emb.dtype)
    if combiner == "mean":
        denom = weights.sum(dim=-1).clamp_min(1.0).to(out.dtype)
        out = out / denom[..., None]
    return out


def _scaled(out: torch.Tensor, scale: float) -> torch.Tensor:
    """``out * scale`` with the scale rounded to a 16-bit `out`'s dtype
    first (the JAX package's ``out * jnp.asarray(scale, out.dtype)``): a
    Python float would multiply in float32 and round once."""
    if scale == 1.0:
        return out
    if out.dtype == torch.float32:
        return out * scale
    return out * torch.full((), scale, dtype=out.dtype, device=out.device)


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
    otherwise, and the update sorts afresh); per row-sliced input the
    shard-local ids over the global batch, ``row_ids[j]`` ``[1, B, k]``,
    with ``rows_max`` (past the shard) where the id is not this rank's,
    their effective weights ``row_w[j]`` (the scale folded in) and
    ``row_sort[j]``. Per exchange group of a hot bucket, the hot split's
    ``hot_pos[g]`` ``[1, world, B_l, f_g, k_g]`` (each lane's position in
    the hot shard, H on a miss) and ``hot_w[g]`` (its effective hit
    weight, 0 on a miss), None for other groups (and the lists None
    without hot groups). `key` is the exchange-group cache key."""

    __slots__ = ("key", "tp_ids", "tp_w", "tp_sort", "row_ids", "row_w",
                 "row_sort", "hot_pos", "hot_w")

    def __init__(self, key, tp_ids, tp_w, tp_sort=None, row_ids=(),
                 row_w=(), row_sort=None, hot_pos=None, hot_w=None):
        self.key = key
        self.tp_ids = tp_ids
        self.tp_w = tp_w
        self.tp_sort = tp_sort
        self.row_ids = list(row_ids)
        self.row_w = list(row_w)
        self.row_sort = row_sort
        self.hot_pos = hot_pos
        self.hot_w = hot_w


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
    planning constants and `counts` the slots each rank fills; on the
    device, `sel_t` is `sel` flattened destination-major (the send
    block's member order) and `offs_t` this rank's row of `offs`.
    `hot_meta`: the hot split's constants of a hot bucket's group
    (`DistributedEmbedding._hot_group_meta`), else None."""

    __slots__ = ("bucket", "k", "class_inputs", "sel", "offs", "counts",
                 "f_max", "need_w", "sel_t", "offs_t", "hot_meta")

    def __init__(self, bucket, k, class_inputs, sel, offs, counts, f_max,
                 need_w, id_dtype, device, rank):
        self.bucket = bucket
        self.k = k
        self.class_inputs = class_inputs
        self.sel = sel
        self.offs = offs
        self.counts = counts
        self.f_max = f_max
        self.need_w = need_w
        self.sel_t = torch.as_tensor(sel.reshape(-1), dtype=torch.int64,
                                     device=device)
        self.offs_t = torch.as_tensor(offs[rank], dtype=id_dtype,
                                      device=device)
        self.hot_meta = None


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
    collective, and so is building it (the dp tables are broadcast from
    rank 0). Parameters: ``dp[j]``, the j-th data-parallel table ``[V,
    w]``, the same on every rank and trained densely (it requires grad);
    ``tp[b]``, this rank's shard of bucket b, ``[rows_max, width]`` (the
    JAX package's ``params['tp'][b][rank]``); ``row[t]``, this rank's
    rows of row-sliced table t, ``[rows_max, width]``, the rows past
    ``rows_per_rank[rank]`` zero (``params['row'][t][rank]``). With a
    quantized ``storage_dtype`` ("int8" or "fp8"), ``tp[b]`` is bucket b's
    1-byte payload and ``tp_scale[b]`` its per-row float32 scale, ``[rows_max,
    1]`` (``params['tp_scale'][b][rank]``; see the module docstring).

    With ``dp_input=False`` the forward takes model-parallel input (the
    JAX package's `apply_mp`; see `forward`). ``compute_dtype`` (None or
    float32, bfloat16, float16, under any name `resolve_compute_dtype`
    takes) is the dtype of the outputs, the exchanged activations and the
    taps; the tables stay float32 (see the module docstring).

    ``exchange_wire`` (None = "f32", "bf16", "bf16-sr") is the float wire
    of the combined buckets and row tables; ``hot_rows`` (with
    ``dp_input=True``) the hot shard's capacity a combined bucket (see
    the module docstring). ``gpu_embedding_size`` is the device budget
    in elements of the table-parallel tables: the tables past it are
    offloaded to host memory (see the module docstring).

    Arguments of the JAX package that the port takes at their defaults
    only: ``use_custom_kernel`` (True; False, the JAX package's XLA
    lookup, has no counterpart: the port's lookups never fall back, ROADMAP
    North star), ``mesh`` (None; the ranks are the
    process group's, A3) and
    ``vocab_slack`` (A12): any other value raises NotImplementedError
    naming its item.
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
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
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
        if vocab_slack:
            raise NotImplementedError(
                "vocab_slack is not ported yet (ROADMAP Queue A12 (store and "
                "vocab))")
        self.device = resolve_device(device)
        self.world_size = world
        self.rank = pg.rank()
        self.dp_input = dp_input
        # as in the JAX package: a single rank plans pure table-parallel,
        # and model-parallel input leaves the dp and row groups empty
        if world > 1 and dp_input:
            row_thr, dp_thr = row_slice_threshold, data_parallel_threshold
        else:
            row_thr, dp_thr = None, None
        self.strategy = DistEmbeddingStrategy(
            embeddings, self.world_size, strategy,
            input_table_map=input_table_map,
            column_slice_threshold=column_slice_threshold,
            row_slice_threshold=row_thr,
            data_parallel_threshold=dp_thr,
            gpu_embedding_size=gpu_embedding_size,
            input_hotness=input_max_hotness,
            hot_rows=(hot_rows if dp_input else 0),
            exchange_wire=exchange_wire,
            storage_dtype=storage_dtype)
        if self.strategy.table_groups[1] and not all(
                self.strategy.local_configs):
            raise ValueError(
                "Not enough tables after slicing to run on all devices. "
                "Try decreasing column_slice_threshold or device count.")
        self.plan: ShardedPlan = lower_strategy(self.strategy)
        for group in (1, 2):
            for gtid in self.strategy.table_groups[group]:
                cls = self.strategy.global_configs[gtid].get("layer_class")
                if _overrides_forward(cls):
                    raise ValueError(
                        f"table {gtid}: custom embedding layer class "
                        f"{cls.__name__} overrides forward, but it was "
                        "placed in a fused model-parallel group whose lookup "
                        "implements plain gather+combine; raise "
                        "data_parallel_threshold so the table is "
                        "data-parallel (custom forwards run there), or set "
                        "`det_gather_semantics = True` on the class if its "
                        "forward is a plain gather+combine")
        self.input_max_hotness = (list(input_max_hotness)
                                  if input_max_hotness is not None else None)
        self._n_inputs = len(self.strategy.input_table_map)
        self._groups_cache: dict = {}
        self.lookup_path = lookup_path
        # True while a train step's forward runs inside
        # `residual_sort_scope`: tapped forwards carry their groups' sorts
        self._fold_sort = False
        # host offload: the pins of the offloaded buckets' page-locked
        # tensors (a CUDA layer's), and the bytes their lookups and updates
        # moved between the host and the card
        self._host_pins: List[HostPin] = []
        self._offload_enabled = any(b.offload for b in self.plan.tp_buckets)
        self.offload_traffic = {"htod_bytes": 0, "dtoh_bytes": 0}
        self.dp = nn.ParameterList([
            nn.Parameter(torch.empty((cfg["input_dim"], cfg["output_dim"]),
                                     dtype=torch.float32, device=self.device))
            for cfg in self.strategy.dp_configs])
        self.tp = nn.ParameterList([
            nn.Parameter(self._bucket_empty(
                b, (max(bk.rows_max, 1), bk.width),
                wire.payload_dtype(bk.storage_dtype)), requires_grad=False)
            for b, bk in enumerate(self.plan.tp_buckets)])
        # the per-row scales of the quantized buckets (an empty [0, 1]
        # placeholder at a float32 bucket's index)
        if self.quantized_buckets:
            self.tp_scale = nn.ParameterList([
                nn.Parameter(self._bucket_empty(
                    b, (max(bk.rows_max, 1) if bk.storage_dtype != "f32"
                        else 0, 1), torch.float32), requires_grad=False)
                for b, bk in enumerate(self.plan.tp_buckets)])
        self.row = nn.ParameterList([
            nn.Parameter(torch.empty((max(rt.rows_max, 1), rt.width),
                                     dtype=torch.float32, device=self.device),
                         requires_grad=False)
            for rt in self.plan.row_tables])
        # the hot shards (hot-row replication): per hot bucket b, buffers
        # ``hot_ids_{b}`` [H] int32, the sorted membership keys padded with
        # the sentinel, and ``hot_rows_{b}`` [H, w] float32, the same on
        # every rank; the trackers are made lazily by observe_hot_ids /
        # sync_hot_rows
        self._hot_buckets = [b for b, bk in enumerate(self.plan.tp_buckets)
                             if bk.hot_rows > 0]
        for b in self._hot_buckets:
            bk = self.plan.tp_buckets[b]
            self.register_buffer(f"hot_ids_{b}", torch.empty(
                (bk.hot_rows,), dtype=torch.int32, device=self.device))
            self.register_buffer(f"hot_rows_{b}", torch.empty(
                (bk.hot_rows, bk.width), dtype=torch.float32,
                device=self.device))
        self._hot_trackers: dict = {}
        # dp tables whose layer class overrides forward run that forward
        # on their table (the JAX package's `_dp_custom_layers`); the
        # layers are not submodules: the table is `dp[j]` itself
        self._dp_custom_layers = {}
        for j, gtid in enumerate(self.strategy.table_groups[0]):
            cfg = self.strategy.global_configs[gtid]
            cls = cfg.get("layer_class")
            if _overrides_forward(cls):
                layer = cls.from_config(
                    {k: v for k, v in cfg.items() if k != "layer_class"})
                layer.embeddings = self.dp[j]
                self._dp_custom_layers[j] = layer
        self.init(generator)

    # --------------------------------------------------------------- storage
    @property
    def quantized_buckets(self) -> List[int]:
        """The buckets whose rows are stored quantized."""
        return [b for b, bk in enumerate(self.plan.tp_buckets)
                if bk.storage_dtype != "f32"]

    @property
    def offloaded_buckets(self) -> List[int]:
        """The buckets that live in host memory (``gpu_embedding_size``;
        the JAX package's ``plan.tp_buckets[b].offload``)."""
        return [b for b, bk in enumerate(self.plan.tp_buckets) if bk.offload]

    def _host_empty(self, shape, dtype, held: bool = True) -> torch.Tensor:
        """An uninitialized host tensor: page-locked, of exactly its size,
        on a CUDA layer, plain on a CPU layer. With `held` (a table) the
        layer keeps its `HostPin` for its own life; else (optimizer state,
        which each train step's init makes anew) the registration goes
        with the tensor (`pinned_empty`)."""
        if self.device.type != "cuda":
            return torch.empty(shape, dtype=dtype)
        if not held:
            return pinned_empty(shape, dtype)
        pin = HostPin(shape, dtype)
        self._host_pins.append(pin)
        return pin.tensor

    def _bucket_empty(self, b: int, shape, dtype) -> torch.Tensor:
        """Uninitialized storage for bucket b: in host memory for an
        offloaded bucket (on a layer with real storage), on the layer's
        device otherwise."""
        if self.plan.tp_buckets[b].offload and self.device.type != "meta":
            return self._host_empty(shape, dtype)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _bucket_tensor(self, b: int, t: torch.Tensor) -> torch.Tensor:
        """Optimizer state `t` where bucket b's tensors live: a copy in host
        memory for an offloaded bucket (`_host_empty`), on the layer's
        device otherwise."""
        if self.plan.tp_buckets[b].offload:
            return self._host_empty(tuple(t.shape), t.dtype,
                                    held=False).copy_(t)
        return t.to(self.device)

    def pinned_host_bytes(self) -> int:
        """The bytes this layer holds page-locked: its offloaded buckets'
        tables and scales, on a CUDA layer (their optimizer state is the
        train step's)."""
        return sum(pin.nbytes for pin in self._host_pins if pin.ptr)

    def _host_params(self) -> List[Tuple[nn.ParameterList, str]]:
        """(list, key) of every parameter that lives on the host: the
        offloaded buckets' tables and scales."""
        lists = [self.tp] + ([self.tp_scale] if self.quantized_buckets
                             else [])
        return [(lst, str(b)) for lst in lists for b in self.offloaded_buckets]

    def _apply(self, fn, recurse=True):
        """`nn.Module._apply` (``.to()``, ``.cuda()``, ``.half()``, ...)
        with the offloaded buckets held out: they stay in host memory."""
        held = [(lst, key, lst._parameters.pop(key))
                for lst, key in self._host_params()]
        try:
            return super()._apply(fn, recurse)
        finally:
            for lst, key, param in held:
                lst._parameters[key] = param

    def _bucket_store_dtype(self, b: int) -> str:
        """Bucket b's storage dtype ('f32', 'int8' or 'fp8')."""
        return self.plan.tp_buckets[b].storage_dtype

    def _bucket_scale(self, b: int) -> Optional[torch.Tensor]:
        """Bucket b's per-row scale, None at float32 storage. A quantized
        bucket without its scale fails loudly (the JAX package's
        `_bucket_scale`): reading its payload as float32 would serve the
        codes as embedding values."""
        if self._bucket_store_dtype(b) == "f32":
            return None
        scales = getattr(self, "tp_scale", None)
        scale = None if scales is None else scales[b]
        if scale is None or scale.shape[0] != self.tp[b].shape[0]:
            raise ValueError(
                f"bucket {b} stores {self._bucket_store_dtype(b)} rows but "
                "the layer holds no tp_scale for it: the state drifted from "
                "the plan (rebuild it through init or set_weights)")
        return scale

    # rows encoded at once by a quantized bucket's `init` and `set_weights`:
    # at most this many elements (a float32 block of 256 MiB), so no
    # bucket-sized float32 copy exists
    ENCODE_CHUNK_ELEMS = 64 * 1024 * 1024

    def _encode_into(self, b: int, row0: int, block: torch.Tensor) -> None:
        """Encode the float32 rows `block` (round to nearest) into quantized
        bucket b from row `row0` on."""
        payload, scale = wire.encode_rows(block.to(self.device),
                                          self._bucket_store_dtype(b))
        self.tp[b][row0:row0 + block.shape[0]].copy_(payload)
        self.tp_scale[b][row0:row0 + block.shape[0]].copy_(scale)

    def _init_quantized(self, b: int, gen: torch.Generator) -> None:
        """Fill quantized bucket b: each table's rows drawn by its
        initializer in chunks of at most `ENCODE_CHUNK_ELEMS` elements and
        encoded (the encode is row-local, so the chunks change no bit of
        it); the rows past this rank's tables payload 0, scale 1, the
        encoding of zero rows. Shape-dependent initializers see the whole
        table's shape (``table_shape``, `utils.initializers`)."""
        self.tp[b].view(torch.uint8).zero_()
        self.tp_scale[b].fill_(1.0)
        self._init_chunks(b, gen, lambda row0, block: self._encode_into(
            b, row0, block))

    def _init_host_f32(self, b: int, gen: torch.Generator) -> None:
        """Fill float32 offloaded bucket b of a CUDA layer: its rows drawn
        on the card in chunks of at most `ENCODE_CHUNK_ELEMS` elements
        and copied down (a host generator over tens of gigabytes would
        take minutes); the rows past this rank's tables zero."""
        tbl = self.tp[b].data
        tbl[self.plan.tp_buckets[b].rows[self.rank]:].zero_()
        self._init_chunks(b, gen, lambda row0, block: tbl[
            row0:row0 + block.shape[0]].copy_(block))

    def _init_chunks(self, b: int, gen: torch.Generator, write) -> None:
        """Draw bucket b's tables on the layer's device in row chunks of at
        most `ENCODE_CHUNK_ELEMS` elements, each handed to ``write(row0,
        block)``."""
        bucket = self.plan.tp_buckets[b]
        chunk = max(1, self.ENCODE_CHUNK_ELEMS // bucket.width)
        for (_, offset, rows, spec,
             _) in bucket.init_segments[self.rank]:
            parts = ([(offset + sum(spec.sizes[:i]), n, spec._initializer)
                      for i, n in enumerate(spec.sizes)]
                     if isinstance(spec, ConcatInitializer)
                     else [(offset, rows, get_initializer(spec))])
            for start, n, init in parts:
                for r0 in range(0, n, chunk):
                    block = torch.empty((min(n, r0 + chunk) - r0,
                                         bucket.width), dtype=torch.float32,
                                        device=self.device)
                    block.table_shape = (n, bucket.width)
                    init(block, gen)
                    write(start + r0, block)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Fill this rank's tables in place on its device, each from its
        own table's initializer: the dp tables, then each fused bucket
        table's segments (the rows past this rank's tables zero), then the
        rank's rows of each row-sliced table (its padding rows zero). At
        world size > 1 the dp tables are then broadcast from rank 0, so
        every rank starts from the same replicas (collective). A layer on
        the ``meta`` device (plan introspection only) holds nothing to
        fill."""
        if self.device.type == "meta":
            return
        gen = default_generator(self.device, generator)
        for table, cfg in zip(self.dp, self.strategy.dp_configs):
            get_initializer(cfg.get("embeddings_initializer", "uniform"))(
                table.data, gen)
        for b, bucket in enumerate(self.plan.tp_buckets):
            if bucket.storage_dtype != "f32":
                self._init_quantized(b, gen)
                continue
            if bucket.offload and self.device.type != "cpu":
                self._init_host_f32(b, gen)
                continue
            tbl = self.tp[b]
            for (_, row_offset, rows, init_spec,
                 _) in bucket.init_segments[self.rank]:
                get_initializer(init_spec)(tbl[row_offset:row_offset + rows],
                                           gen)
            tbl[bucket.rows[self.rank]:].zero_()
        for table, rt in zip(self.row, self.plan.row_tables):
            rows = rt.rows_per_rank[self.rank]
            get_initializer(rt.initializer)(table.data[:rows], gen)
            table.data[rows:].zero_()
        self._reset_hot()
        if self.world_size > 1:
            for table in self.dp:
                dist.broadcast(table.data, src=0)

    # -------------------------------------------------- hot-row replication
    def _hot_sentinel(self, b: int) -> int:
        """Bucket b's membership sentinel: one past the flat key space
        ``world * rows_max`` (no (rank, row) key reaches it, and sentinel
        padding keeps the membership sorted)."""
        return self.world_size * max(self.plan.tp_buckets[b].rows_max, 1)

    def _hot_entry(self, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hot bucket b's (membership [H] int32, rows [H, w] float32)."""
        return getattr(self, f"hot_ids_{b}"), getattr(self, f"hot_rows_{b}")

    @torch.no_grad()
    def _reset_hot(self) -> None:
        """Empty every hot shard: all-sentinel membership (every lookup
        misses, as on a layer without hot rows) and zero rows."""
        for b in self._hot_buckets:
            ids, rows = self._hot_entry(b)
            ids.fill_(self._hot_sentinel(b))
            rows.zero_()

    def hot_resident_rows(self) -> dict:
        """{bucket: (sorted valid int64 keys [n], rows [n, w])} as numpy:
        the hot-resident rows of each hot bucket, authoritative while
        resident (the source of `get_weights`' overlay). Empty on a layer
        without hot rows, and for a bucket with none resident."""
        out = {}
        for b in self._hot_buckets:
            ids, rows = self._hot_entry(b)
            keys = ids.detach().cpu().numpy().astype(np.int64)
            valid = (keys >= 0) & (keys < self._hot_sentinel(b))
            if valid.any():
                out[b] = (keys[valid], rows.detach().cpu().numpy()[valid])
        return out

    def _hot_tracker(self, b: int) -> HotnessTracker:
        tr = self._hot_trackers.get(b)
        if tr is None:
            tr = HotnessTracker(self.plan.tp_buckets[b].hot_rows,
                                promote_threshold=1)
            self._hot_trackers[b] = tr
        return tr

    @staticmethod
    def _host_flat_ids(x) -> np.ndarray:
        """One input (dense ids, an (ids, weights) tuple, RaggedIds or
        SparseIds; numpy or tensors) flattened to its id stream, int64
        numpy (a RaggedIds' values past ``row_splits[-1]`` left out)."""
        def host(a):
            return (a.detach().cpu().numpy() if torch.is_tensor(a)
                    else np.asarray(a))
        if isinstance(x, tuple) and len(x) == 2 and not isinstance(
                x, RaggedIds):
            x = x[0]
        if isinstance(x, RaggedIds):
            splits = host(x.row_splits).reshape(-1)
            x = host(x.values).reshape(-1)[int(splits[0]):int(splits[-1])]
        elif isinstance(x, SparseIds):
            x = x.values
        return host(x).reshape(-1).astype(np.int64)

    def observe_hot_ids(self, inputs) -> dict:
        """Host-side frequency observation for hot-row admission (the JAX
        package's `observe_hot_ids`): `inputs` are the forward's per-feature
        inputs (numpy or tensors); each valid id (within its slot's table
        rows, as the device split requires) counts toward its flat key
        ``rank * rows_max + row_offset + id`` in its bucket's tracker.
        Pure host work; at world size > 1 each rank observes what it is
        given (its slice of the batch), and `sync_hot_rows(admit=True)`
        admits rank 0's choice on every rank. Returns {bucket: hit rate}
        of the observed stream against each tracker's resident set."""
        if not self._hot_buckets:
            return {}
        per_bucket: dict = {b: [] for b in self._hot_buckets}
        seg_rows = {b: {(pl.rank, pl.row_offset): pl.rows
                        for pl in self.plan.tp_placements if pl.bucket == b}
                    for b in self._hot_buckets}
        for pos, i in enumerate(self.strategy.input_groups[1]):
            ids = self._host_flat_ids(inputs[i])
            for (rank, b, slot_idx) in self.plan.tp_input_slots[pos]:
                if b not in per_bucket:
                    continue
                bucket = self.plan.tp_buckets[b]
                off = bucket.slots[rank][slot_idx].row_offset
                rows = seg_rows[b].get((rank, off), 0)
                v = ids[(ids >= 0) & (ids < rows)]
                per_bucket[b].append(rank * max(bucket.rows_max, 1) + off + v)
        rates = {}
        for b, chunks in per_bucket.items():
            if not chunks:
                continue
            tr = self._hot_tracker(b)
            tr.lookup_slots(np.concatenate(chunks), observe=True)
            rates[b] = tr.hit_rate
        return rates

    def hot_keys_from_counts(self, counts: Sequence) -> dict:
        """Admission keys from per-input id frequencies: ``counts[i]`` a
        [rows] array for input i (truncated to its table's rows), or None.
        Keys shared by several inputs add up. Returns {bucket: the top-H
        keys by count, hottest first} for ``sync_hot_rows(new_keys=)``."""
        if len(counts) != self._n_inputs:
            raise ValueError(
                f"counts has {len(counts)} entries, expected "
                f"{self._n_inputs} (one per input)")
        agg: dict = {b: ([], []) for b in self._hot_buckets}
        for pos, i in enumerate(self.strategy.input_groups[1]):
            if counts[i] is None:
                continue
            c = np.asarray(counts[i], np.int64).reshape(-1)
            table = self.strategy.input_table_map[i]
            c = c[:int(self.strategy.global_configs[table]["input_dim"])]
            for (rank, b, slot_idx) in self.plan.tp_input_slots[pos]:
                if b not in agg:
                    continue
                bucket = self.plan.tp_buckets[b]
                off = bucket.slots[rank][slot_idx].row_offset
                agg[b][0].append(rank * max(bucket.rows_max, 1) + off
                                 + np.arange(len(c), dtype=np.int64))
                agg[b][1].append(c)
        out = {}
        for b, (keys_l, counts_l) in agg.items():
            if not keys_l:
                continue
            uniq, inv = np.unique(np.concatenate(keys_l),
                                  return_inverse=True)
            tot = np.zeros(len(uniq), np.int64)
            np.add.at(tot, inv, np.concatenate(counts_l))
            nz = tot > 0
            order = np.argsort(-tot[nz], kind="stable")[
                :self.plan.tp_buckets[b].hot_rows]
            out[b] = uniq[nz][order]
        return out

    def _broadcast_top_keys(self, new_keys: dict) -> dict:
        """Rank 0's admission keys on every rank: per hot bucket one [H +
        1] int64 broadcast (slot 0 flags whether rank 0 observed the
        bucket, the rest its keys padded with -1). Every rank's masks
        feeding the exchange then agree."""
        out = {}
        for b in self._hot_buckets:
            cap = self.plan.tp_buckets[b].hot_rows
            buf = np.full((cap + 1,), -1, np.int64)
            if b in new_keys:
                buf[0] = 1
                k = np.asarray(new_keys[b], np.int64).reshape(-1)[:cap]
                buf[1:1 + len(k)] = k
            t = torch.from_numpy(buf).to(self.device)
            dist.broadcast(t, src=0)
            buf = t.cpu().numpy()
            if buf[0] == 1:
                keys = buf[1:]
                out[b] = keys[keys >= 0]
        return out

    def _hot_local(self, b: int, keys: torch.Tensor):
        """(mask, local rows) of the flat `keys` that fall in this rank's
        shard of bucket b."""
        rows_max = max(self.plan.tp_buckets[b].rows_max, 1)
        keys = keys.long()
        mine = (keys >= self.rank * rows_max) & (
            keys < (self.rank + 1) * rows_max)
        return mine, keys[mine] - self.rank * rows_max

    def _hot_gather(self, b: int, table: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
        """Rows [H, w] of the rank-local `table` of bucket b at the flat
        `keys` (zero at sentinel keys), on every rank: each rank reads the
        keys in its shard, one all-gather at world size > 1, and each key's
        row taken from its owner's block (the values copied, not summed)."""
        rows_max = max(self.plan.tp_buckets[b].rows_max, 1)
        mine, local = self._hot_local(b, keys)
        part = torch.zeros((keys.shape[0], table.shape[1]),
                           dtype=table.dtype, device=table.device)
        part[mine] = table.index_select(0, local)
        if self.world_size == 1:
            return part
        stack = pg.gather_stack(part)                   # [world, H, w]
        owner = (keys.long() // rows_max).clamp(0, self.world_size - 1)
        return stack[owner, torch.arange(keys.shape[0],
                                         device=table.device)]

    @torch.no_grad()
    def sync_hot_rows(self, opt_states: Optional[dict] = None,
                      new_keys: Optional[dict] = None,
                      admit: bool = False) -> Optional[dict]:
        """The hot shards' consistency step (the JAX package's
        `sync_hot_rows`, in place where it returns new trees): while rows
        are hot-resident the hot shard (and its optimizer state) is
        authoritative for them, the canonical rows taking no gradient.

        1. Every resident row, and its table-shaped optimizer state rows
           (``opt_states["emb"]``-style ``{"tp": [...], "hot": [...]}``),
           is written back into its owner rank's bucket table.
        2. With `new_keys` ({bucket: flat keys}) or ``admit=True`` (the
           trackers' top keys from `observe_hot_ids`; at world size > 1
           rank 0's, broadcast to every rank), each bucket admits a new
           hot set: the keys deduplicated in caller order, truncated to H,
           sorted and padded with the sentinel; its rows and state rows
           gathered from the just-synced canonical tables, so admitting
           changes no value. The bucket's tracker takes the new resident
           set and restarts its hit statistics.

        Collective at world size > 1. Returns `opt_states` (its tensors
        updated in place; None stays None)."""
        if not self._hot_buckets:
            return opt_states
        if admit and new_keys is None:
            new_keys = {b: tr.top_keys()
                        for b, tr in self._hot_trackers.items()}
            if self.world_size > 1:
                new_keys = self._broadcast_top_keys(new_keys)
        hot_states = (list(opt_states.get("hot", []))
                      if opt_states is not None else [])
        for pos_h, b in enumerate(self._hot_buckets):
            ids, rows = self._hot_entry(b)
            h_cap = self.plan.tp_buckets[b].hot_rows
            sent = self._hot_sentinel(b)
            table = self.tp[b].data
            can_st = (list(opt_states["tp"][b]) if opt_states is not None
                      else [])
            hot_st = (list(hot_states[pos_h]) if pos_h < len(hot_states)
                      else [])
            mine, local = self._hot_local(b, ids)
            table.index_copy_(0, local, rows[mine])
            pairs = [(cx, hx) for cx, hx in zip(can_st, hot_st)
                     if torch.is_tensor(cx) and cx.dim() == 2]
            for cx, hx in pairs:
                cx.index_copy_(0, local, hx[mine])
            if new_keys is None or b not in new_keys:
                continue
            keys = np.asarray(new_keys[b], np.int64).reshape(-1)
            keys = keys[(keys >= 0) & (keys < sent)]
            _, first = np.unique(keys, return_index=True)
            keys = keys[np.sort(first)][:h_cap]
            pad = np.full((h_cap,), sent, np.int32)
            pad[:len(keys)] = np.sort(keys).astype(np.int32)
            ids.copy_(torch.from_numpy(pad))
            rows.copy_(self._hot_gather(b, table, ids))
            for cx, hx in pairs:
                hx.copy_(self._hot_gather(b, cx, ids))
            tr = self._hot_tracker(b)
            tr.set_resident(keys)
            tr.reset_stats()
        return opt_states

    def hot_stats(self) -> dict:
        """Per-bucket admission and hit statistics of the trackers ({}
        until `observe_hot_ids` or `sync_hot_rows` has run)."""
        return {b: tr.stats() for b, tr in self._hot_trackers.items()}

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

    @property
    def output_dtype(self) -> torch.dtype:
        """The dtype of the outputs: the compute dtype, else float32."""
        return self.compute_dtype or torch.float32

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        """A lookup result in the compute dtype (no-op without one)."""
        if self.compute_dtype is not None and x.dtype != self.compute_dtype:
            return x.to(self.compute_dtype)
        return x

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
            grp = _ExchangeGroup(
                b, k, class_inputs, sel, offs, [len(lst) for lst in ranks],
                f_max, need_w, self._id_dtype(b), self.device, self.rank)
            if b in self._hot_buckets:
                grp.hot_meta = self._hot_group_meta(grp)
            groups.append(grp)
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
        it alone: one group's sort cannot serve the concatenated stream.
        An offloaded group never (its lookup runs on the host, and its
        update's deduplication sorts afresh, as in the JAX package)."""
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
        return [not self.plan.tp_buckets[grp.bucket].offload
                and (self._fwd_tiled_active(self.plan.tp_buckets[grp.bucket],
                                            grp.k)
                     or (per_bucket[grp.bucket] == 1
                         and update_sorts(grp.bucket)))
                for grp in groups]

    def _row_sort_plan(self) -> List[bool]:
        """Per row-sliced input: does the tapped forward sort its shard-
        local id stream? Yes where its table's update consumes a sort and
        the table serves this input alone (a shared table's update
        concatenates its inputs' streams)."""
        n = len(self.strategy.input_groups[2])
        if not self._fold_sort:
            return [False] * n
        kind, strategy = self._fold_sort
        tables = self.strategy.map_groups[2]
        return [tables.count(t) == 1
                and (kind is None or update_consumes_sort(
                    kind, strategy, *self.row[t].shape))
                for t in tables]

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
            # float32 lookups, cast after (JAX :1389, :1412)
            return self._cast(out.reshape(b_sz, f, out.shape[-1]))
        if combiner is None:
            rows = table[ids.clamp(0, table.shape[0] - 1)]   # [B, f, k, w]
            return _combine(self._cast(rows), None, None)
        w = None if weights is None else weights.reshape(b_sz * f, k)
        if table.requires_grad and torch.is_grad_enabled():
            # the dense step (`training.make_train_step`): the kernel with
            # the JAX package's `_fused_bwd` as its backward
            out = cuda_lookup.fused_embedding_lookup(
                table, ids.reshape(b_sz * f, k), w, "sum", self.output_dtype)
            return out.reshape(b_sz, f, out.shape[-1])
        out = cuda_lookup.lookup_combine(
            table, ids.reshape(b_sz * f, k).contiguous(),
            None if w is None else w.contiguous(), self.output_dtype)
        return out.reshape(b_sz, f, out.shape[-1])

    def _tp_group_out(self, grp: _ExchangeGroup, ids_x: torch.Tensor,
                      w_x: Optional[torch.Tensor],
                      presorted: Optional[GroupSort] = None) -> torch.Tensor:
        """One exchange group's bucket output [B, f, w_out], via the
        explicit weighted-sum form: effective weights into the kernel, the
        unweighted-mean scale applied after the sum (in the output's
        dtype, `_scaled`)."""
        bucket = self.plan.tp_buckets[grp.bucket]
        eff_w, scale = _effective_weights(w_x, grp.k, bucket.combiner)
        combiner = None if bucket.combiner is None else "sum"
        if bucket.storage_dtype != "f32":
            out = self._quantized_lookup(grp.bucket, ids_x, eff_w, combiner)
        else:
            out = self._group_lookup(self.tp[grp.bucket], ids_x, eff_w,
                                     combiner, presorted=presorted)
        return _scaled(out, scale)

    def _to_host(self, *tensors: torch.Tensor) -> List[torch.Tensor]:
        """`tensors` of the card copied to pinned host tensors, and the
        host waits for them (the layer's device stream synchronized); on a
        CPU layer the tensors themselves. Counts the bytes as
        ``offload_traffic["dtoh_bytes"]``."""
        if self.device.type != "cuda":
            return list(tensors)
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            self.offload_traffic["dtoh_bytes"] += h.numel() * h.element_size()
            out.append(h)
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def _offload_group_out(self, grp: _ExchangeGroup, ids_x: torch.Tensor,
                           w_x: Optional[torch.Tensor]) -> torch.Tensor:
        """One offloaded group's bucket output [B, f, w_out] on the card
        (JAX `_host_group_exchange` :1965-2053): the exchanged ids (and the
        effective weights) come to the host, the ids clamped into [0,
        rows_max - 1]; the rows are gathered from the host table (and
        decoded there, at a quantized storage) and combined in float32 into
        a pinned staging buffer, which is copied to the card without
        blocking. The staging buffer comes from torch's caching host
        allocator, which records an event behind that copy and hands the
        block out again only once the event has completed, so no copy in
        flight reads a reused buffer. Then, on the card, the cast to the
        compute dtype and the mean's scale where the group has no weights
        (explicit weights are normalized already: the JAX test's
        weighted-mean regression). Runs in the profiler range
        `OFFLOAD_LOOKUP_RANGE`."""
        bucket = self.plan.tp_buckets[grp.bucket]
        eff_w, scale = _effective_weights(w_x, grp.k, bucket.combiner)
        with record_function(OFFLOAD_LOOKUP_RANGE):
            b_sz, f, k = ids_x.shape
            wf = bucket.width
            rows_max = max(bucket.rows_max, 1)
            host = self._to_host(
                ids_x.clamp(0, rows_max - 1).reshape(-1).long(),
                *(() if eff_w is None else (eff_w.float(),)))
            flat = host[0]
            if bucket.storage_dtype == "f32":
                rows = self.tp[grp.bucket].data.index_select(0, flat)
            else:
                rows = self._quantized_rows(grp.bucket, flat)
            out_h = torch.empty(
                (b_sz, f, k * wf if bucket.combiner is None else wf),
                dtype=torch.float32,
                pin_memory=self.device.type == "cuda")
            if bucket.combiner is None:
                out_h.copy_(rows.view(out_h.shape))
            else:
                rows = rows.view(b_sz * f, k, wf)
                if eff_w is not None:
                    rows = rows * host[1].view(b_sz * f, k, 1)
                torch.sum(rows, dim=1, out=out_h.view(b_sz * f, wf))
            out = out_h.to(self.device, non_blocking=True)
            if self.device.type == "cuda":
                self.offload_traffic["htod_bytes"] += (
                    out_h.numel() * out_h.element_size())
        return _scaled(self._cast(out), scale)

    def _quantized_lookup(self, b: int, ids: torch.Tensor,
                          weights: Optional[torch.Tensor],
                          combiner: Optional[str]) -> torch.Tensor:
        """A quantized bucket's lookup, ids [B, f, k] -> [B, f, wf] (JAX
        `_tp_group_out` :1940-1962): the decode-gather (`_quantized_rows`),
        cast to the compute dtype, then `_combine`d. Runs inside the
        profiler range `QUANTIZED_LOOKUP_RANGE`."""
        with record_function(QUANTIZED_LOOKUP_RANGE):
            return _combine(self._cast(self._quantized_rows(b, ids)),
                            weights, combiner)

    def _quantized_rows(self, b: int, ids: torch.Tensor) -> torch.Tensor:
        """Bucket b's decode-gather, ids [...] -> float32 rows [..., wf]:
        the payload rows and their scales gathered (ids clamped into the
        table, int64 indexing) and decoded."""
        payload = self.tp[b]
        flat = ids.reshape(-1).clamp(0, payload.shape[0] - 1).long()
        rows = wire.decode_rows(
            payload.view(torch.uint8).index_select(0, flat).view(
                payload.dtype),
            self._bucket_scale(b).index_select(0, flat),
            self._bucket_store_dtype(b))
        return rows.reshape(tuple(ids.shape) + (payload.shape[1],))

    def _send_block(self, grp: _ExchangeGroup, x: torch.Tensor):
        """The group's member inputs of `x` [B_l, n_g, k] selected into its
        send block [world, B_l, f_max, k], destination-major (block r holds
        rank r's slots)."""
        return x.index_select(1, grp.sel_t).reshape(
            x.shape[0], self.world_size, grp.f_max, grp.k).transpose(0, 1)

    def _padded_id_exchange(self, grp: _ExchangeGroup, ids: torch.Tensor,
                            w: Optional[torch.Tensor]):
        """Fixed-shape dp->mp id (+weight) exchange: the group's send
        blocks (`_send_block`) through `_exchange_send`. The blocks arrive
        source-major, so flattening them gives the global batch in order:
        [B, f_max, k]. At world size 1 the selection alone."""
        return self._exchange_send(
            grp, self._send_block(grp, ids),
            None if w is None else self._send_block(grp, w))

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
                       sort_plan=None, mp_input=False,
                       hot_res=(None, None)) -> List[torch.Tensor]:
        """Per exchange group: id exchange, row-offset add, fused lookup
        over the global batch, exchange back. Returns per group the
        [world_src, B_l, f_max, wf] block. With `mp_input`, `group_ids` /
        `group_w` are the rank's own [B, f_max, k] blocks already (model-
        parallel input) and the id exchange is skipped. With `taps`, each
        mp-side output, [world_dst, B_l, f_max, wf], is detached into a
        leaf that requires grad and appended to ``taps["tp"]`` before it
        is exchanged; with `res_ids`/`res_w`/`res_sort`, the group's
        absolute ids, effective weights and its `GroupSort` (where its
        `sort_plan` entry asks for one, else None) are appended there.

        A group of a hot bucket (JAX `_forward_local` :1540-1638) splits
        its send block against the bucket's hot shard before the exchange
        (`_hot_split_send`): hit lanes cross as the sentinel ``rows_max``
        at weight 0 and are served on the dp side from the hot rows
        (`_hot_contrib`, added to the returned block; with `taps` a leaf
        appended to ``taps["hot"]``, None there for other groups); the
        miss lanes take the exchange and a weighted lookup of the ids
        clamped below ``rows_max``, while the residuals keep the raw
        sentinel, which the update drops. `hot_res` (two lists, or Nones)
        gets each group's hit positions and weights."""
        ex_list = []
        hot_taps = None if taps is None else taps.get("hot")
        for g, grp in enumerate(groups):
            bucket = self.plan.tp_buckets[grp.bucket]
            rows_max = max(bucket.rows_max, 1)
            hot = (self._hot_entry(grp.bucket)
                   if bucket.hot_rows and not mp_input else None)
            hot_pos = hot_w = None
            if mp_input:
                ids_x, w_x = group_ids[g], group_w[g]
            elif hot is not None:
                with record_function(HOT_SPLIT_RANGE):
                    send, w_send, hot_pos, hot_w = self._hot_split_send(
                        grp, group_ids[g], group_w[g], hot[0])
                ids_x, w_x = self._exchange_send(grp, send, w_send)
                if w_x is None:
                    # unweighted: hit lanes arrive as exactly rows_max, so
                    # the effective weights (0 or the mean scale) are
                    # rebuilt here instead of crossing the wire
                    _, scale = _effective_weights(None, grp.k,
                                                  bucket.combiner)
                    w_x = torch.where(
                        ids_x == rows_max,
                        torch.zeros((), dtype=torch.float32,
                                    device=ids_x.device),
                        torch.full((), scale, dtype=torch.float32,
                                   device=ids_x.device))
            else:
                ids_x, w_x = self._padded_id_exchange(grp, group_ids[g],
                                                      group_w[g])
            ids_x = ids_x + grp.offs_t[None, :, None]
            sort_g = None
            if sort_plan is not None and sort_plan[g]:
                sort_g = canonical_id_sort(ids_x, rows_max)
            if hot is not None:
                # w_x is the effective weight already (scale folded in,
                # hits zeroed): a plain weighted sum
                out = self._group_lookup(self.tp[grp.bucket],
                                         ids_x.clamp_max(rows_max - 1), w_x,
                                         "sum", presorted=sort_g)
            elif bucket.offload:
                out = self._offload_group_out(grp, ids_x, w_x)
            else:
                out = self._tp_group_out(grp, ids_x, w_x, presorted=sort_g)
            out = out.reshape((self.world_size, -1) + tuple(out.shape[1:]))
            if taps is not None:
                out = out.detach().requires_grad_()
                taps["tp"].append(out)
            if res_ids is not None:
                eff_w = (w_x if hot is not None else
                         _effective_weights(w_x, grp.k, bucket.combiner)[0])
                res_ids.append(ids_x[None])
                res_w.append(None if eff_w is None else eff_w[None])
                res_sort.append(sort_g)
            ex = self._tp_bucket_exchange(out, bucket.wire_dtype)
            if hot is not None:
                with record_function(HOT_GATHER_RANGE):
                    contrib = self._hot_contrib(hot[1], hot_pos, hot_w,
                                                bucket.hot_rows)
                if hot_taps is not None:
                    contrib = contrib.detach().requires_grad_()
                    hot_taps.append(contrib)
                ex = ex + contrib.to(ex.dtype)
            elif hot_taps is not None:
                hot_taps.append(None)
            if hot_res[0] is not None:
                hot_res[0].append(None if hot_pos is None else hot_pos[None])
                hot_res[1].append(None if hot_w is None else hot_w[None])
            ex_list.append(ex)
        return ex_list

    # ------------------------------------------------------- the hot split
    def _hot_group_meta(self, grp: _ExchangeGroup):
        """The group's hot-split constants on the device (JAX
        `_hot_group_meta`): ``base [world, f_max]``, each send lane's flat
        key base ``rank * rows_max + row_offset``; ``lane_valid``, False on
        the f_max padding lanes (which repeat input 0 and must not hit);
        ``lane_rows``, each lane's table rows, past which an id would fold
        into a neighbouring table's keys and must miss. Built once a group,
        with it (`_ExchangeGroup.hot_meta`)."""
        rows_max = max(self.plan.tp_buckets[grp.bucket].rows_max, 1)
        world = self.world_size
        rows_of = {(pl.rank, pl.row_offset): pl.rows
                   for pl in self.plan.tp_placements
                   if pl.bucket == grp.bucket}
        base = np.zeros((world, grp.f_max), np.int64)
        lane_valid = np.zeros((world, grp.f_max), bool)
        lane_rows = np.zeros((world, grp.f_max), np.int64)
        for r in range(world):
            base[r, :] = r * rows_max
            for j in range(int(grp.counts[r])):
                base[r, j] += int(grp.offs[r, j])
                lane_valid[r, j] = True
                lane_rows[r, j] = rows_of.get((r, int(grp.offs[r, j])), 0)
        dev = self.device
        return (torch.as_tensor(base, dtype=torch.int32, device=dev),
                torch.as_tensor(lane_valid, device=dev),
                torch.as_tensor(lane_rows, dtype=torch.int32, device=dev))

    def _hot_split_send(self, grp: _ExchangeGroup, ids: torch.Tensor,
                        w: Optional[torch.Tensor], hot_ids: torch.Tensor):
        """The hot-membership split of one group's send block (JAX
        `_hot_split_send` :1815-1876): the destination-major block
        [world, B_l, f_max, k] of ids, and of effective weights (the mean
        scale folded in) where the group has weights; each lane's flat key
        searched in the sorted membership (`sorted_member_positions`, no
        sort). A lane hits only where its id is valid for its lane (0 <=
        id < the lane's table rows, on a real lane). Hit lanes leave the
        miss path as the sentinel ``rows_max`` (which every lookup clamps
        and the update drops: the canonical rows of resident ids are never
        touched, which lazy adam needs) at weight 0. Returns (send ids,
        send weights or None, hit positions (H on a miss), hit weights (0
        on a miss))."""
        bucket = self.plan.tp_buckets[grp.bucket]
        rows_max = max(bucket.rows_max, 1)
        eff, scale = _effective_weights(w, grp.k, bucket.combiner)
        send = self._send_block(grp, ids)
        base, lane_valid, lane_rows = grp.hot_meta
        keys = send + base[:, None, :, None].to(send.dtype)
        pos, hit = embedding_ops.sorted_member_positions(hot_ids, keys)
        hit = (hit & lane_valid[:, None, :, None] & (send >= 0)
               & (send < lane_rows[:, None, :, None]))
        send_m = torch.where(hit, torch.full((), rows_max, dtype=send.dtype,
                                             device=send.device), send)
        hot_pos = torch.where(hit, pos, torch.full(
            (), bucket.hot_rows, dtype=pos.dtype, device=pos.device))
        zero = torch.zeros((), dtype=torch.float32, device=send.device)
        if eff is None:
            # unweighted: every lane's effective weight is the scale, which
            # the receiver rebuilds; no weight block crosses the wire
            return send_m, None, hot_pos, torch.where(
                hit, torch.full((), scale, dtype=torch.float32,
                                device=send.device), zero)
        w_send = self._send_block(grp, eff * scale)
        return (send_m, torch.where(hit, zero, w_send), hot_pos,
                torch.where(hit, w_send, zero))

    def _exchange_send(self, grp: _ExchangeGroup, send: torch.Tensor,
                       w_send: Optional[torch.Tensor]):
        """The dp->mp exchange of a send block [world, B_l, f_max, k] (and
        its weights) over the bucket's wires (`wire.wire_id_all_to_all`,
        `wire.wire_all_to_all`): ([B, f_max, k] ids, weights or None)."""
        bucket = self.plan.tp_buckets[grp.bucket]
        if self.world_size > 1:
            send = wire.wire_id_all_to_all(send, bucket.id_wire_dtype)
            if w_send is not None:
                w_send = wire.wire_all_to_all(w_send, bucket.wire_dtype)
        shape = (-1, grp.f_max, grp.k)
        return (send.reshape(shape),
                None if w_send is None else w_send.reshape(shape))

    def _hot_contrib(self, hot_rows: torch.Tensor, hot_pos: torch.Tensor,
                     hot_w: torch.Tensor, h_cap: int) -> torch.Tensor:
        """The hit lanes' output [world, B_l, f_max, w] on the dp side (JAX
        `_hot_contrib`): the hot rows at the hit positions (clamped below
        H, at weight 0 on a miss), cast to the compute dtype, and their
        weighted sum over the hotness in float32, rounded once."""
        rows = self._cast(hot_rows[hot_pos.clamp_max(h_cap - 1).long()])
        contrib = torch.einsum("rbfk,rbfkw->rbfw",
                               hot_w.to(rows.dtype).float(), rows.float())
        return contrib.to(rows.dtype)

    def _dp_forward(self, dp_prep) -> List[torch.Tensor]:
        """The data-parallel inputs: a local gather and combine on the
        replicated table over the rank's slice (ids clamped into the table,
        as the tp lookups do; the rows cast to the compute dtype before the
        combine), or the table's own layer's forward, cast (JAX
        `_forward_local` :1488-1520)."""
        strat = self.strategy
        outs = []
        for j, p in enumerate(dp_prep):
            t_dp = strat.map_groups[0][j]
            cfg = strat.dp_configs[t_dp]
            layer = self._dp_custom_layers.get(t_dp)
            if layer is not None:
                if p.weights is not None:
                    raise NotImplementedError(
                        f"dp table {t_dp}: (ids, weights) inputs are not "
                        "supported for custom embedding layer classes: the "
                        "layer's own forward defines its semantics")
                out = self._cast(layer(p.ids))
                want_rank = 2 if cfg.get("combiner") else 3
                if out.dim() != want_rank:
                    raise ValueError(
                        f"dp table {t_dp}: custom layer forward returned "
                        f"rank-{out.dim()} output, expected rank {want_rank} "
                        "([batch, width] with a combiner, [batch, hotness, "
                        "width] without)")
            else:
                table = self.dp[t_dp]
                ids = p.ids.reshape(-1).clamp(0, table.shape[0] - 1)
                emb = table.index_select(0, ids).reshape(
                    tuple(p.ids.shape) + (table.shape[1],))
                out = _combine(self._cast(emb), p.weights,
                               cfg.get("combiner"))
            outs.append(self._restore_shape(out, p, cfg.get("combiner"),
                                            cfg["output_dim"]))
        return outs

    def _row_lookup(self, table: torch.Tensor, local: torch.Tensor,
                    weights: torch.Tensor,
                    combiner: Optional[str]) -> torch.Tensor:
        """A row shard's lookup over the global batch: local ids [B, k]
        (clamped into the shard) and per-slot weights [B, k] that carry 0
        where the id is not this rank's. A combined table, or a
        combiner-None one at hotness 1 under the kernel paths, is one
        gather-combine (`cuda_lookup.lookup_combine`; the dense step's
        differentiable `fused_embedding_lookup` when the table requires
        grad) -> [B, w]; else a plain gather scaled by the weights -> [B,
        k, w], as the tp groups take combiner None. Under a compute dtype
        the row group takes the JAX package's XLA route (rows, and the
        weights, rounded before the combine): the kernel's round-first
        form."""
        k = local.shape[1]
        if combiner is None and not (
                k == 1 and self.lookup_path in ("pallas", "tiled", "fused")):
            rows = self._cast(table[local])
            return rows * weights[..., None].to(rows.dtype)
        round_first = self.compute_dtype is not None
        if table.requires_grad and torch.is_grad_enabled():
            return cuda_lookup.fused_embedding_lookup(
                table, local, weights, "sum", self.output_dtype, round_first)
        return cuda_lookup.lookup_combine(table, local.contiguous(),
                                          weights.contiguous(),
                                          self.output_dtype, round_first)

    def _row_forward(self, row_prep, taps=None, res_ids=None, res_w=None,
                     res_sort=None) -> List[torch.Tensor]:
        """The row-sliced inputs (JAX `_row_slice_local` :2112-2171): ids
        (and weights) all-gathered to the global batch, shifted to this
        rank's shard, masked to the ids it holds (`rows_per_rank`: the
        last ranks' shards end in padding rows), gather-combined over the
        global batch, then reduce-scattered back to each rank's slice.
        With `taps`, each partial output, [B, (k,) w] over the global
        batch, becomes a leaf appended to ``taps["row"]``; with `res_ids`
        the masked local ids (``rows_max`` where invalid), the effective
        weights and the sorts of `_row_sort_plan` are appended."""
        world, rank = self.world_size, self.rank
        sort_plan = self._row_sort_plan() if res_ids is not None else None
        outs = []
        for j, p in enumerate(row_prep):
            rt = self.plan.row_tables[self.strategy.map_groups[2][j]]
            ids, weights = p.ids, p.weights
            if world > 1:
                ids = wire.wire_id_all_gather(ids, rt.id_wire_dtype)
                if weights is not None:
                    weights = wire.wire_all_gather(weights, rt.wire_dtype)
            local = ids - int(rt.row_base[rank])
            valid = (local >= 0) & (local < rt.rows_per_rank[rank])
            local = local.clamp(0, max(rt.rows_max - 1, 0))
            vmask = valid.to(torch.float32)
            eff_w, scale = _effective_weights(weights, ids.shape[-1],
                                              rt.combiner)
            w_full = vmask if eff_w is None else eff_w * vmask
            table = self.row[self.strategy.map_groups[2][j]]
            out = self._row_lookup(table, local,
                                   vmask if rt.combiner is None else w_full,
                                   rt.combiner)
            out = _scaled(out, scale)
            if taps is not None:
                out = out.detach().requires_grad_()
                taps["row"].append(out)
            if world > 1:
                out = wire.wire_psum_scatter(out, rt.wire_dtype)
            outs.append(self._restore_shape(out, p, rt.combiner, rt.width))
            if res_ids is not None:
                sent = torch.where(valid, local,
                                   torch.full_like(local, rt.rows_max))
                res_ids.append(sent[None])
                res_w.append((w_full * scale)[None])
                res_sort.append(canonical_id_sort(sent, max(rt.rows_max, 1))
                                if sort_plan[j] else None)
        return outs

    def _stack_groups(self, tp_prep, batch):
        """The tp inputs stacked per exchange group: ids [B, n_g, k_g] (+
        weights where any member input carries them)."""
        if not tp_prep:
            return [], [], [], []
        groups, assembly = self._exchange_groups(tp_prep)
        group_ids: List[torch.Tensor] = []
        group_w: List[Optional[torch.Tensor]] = []
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
        return groups, assembly, group_ids, group_w

    def forward(self, inputs: Sequence, taps=None,
                return_residuals: bool = False):
        """Forward pass. With data-parallel input (``dp_input=True``): one
        [B_l] / [B_l, k] id array per feature (numpy or tensor),
        RaggedIds, SparseIds or (ids, weights) tuples, B_l this rank's
        slice of the global batch (the whole batch at world size 1). With
        ``dp_input=False``, see `forward_mp`. Returns one [B_l, width]
        tensor per input (or [B_l, k, width] for combiner=None multi-hot),
        in input order. Collective at world size > 1: every rank calls it,
        with the same batch size.

        taps: the container from `make_taps`. The forward fills
        ``taps["tp"]`` with one leaf per exchange group, the group's
        mp-side output over the global batch, ``[world, B_l, f_max,
        w_out]``, and ``taps["row"]`` with one per row-sliced input, its
        partial output over the global batch, ``[B, (k,) w]``, each
        detached from the (gradient-free) tables and requiring grad, so
        that autograd delivers at each leaf the gradient the JAX package
        reads at its zero tap on this rank; a hot-sharded layer's
        ``taps["hot"]`` gets per exchange group the hit lanes' output
        ``[world, B_l, f_max, w]`` (None for a group of a bucket without
        a hot shard); a tapped forward whose container lacks it raises.
        return_residuals: also return the `TapResiduals` for
        `sparse_update`, as ``(outputs, residuals)``; inside
        `residual_sort_scope` they carry the groups' sorts."""
        if not self.dp_input:
            return self.forward_mp(inputs, taps, return_residuals)
        if taps is not None:
            for part in taps.values():
                part.clear()
        prepped = self._prepare_inputs(inputs)
        strat = self.strategy
        batch = prepped[0].ids.shape[0]
        dp_prep = [prepped[i] for i in strat.input_groups[0]]
        tp_prep = [prepped[i] for i in strat.input_groups[1]]
        row_prep = [prepped[i] for i in strat.input_groups[2]]
        groups, assembly, group_ids, group_w = self._stack_groups(tp_prep,
                                                                  batch)
        if (taps is not None and "hot" not in taps and any(
                self.plan.tp_buckets[grp.bucket].hot_rows for grp in groups)):
            # the split masks the resident rows' canonical gradients by
            # design: their updates flow through the hot taps alone
            raise ValueError(
                "tapped hot-split forward needs taps['hot']: build the tap "
                "container with make_taps() (it adds the hot entry when "
                "hot_rows is active), or pass taps=None")
        res = ([], [], [], [], [], []) if return_residuals else (None,) * 6
        hot_res = ([], []) if return_residuals else (None, None)
        sort_plan = self._sort_plan(groups) if return_residuals else None
        dp_outs = self._dp_forward(dp_prep)
        ex_list = self._forward_local(group_ids, group_w, groups, taps,
                                      *res[:3], sort_plan, hot_res=hot_res)
        tp_outs = self._assemble_tp_outputs(ex_list, tp_prep, batch, groups,
                                            assembly)
        row_outs = self._row_forward(row_prep, taps, *res[3:])
        outputs = dp_outs + tp_outs + row_outs
        outputs = [outputs[idx] for idx in strat.rev_group_ids]
        if return_residuals:
            key = tuple((p.k, p.weights is not None) for p in tp_prep)
            hot_pos, hot_w = hot_res
            if not any(x is not None for x in hot_pos):
                hot_pos = hot_w = None
            return outputs, TapResiduals(key, *res[:3], *res[3:],
                                         hot_pos=hot_pos, hot_w=hot_w)
        return outputs

    def _mp_prepare(self, inputs):
        """This rank's model-parallel inputs prepared, and a representative
        `_PreparedInput` per tp input (the rank's own, or, for a feature
        another rank owns, one without ids at its `input_max_hotness`, fed
        1-D at hotness 1): (own {tp input: prep}, [prep per tp input],
        global batch)."""
        strat = self.strategy
        world, rank = self.world_size, self.rank
        if inputs and isinstance(inputs[0], list):
            # the JAX package's nested per-rank form: this rank's list
            if len(inputs) != world:
                raise ValueError(f"forward_mp expects {world} per-rank "
                                 f"input lists, got {len(inputs)}")
            inputs = inputs[rank]
        ids_list = strat.input_ids_list[rank] if strat.input_ids_list else []
        if len(inputs) != len(ids_list):
            raise ValueError(f"rank {rank}: expected {len(ids_list)} inputs "
                             f"(features {ids_list}), got {len(inputs)}")
        hints = self.input_max_hotness
        if world > 1 and (hints is None or any(
                hints[i] is None for i in strat.input_groups[1])):
            raise ValueError(
                "model-parallel input at world size > 1 requires "
                "input_max_hotness for every input: every rank must plan "
                "the same exchange groups from the features it does not "
                "own")
        own = {}
        for x, pos in zip(inputs, ids_list):
            orig = strat.input_groups[1][pos]
            p = self._prepare_one(x, None if hints is None else hints[orig])
            if world > 1 and p.k != hints[orig]:
                raise ValueError(
                    f"input {orig}: hotness {p.k} != input_max_hotness "
                    f"{hints[orig]}; model-parallel ids must be padded to "
                    "the declared max hotness")
            combiner = strat.global_configs[strat.table_groups[1][
                strat.map_groups[1][pos]]].get("combiner")
            if world > 1 and p.k == 1 and not p.orig_1d and combiner is None:
                raise ValueError(
                    f"input {orig}: feed hotness-1 ids of a table without a "
                    "combiner as 1-D [B] arrays: every rank restores the "
                    "same output shapes")
            own[pos] = p
        if not own:
            if world == 1:
                return own, [], 0
            raise ValueError(f"rank {rank} owns no feature: it cannot tell "
                             "the global batch")
        reps = [own[pos] if pos in own else _PreparedInput(
            None, None, hints[orig] == 1, hints[orig])
            for pos, orig in enumerate(strat.input_groups[1])]
        return own, reps, next(iter(own.values())).ids.shape[0]

    def forward_mp(self, inputs, taps=None, return_residuals: bool = False):
        """Forward pass with model-parallel input (``dp_input=False``, the
        JAX package's `apply_mp`): this rank's own features, at global
        batch size B, in ``strategy.input_ids_list[rank]`` order (the
        reference's mp-input contract; `models.data.RawBinaryDataset`
        with ``categorical_features=`` reads them), or the JAX package's
        nested per-rank lists, of which the rank takes its own. At world
        size > 1 every input needs its `input_max_hotness` (each rank plans
        the exchange groups of features it does not own from it), and
        hotness-1 ids of a table without a combiner come 1-D. The dp->mp
        id exchange is skipped; the lookups and the mp->dp exchange are
        `forward`'s; a slot the rank does not fill holds id 0 at weight 0,
        as in the JAX package. Returns one
        [B / world, width] tensor per input (every feature, this rank's
        slice of the batch), in input order. Collective at world size >
        1."""
        if self.dp_input:
            raise ValueError("This layer was built with dp_input=True; "
                             "use forward() with data-parallel inputs")
        if taps is not None:
            for part in taps.values():
                part.clear()
        own, reps, batch = self._mp_prepare(inputs)
        if not reps:
            return ([], TapResiduals((), [], [], [])) if return_residuals \
                else []
        world = self.world_size
        if batch % world:
            raise ValueError(
                f"Global batch {batch} not divisible by device count {world}")
        groups, assembly = self._exchange_groups(reps)
        group_ids, group_w = [], []
        for grp in groups:
            dt = self._id_dtype(grp.bucket)
            cols_i, cols_w = [], []
            for j_g in range(grp.f_max):
                p = (own[grp.class_inputs[grp.sel[self.rank, j_g]]]
                     if j_g < grp.counts[self.rank] else None)
                cols_i.append(p.ids.to(dt) if p is not None else torch.zeros(
                    (batch, grp.k), dtype=dt, device=self.device))
                if not grp.need_w:
                    continue
                if p is not None and p.weights is not None:
                    cols_w.append(p.weights)
                else:
                    cols_w.append(torch.full((batch, grp.k),
                                             0.0 if p is None else 1.0,
                                             device=self.device))
            group_ids.append(torch.stack(cols_i, dim=1))
            group_w.append(torch.stack(cols_w, dim=1) if grp.need_w
                           else None)
        res = ([], [], []) if return_residuals else (None,) * 3
        sort_plan = self._sort_plan(groups) if return_residuals else None
        ex_list = self._forward_local(group_ids, group_w, groups, taps,
                                      *res, sort_plan, mp_input=True)
        outputs = self._assemble_tp_outputs(ex_list, reps, batch // world,
                                            groups, assembly)
        outputs = [outputs[idx] for idx in self.strategy.rev_group_ids]
        if return_residuals:
            key = tuple((p.k, p.weights is not None) for p in reps)
            return outputs, TapResiduals(key, *res)
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
        ``[world, B, f_max_g, w_out]`` per exchange group and ``[world,
        B, (k,) w]`` per row-sliced input, which its forward adds to each
        output; here the forward fills the lists with the rank's outputs
        themselves, made leaves (the tables need no grad), whose ``.grad``
        after backward is this rank's block of the tap gradient: per
        group ``[world, B_l, f_max_g, w_out]``, per row input ``[B, (k,)
        w]``. Saves a pass over a zeros tensor per tap. `inputs`: the
        forward's (this rank's own features with ``dp_input=False``)."""
        if self.dp_input and len(inputs) != self._n_inputs:
            raise ValueError(
                f"Expected {self._n_inputs} inputs, got {len(inputs)}")
        if self._hot_buckets and self.dp_input:
            # one entry per exchange group: a hot group's leaf is its hit
            # contribution ``[world, B_l, f_max, w]`` on the dp side (whose
            # gradient the hot shard's update consumes), None elsewhere
            return {"tp": [], "row": [], "hot": []}
        return {"tp": [], "row": []}

    def init_sparse_state(self, opt: SparseOptimizer) -> dict:
        """Sparse-optimizer state for the bucket tables and the row shards
        (the dp tables train densely): ``{"tp": [opt.init(table) per
        bucket], "row": [opt.init(shard) per row table]}``. Table-shaped
        state (adagrad's accumulator, adam's moments) is allocated directly
        on the tables' device at their shapes ``[rows_max, w]``; an
        offloaded bucket's in host memory, page-locked on a CUDA layer and
        filled there (the JAX package's ``init_host``)."""
        out = {"tp": [self._host_state(b, opt) if b in self.offloaded_buckets
                      else opt.init(t.data) for b, t in enumerate(self.tp)],
               "row": [opt.init(t.data) for t in self.row]}
        if self._hot_buckets:
            # the hot shards' state, the same on every rank (each applies
            # the same summed update): one per hot bucket, in bucket order
            out["hot"] = [opt.init(self._hot_entry(b)[1])
                          for b in self._hot_buckets]
        return out

    def _host_state(self, b: int, opt: SparseOptimizer) -> tuple:
        """Offloaded bucket b's optimizer state in host memory: each
        table-shaped leaf of ``opt.init`` (probed on one row) allocated by
        `_host_empty` and filled with its constant."""
        probe = opt.init(torch.zeros((1, self.tp[b].shape[1]),
                                     dtype=torch.float32))
        out = []
        for x in probe:
            if torch.is_tensor(x) and x.dim() == 2:
                host = self._host_empty(tuple(self.tp[b].shape), x.dtype,
                                        held=False)
                out.append(host.fill_(x.reshape(-1)[0]))
            else:
                out.append(x)
        return tuple(out)

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

    def _row_contrib(self, j: int, residuals: TapResiduals,
                     row_g) -> SparseRowGrad:
        """One row input's SparseRowGrad: its masked local ids (the
        sentinel ``rows_max`` lies past the shard, so the update drops it)
        and the tap gradient times the effective weights."""
        rt = self.plan.row_tables[self.strategy.map_groups[2][j]]
        ids = residuals.row_ids[j][0]                  # [B, k]
        gtap = row_g[j]                                # [B, w] | [B, k, w]
        # combiner None at hotness 1 under the kernel paths taps [B, w]
        gk = (gtap[:, None, :] if rt.combiner is not None
              else gtap.reshape(tuple(ids.shape) + (rt.width,)))
        contrib = gk.float() * residuals.row_w[j][0][..., None]
        return SparseRowGrad(ids.reshape(-1),
                             contrib.reshape(-1, rt.width).contiguous())

    @torch.no_grad()
    def sparse_update(self, opt_states: dict, tap_grads: dict,
                      residuals: TapResiduals,
                      opt: SparseOptimizer) -> dict:
        """Row-wise sparse optimizer step for this rank's bucket tables and
        row shards, IN PLACE (the JAX package returns new, donated arrays):
        per bucket, the SparseRowGrads of its exchange groups, and per row
        table those of its inputs, are concatenated and handed to
        ``opt.update``, which dedups them and updates each touched row of
        the table and its state once; a bucket of one group (a row table of
        one input) passes its sort from the residuals as ``presorted=``
        when the forward made one. A quantized bucket takes
        `ops.sparse_update.quantized_row_update` under every strategy
        (``opt.quantized``, the same lr and hyperparameters), its payload
        and scales updated in place; adam refuses a layer with quantized
        buckets, as in the JAX package. With ``tap_grads["hot"]`` and
        ``opt_states["hot"]``, the hot shards too (`_hot_update`); their
        hit lanes reach the buckets as the sentinel and are dropped. An
        offloaded bucket's rows are deduplicated on the card and applied
        in host memory (`_host_bucket_update`), with the optimizer's lr,
        which the train step rebuilds at each step's value under a
        schedule; an optimizer without a host rule refuses a layer with
        offloaded buckets, as in the JAX package. The dp tables are not
        touched here: they train with the dense parameters. `tap_grads` is
        ``{"tp": [grad of each taps["tp"] leaf], "row": [grad of each
        taps["row"] leaf]}``.
        Returns the new state pytree (adam's step count is a new tuple
        entry; tensors are updated in place)."""
        offloaded = self.offloaded_buckets
        if offloaded and opt.kind not in HOST_APPLY_KINDS:
            raise NotImplementedError(
                f"sparse optimizer {opt.kind!r} has no host-memory apply "
                f"rule for offloaded buckets (available: "
                f"{sorted(HOST_APPLY_KINDS)})")
        quantized = [b for b in self.quantized_buckets if b not in offloaded]
        if quantized and opt.kind not in QUANTIZED_ROW_KINDS:
            raise NotImplementedError(
                f"sparse optimizer {opt.kind!r} has no master-weight-free "
                f"quantized row-update rule (quantized buckets {quantized}; "
                f"available: {sorted(QUANTIZED_ROW_KINDS)}). adam's "
                "moment-normalized steps fall below the per-row "
                "quantization grid and are lost even under stochastic "
                "rounding; keep such buckets at storage_dtype='f32'")
        groups, _ = self._exchange_groups_for_key(residuals.key)
        bucket_groups: dict = {}
        for g, grp in enumerate(groups):
            bucket_groups.setdefault(grp.bucket, []).append(g)

        def update(table, state, grads, sort):
            # the keyword only with an artifact: an update callable of
            # three arguments keeps working wherever nothing was folded
            kw = {} if sort is None else {"presorted": sort}
            return opt.update(table, tuple(state), concat_grads(grads),
                              **kw)[1]
        new_tp = list(opt_states["tp"])
        for b, gs in bucket_groups.items():
            grads = [self._group_contrib(g, groups[g], residuals.tp_ids,
                                         residuals.tp_w, tap_grads["tp"])
                     for g in gs]
            sort_b = (residuals.tp_sort[gs[0]]
                      if len(gs) == 1 and residuals.tp_sort else None)
            if b in offloaded:
                new_tp[b] = self._host_bucket_update(
                    b, concat_grads(grads), new_tp[b], opt)
                continue
            if b in quantized:
                if opt.quantized is None:
                    raise ValueError(
                        f"sparse optimizer {opt.kind!r} carries no quantized "
                        f"rule for bucket {b} (build it with "
                        "make_sparse_optimizer)")
                new_tp[b] = opt.quantized(
                    self.tp[b].data, self._bucket_scale(b).data,
                    tuple(new_tp[b]), concat_grads(grads),
                    self._bucket_store_dtype(b), presorted=sort_b)
                continue
            new_tp[b] = update(self.tp[b].data, new_tp[b], grads, sort_b)
        table_inputs: dict = {}
        for j in range(len(residuals.row_ids)):
            table_inputs.setdefault(self.strategy.map_groups[2][j],
                                    []).append(j)
        new_row = list(opt_states.get("row", []))
        for t, js in table_inputs.items():
            grads = [self._row_contrib(j, residuals, tap_grads["row"])
                     for j in js]
            sort_t = (residuals.row_sort[js[0]]
                      if len(js) == 1 and residuals.row_sort else None)
            new_row[t] = update(self.row[t].data, new_row[t], grads, sort_t)
        out = {**opt_states, "tp": new_tp, "row": new_row}
        if (self._hot_buckets and residuals.hot_pos is not None
                and tap_grads.get("hot") and "hot" in opt_states):
            out["hot"] = self._hot_update(opt_states["hot"], groups,
                                          tap_grads["hot"], residuals, opt)
        return out

    def _host_bucket_update(self, b: int, grad: SparseRowGrad, state,
                            opt: SparseOptimizer) -> tuple:
        """Offloaded bucket b's update: the pending rows deduplicated on
        the card (`prepare_safe_grad`, JAX `_host_bucket_pending`), copied
        to the host, and applied to the host table and state in place (JAX
        `_host_pershard_apply`: `host_apply_rows_inplace` at ``opt.lr``,
        adam's count incremented here; a quantized bucket through
        `_host_quantized_apply`). Runs in the profiler range
        `OFFLOAD_UPDATE_RANGE` (the host half). Returns the new state."""
        rows = max(self.plan.tp_buckets[b].rows_max, 1)
        rep, sums, valid = prepare_safe_grad(grad.ids, grad.contribs, rows)
        with record_function(OFFLOAD_UPDATE_RANGE):
            rep, sums, valid = (t.numpy() for t in self._to_host(
                rep, sums.contiguous(), valid))
            hp = dict(opt.hp)
            kw = {k: hp[k] for k in ("eps", "b1", "b2") if k in hp}
            state = tuple(state)
            if opt.kind == "adam":
                state = (state[0], state[1], int(state[2]) + 1)
            arrays = tuple(x.numpy() if torch.is_tensor(x) else x
                           for x in state)
            if self._bucket_store_dtype(b) == "f32":
                host_apply_rows_inplace(opt.kind, self.tp[b].data.numpy(),
                                        arrays, rep, sums, valid, opt.lr,
                                        **kw)
            else:
                self._host_quantized_apply(b, arrays, rep, sums, valid, opt,
                                           kw)
        return state

    def _host_quantized_apply(self, b: int, arrays, rep, sums, valid,
                              opt: SparseOptimizer, kw: dict) -> None:
        """A quantized offloaded bucket's touched-rows apply (JAX
        `_host_quantized_touched_apply` :3526): exactly the touched rows
        decoded into a compact float32 block (`wire.decode_rows_np`), the
        host rule applied to it and to their state rows, and the block
        re-encoded with stochastic rounding (`wire.encode_rows_np`, whose
        scale divides) into the payload and scales in place."""
        sd = self._bucket_store_dtype(b)
        payload = self.tp[b].data
        p_np = (payload.view(torch.uint8) if sd == "fp8" else payload).numpy()
        sc_np = self._bucket_scale(b).data.numpy()
        ok = valid > 0
        ru = rep[ok].astype(np.int64)
        m = int(ru.shape[0])
        if m == 0:
            return
        sub = np.ascontiguousarray(wire.decode_rows_np(p_np[ru], sc_np[ru],
                                                       sd))
        tables = [x for x in arrays if getattr(x, "ndim", 0) >= 1]
        subs = [np.ascontiguousarray(x[ru]) for x in tables]
        st = ((subs[0], subs[1], arrays[2]) if opt.kind == "adam"
              else tuple(subs))
        host_apply_rows_inplace(opt.kind, sub, st, np.arange(m),
                                np.ascontiguousarray(sums[ok]),
                                np.ones(m, np.float32), opt.lr, **kw)
        for x, x_sub in zip(tables, subs):
            x[ru] = x_sub
        pay, scl = wire.encode_rows_np(sub, sd, sr=True)
        p_np[ru] = pay
        sc_np[ru] = scl

    def _hot_update(self, hot_states, groups, hot_g, residuals,
                    opt: SparseOptimizer) -> list:
        """The hot shards' update (JAX `_sparse_update_body` :3215-3248):
        per hot bucket, its groups' hit contributions (the hot taps'
        gradients times the hit weights, at the hit positions) summed into
        a dense [H, w] gradient with a count a row (`_dense_sum`); at world
        size > 1 both summed over the ranks in one all-reduce, so every
        rank holds the global gradient; then the optimizer's masked rule
        on the rows whose count is above 0 (``opt.dense_rows``: its
        `apply_dense_rows`), the same on every rank, in place. Returns the
        new hot states."""
        if opt.dense_rows is None:
            raise ValueError(
                f"sparse optimizer {opt.kind!r} carries no dense-rows rule "
                "for the hot shards (build it with make_sparse_optimizer)")
        new_states = list(hot_states)
        for pos_h, b in enumerate(self._hot_buckets):
            gs = [g for g, grp in enumerate(groups)
                  if grp.bucket == b and residuals.hot_pos[g] is not None
                  and hot_g[g] is not None]
            if not gs:
                continue
            with record_function(HOT_UPDATE_RANGE):
                new_states[pos_h] = self._hot_bucket_update(
                    b, gs, hot_states[pos_h], hot_g, residuals, opt)
        return new_states

    def _hot_bucket_update(self, b: int, gs, state, hot_g, residuals,
                           opt: SparseOptimizer) -> tuple:
        """Hot bucket b's update from its groups `gs` (see `_hot_update`);
        returns its new state."""
        bucket = self.plan.tp_buckets[b]
        wf = bucket.width
        ids_l, con_l = [], []
        for g in gs:
            pos = residuals.hot_pos[g][0]            # [world, B_l, f, k]
            wv = residuals.hot_w[g][0]
            contrib = hot_g[g][..., None, :].float() * wv[..., None]
            ids_l.append(pos.reshape(-1))
            con_l.append(contrib.reshape(-1, wf))
        g_dense, counts = _dense_sum(torch.cat(ids_l), torch.cat(con_l),
                                     bucket.hot_rows)
        if self.world_size > 1:
            flat = torch.cat([g_dense, counts[:, None]], dim=1)
            with record_function(pg.ALL_REDUCE_RANGE):
                dist.all_reduce(flat)
            g_dense, counts = flat[:, :wf], flat[:, wf]
        return tuple(opt.dense_rows(self._hot_entry(b)[1], tuple(state),
                                    g_dense, counts > 0))

    # --------------------------------------------------------- weights I/O
    # rows of a bucket gathered per collective: at most this many elements
    # over all ranks (the JAX package's DET_GATHER_CHUNK_ELEMS default)
    GATHER_CHUNK_ELEMS = 128 * 1024 * 1024

    def _gather_rows(self, table: torch.Tensor, keep: bool,
                     scale: Optional[torch.Tensor] = None,
                     store_dtype: str = "f32"):
        """Yield ``(r0, r1, host [world, r1 - r0, w])`` over a rank-local
        table's row chunks, each gathered from every rank in one
        collective of at most `GATHER_CHUNK_ELEMS` elements
        (`parallel.mesh.gather_stack`); ``host`` is None where not `keep`
        (the rank takes part in the gathers only). A quantized bucket's
        chunks (its payload as bytes, then its `scale`) are decoded to
        float32 after the gather."""
        table = table.detach()
        rows, width = table.shape
        chunk = max(1, self.GATHER_CHUNK_ELEMS
                    // max(self.world_size * width, 1))

        def part(t):
            # a host table's chunk crosses the collective from the card
            return t if self.world_size == 1 else t.to(self.device)
        for r0 in range(0, rows, chunk):
            r1 = min(rows, r0 + chunk)
            if store_dtype == "f32":
                stack = pg.gather_stack(part(table[r0:r1]))
            else:
                stack = wire.decode_rows(
                    pg.gather_stack(part(table[r0:r1].view(torch.int8)))
                    .view(table.dtype),
                    pg.gather_stack(part(scale.detach()[r0:r1])),
                    store_dtype)
            yield r0, r1, (stack.cpu().numpy() if keep else None)

    def get_weights(self, all_ranks: bool = False
                    ) -> Optional[List[np.ndarray]]:
        """Global per-table weights in original table order, as numpy:
        the dp tables as they are, each tp table from its placements'
        column slices in column order, each row-sliced table from the
        ranks' shards in rank order (JAX `get_weights` :4412-4486), with
        the hot-resident rows written over their tables' rows (the hot
        shard is authoritative for them while resident). Always float32: a
        quantized bucket's rows are decoded, as the JAX package's portable
        dump is.

        Collective at world size > 1: every rank calls it. Each bucket's
        and each row table's ``[world, rows_max, w]`` stack is gathered in
        row chunks (`_gather_rows`), one table at a time, and each chunk's
        rows are copied out to the tables on the host. With `all_ranks`
        False (the reference's default) only rank 0 assembles and returns
        the weights; the other ranks take part in the gathers and return
        None."""
        strat = self.strategy
        keep = all_ranks or self.rank == 0
        out: List[Optional[np.ndarray]] = [None] * len(strat.global_configs)
        if keep:
            for gtid in strat.table_groups[1] + strat.table_groups[2]:
                cfg = strat.global_configs[gtid]
                out[gtid] = np.empty((cfg["input_dim"], cfg["output_dim"]),
                                     np.float32)
            for j, gtid in enumerate(strat.table_groups[0]):
                out[gtid] = self.dp[j].detach().cpu().numpy().copy()
        for b, table in enumerate(self.tp):
            places = [p for p in self.plan.tp_placements if p.bucket == b]
            for r0, r1, host in self._gather_rows(
                    table, keep, self._bucket_scale(b),
                    self._bucket_store_dtype(b)):
                if host is None:
                    continue
                for pl_ in places:
                    lo = max(r0, pl_.row_offset)
                    hi = min(r1, pl_.row_offset + pl_.rows)
                    if lo >= hi:
                        continue
                    gtid = strat.table_groups[1][pl_.table_id]
                    out[gtid][lo - pl_.row_offset:hi - pl_.row_offset,
                              pl_.col_start:pl_.col_end] = \
                        host[pl_.rank, lo - r0:hi - r0]
        for t, table in enumerate(self.row):
            rt = self.plan.row_tables[t]
            gtid = strat.table_groups[2][t]
            starts = np.cumsum([0] + rt.rows_per_rank)
            for r0, r1, host in self._gather_rows(table, keep):
                if host is None:
                    continue
                for r, rows in enumerate(rt.rows_per_rank):
                    hi = min(r1, rows)
                    if r0 < hi:
                        out[gtid][starts[r] + r0:starts[r] + hi] = \
                            host[r, :hi - r0]
        if keep:
            self._overlay_hot(out)
        return out if keep else None

    def _hot_key_rows(self, b: int, keys):
        """Decode hot bucket b's flat keys (``rank * rows_max + local
        row``, numpy or a CPU tensor) over its tp placements: a list of
        (global table id, placement, mask, rows), one for each placement
        that holds some of `keys`: `mask` marks those keys, `rows` are
        their rows in the table. A column-sliced table has one entry a
        slice. Inverse: `_hot_keys_of`."""
        rows_max = max(self.plan.tp_buckets[b].rows_max, 1)
        rank, local = keys // rows_max, keys % rows_max
        out = []
        for pl_ in self.plan.tp_placements:
            if pl_.bucket != b:
                continue
            m = ((rank == pl_.rank) & (local >= pl_.row_offset)
                 & (local < pl_.row_offset + pl_.rows))
            if bool(m.any()):
                out.append((self.strategy.table_groups[1][pl_.table_id],
                            pl_, m, local[m] - pl_.row_offset))
        return out

    def _hot_keys_of(self, rows: dict) -> dict:
        """{bucket: flat keys} of the rows {global table id: rows}, the
        inverse of `_hot_key_rows` (each of a column-sliced table's slices
        gets the keys of its bucket)."""
        out: dict = {}
        for pl_ in self.plan.tp_placements:
            gtid = self.strategy.table_groups[1][pl_.table_id]
            if gtid in rows:
                rows_max = max(self.plan.tp_buckets[pl_.bucket].rows_max, 1)
                out.setdefault(pl_.bucket, []).extend(
                    pl_.rank * rows_max + pl_.row_offset + int(r)
                    for r in rows[gtid])
        return out

    def _overlay_hot(self, out: List[np.ndarray]) -> None:
        """Write the hot-resident rows (`hot_resident_rows`, authoritative
        while resident) over their tables' rows in `out`, in place."""
        for b, (keys, rows) in self.hot_resident_rows().items():
            for gtid, pl_, m, local in self._hot_key_rows(b, keys):
                out[gtid][local, pl_.col_start:pl_.col_end] = rows[m]

    @torch.no_grad()
    def set_weights(self, weights: Sequence) -> None:
        """Write global per-table weights (numpy arrays, tensors or .npy
        paths, which are memory-mapped) into this rank's tables in place:
        every rank passes the same list and writes the dp tables, its own
        tp placements and its own rows of each row-sliced table (the
        shard's padding rows zero). A quantized bucket's rows are encoded,
        rounding to nearest (the JAX package's `encode_rows_np`), in
        chunks of at most `ENCODE_CHUNK_ELEMS` elements. The hot sets
        start empty, as in the JAX package."""
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

        def host(w, rows=slice(None), cols=slice(None)):
            return torch.from_numpy(np.array(
                w[rows, cols], dtype=np.float32, order="C"))
        for j, gtid in enumerate(strat.table_groups[0]):
            self.dp[j].copy_(host(weights[gtid]))
        for pl_ in self.plan.tp_placements:
            if pl_.rank != self.rank:
                continue
            w = weights[strat.table_groups[1][pl_.table_id]]
            cols = slice(pl_.col_start, pl_.col_end)
            if self._bucket_store_dtype(pl_.bucket) == "f32":
                self.tp[pl_.bucket][pl_.row_offset:pl_.row_offset
                                    + pl_.rows].copy_(host(w, cols=cols))
                continue
            chunk = max(1, self.ENCODE_CHUNK_ELEMS // (cols.stop - cols.start))
            for r0 in range(0, pl_.rows, chunk):
                r1 = min(pl_.rows, r0 + chunk)
                self._encode_into(pl_.bucket, pl_.row_offset + r0,
                                  host(w, slice(r0, r1), cols))
        for t, gtid in enumerate(strat.table_groups[2]):
            rt = self.plan.row_tables[t]
            start = int(sum(rt.rows_per_rank[:self.rank]))
            rows = rt.rows_per_rank[self.rank]
            self.row[t][:rows].copy_(
                host(weights[gtid], rows=slice(start, start + rows)))
            self.row[t][rows:].zero_()
        # the global weights are the canonical tables: the hot sets start
        # empty (admit again with sync_hot_rows)
        self._reset_hot()


def _local_tables(module: nn.Module) -> set:
    """The ids of the rank-local tables (bucket tables, their scales and
    row shards) of every `DistributedEmbedding` inside `module`; its dp
    tables are replicas, the same on every rank."""
    return {id(t) for m in module.modules()
            if isinstance(m, DistributedEmbedding)
            for t in list(m.tp) + list(m.row)
            + list(getattr(m, "tp_scale", ()))}


@torch.no_grad()
def broadcast_variables(variables, root_rank: int = 0):
    """Rank `root_rank`'s values of `variables` on every rank, in place
    (the reference's broadcast of the initial data-parallel weights,
    which skips the model-parallel ones). `variables`: a module, whose
    parameters and buffers are broadcast except the rank-local tables of
    its `DistributedEmbedding` layers (bucket tables and row shards; the
    dp tables are broadcast), or a sequence of tensors. Collective: every
    rank calls it. Returns `variables`; at world size 1, untouched."""
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
