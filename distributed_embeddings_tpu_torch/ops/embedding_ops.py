"""Core single-device embedding lookup ops in plain PyTorch.

Counterpart of ``distributed_embeddings_tpu/ops/embedding_ops.py``: dense,
ragged (CSR) and sparse (COO) id inputs, gathered with ``index_select`` and
reduced with ``index_add_``. The hot multi-hot path of the layers goes
through the CUDA kernels in `ops.cuda_lookup` and `ops.cuda_tiled` instead.

`GroupSort` / `canonical_id_sort` are the sort artifacts one exchange group's
id stream shares between its lookup and its sparse update (sort folding),
and `segment_bounds` turns a sorted stream's segment starts into the
per-segment positions the sparse kernels walk. `sorted_member_positions`
splits an id stream against a sorted key table (the hot-row split).
`miss_only_ids` and `masked_two_source_gather` are the serving hot-row
cache's row selection, `ordered_row_sum` the fixed-order combine that the
offloaded lookup and the cache share.
"""

from typing import NamedTuple, Optional, Tuple, Union

import torch


class RaggedIds(NamedTuple):
    """CSR-format ragged id batch: ``values`` are ids, ``row_splits``
    offsets. ``values`` may be padded past ``row_splits[-1]``; padded
    entries are ignored."""

    values: torch.Tensor      # [nnz_max] int32/int64 ids
    row_splits: torch.Tensor  # [batch + 1] monotonically increasing offsets

    @property
    def nrows(self) -> int:
        return self.row_splits.shape[0] - 1

    def row_lengths(self) -> torch.Tensor:
        return self.row_splits[1:] - self.row_splits[:-1]

    @staticmethod
    def from_row_lengths(values: torch.Tensor,
                         row_lengths: torch.Tensor) -> "RaggedIds":
        row_splits = torch.cat([row_lengths.new_zeros(1),
                                torch.cumsum(row_lengths, 0)])
        return RaggedIds(values=values, row_splits=row_splits)


def canonical_keys(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The canonical sort key of an id stream: ids in [0, rows) keep their
    value, negative ids and ids >= rows key to `rows`. int32 where the
    keys and the ``rows + n`` fillers `dedup_sum` builds from them fit,
    else int64."""
    n = ids.shape[0]
    dtype = torch.int32 if rows + n < 2**31 else torch.int64
    oob = (ids < 0) | (ids >= rows)
    return torch.where(oob, torch.full((), rows, dtype=ids.dtype,
                                       device=ids.device), ids).to(dtype)


class GroupSort(NamedTuple):
    """Sort artifacts of one flattened id stream, produced once by the
    tapped forward and shared by its lookup and its sparse update (the
    JAX package's `GroupSort`; the original library's CUDA backward reuses
    the forward's sorted ids the same way).

      sid:       [N] ascending canonical keys (`canonical_keys`).
      perm:      [N] int64, ``ids.reshape(-1)[perm[n]]`` has key sid[n].
      seg_start: [N] bool, True where sid starts a new segment.
      inv:       [N] int64 inverse permutation (``inv[perm[n]] == n``), or
                 None when no consumer restores the original order.
    """

    sid: torch.Tensor
    perm: torch.Tensor
    seg_start: torch.Tensor
    inv: Optional[torch.Tensor] = None


def segment_starts(sid: torch.Tensor) -> torch.Tensor:
    """[N] bool: True where the sorted keys `sid` start a new segment."""
    is_start = torch.ones(sid.shape[0], dtype=torch.bool, device=sid.device)
    if sid.shape[0] > 1:
        torch.ne(sid[1:], sid[:-1], out=is_start[1:])
    return is_start


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """``inv`` with ``inv[perm[n]] == n``: one index scatter, exact. (The
    JAX package inverts with a second sort, because a scatter was slow on
    the TPU.)"""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def canonical_id_sort(ids: torch.Tensor, rows: int,
                      want_inv: bool = False) -> GroupSort:
    """One stable sort (``torch.sort(stable=True)``) of a flattened id
    stream under the canonical key. `rows` must be the consuming table's
    ``shape[0]``, the sentinel `dedup_sum` uses, so that an update that
    consumes the artifact is bit-identical to one that sorts afresh."""
    sid, perm = torch.sort(canonical_keys(ids.reshape(-1), rows),
                           stable=True)
    return GroupSort(sid, perm, segment_starts(sid),
                     inverse_permutation(perm) if want_inv else None)


def segment_keys(sid: torch.Tensor, seg: torch.Tensor,
                 sentinel: int) -> torch.Tensor:
    """Per segment slot s of a sorted stream (`segment_bounds`' seg), the
    key of segment s; an unused slot s holds ``sentinel + s``: unique and
    strictly increasing, `dedup_sum`'s rep."""
    rep = torch.arange(sid.shape[0], dtype=torch.int64,
                       device=sid.device) + sentinel
    return rep.to(sid.dtype).scatter_(0, seg, sid)


def segment_bounds(seg_start: torch.Tensor):
    """(starts [N+1] int64, seg [N] int64) of a sorted stream with segment
    starts `seg_start`: segment s covers sorted positions
    [starts[s], starts[s+1]); slots past the last segment hold N (empty);
    ``seg[j]`` is the segment of position j. No host sync: a cumsum and
    one scatter, whose non-starts land in a dump slot."""
    n = seg_start.shape[0]
    dev = seg_start.device
    seg = torch.cumsum(seg_start, 0) - 1
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    starts = torch.full((n + 2,), n, dtype=torch.int64, device=dev)
    starts.scatter_(0, torch.where(seg_start, seg, n + 1), iota)
    return starts[:n + 1], seg


def read_var_no_copy(params: torch.Tensor) -> torch.Tensor:
    """The reference's ReadVariableNoCopy op, which read a TF resource
    variable without a copy of the whole table: a tensor is read in place
    here, so this is the identity."""
    return params


def row_to_split(row_ids: torch.Tensor, nrows: int) -> torch.Tensor:
    """Sorted COO row indices -> CSR row splits [nrows + 1] (the
    reference's RowToSplit kernel): ``splits[r]`` is the first position
    whose row is at least r, in `row_ids`' dtype."""
    rows = torch.arange(nrows + 1, dtype=row_ids.dtype,
                        device=row_ids.device)
    return torch.searchsorted(row_ids, rows, side="left").to(row_ids.dtype)


class SparseIds(NamedTuple):
    """COO-format sparse id batch: ``indices`` [nnz, 2] (row, col) with rows
    ascending; ``dense_shape`` is (batch, max_hotness)."""

    indices: torch.Tensor          # [nnz, 2] int
    values: torch.Tensor           # [nnz] int ids
    dense_shape: Tuple[int, int]


IdsLike = Union[torch.Tensor, RaggedIds, SparseIds]


def _segment_combine(embs: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int, combiner: str,
                     row_lengths: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Segment sum (or mean) of embs [nnz, w] by seg_ids; segment ids out of
    [0, num_segments) are dropped."""
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    out = embs.new_zeros((num_segments, embs.shape[-1]))
    out.index_add_(0, seg_ids[keep], embs[keep])
    if combiner == "mean":
        if row_lengths is None:
            row_lengths = torch.bincount(seg_ids[keep],
                                         minlength=num_segments)
        out = out / row_lengths.to(out.dtype).clamp_min(1.0)[:, None]
    return out


def embedding_lookup(params: torch.Tensor, ids: IdsLike,
                     combiner: Optional[str] = None) -> torch.Tensor:
    """Look up embeddings for `ids` from table `params`, optionally combined.

      * ``combiner=None``: plain gather; output ``ids.shape + [width]``.
      * dense 2-D ids [batch, hotness]: gather, then reduce over hotness.
      * RaggedIds: CSR segment sum/mean.
      * SparseIds: COO rows as segment ids.
    """
    if combiner not in (None, "sum", "mean"):
        raise ValueError(f"Unsupported combiner {combiner}")

    if isinstance(ids, RaggedIds):
        if combiner is None:
            raise ValueError("Ragged input requires a combiner")
        nnz = ids.values.shape[0]
        positions = torch.arange(nnz, dtype=ids.row_splits.dtype,
                                 device=ids.row_splits.device)
        seg_ids = torch.searchsorted(ids.row_splits, positions,
                                     right=True) - 1
        valid = positions < ids.row_splits[-1]
        seg_ids = torch.where(valid, seg_ids, torch.full_like(seg_ids, -1))
        embs = params.index_select(0, ids.values.clamp(0, params.shape[0] - 1))
        return _segment_combine(embs, seg_ids, ids.nrows, combiner,
                                row_lengths=ids.row_lengths())

    if isinstance(ids, SparseIds):
        if combiner is None:
            raise ValueError("Sparse input requires a combiner")
        embs = params.index_select(0, ids.values)
        return _segment_combine(embs, ids.indices[:, 0],
                                int(ids.dense_shape[0]), combiner)

    ids = torch.as_tensor(ids, device=params.device)
    if ids.is_floating_point():
        ids = ids.to(torch.int32)
    if combiner is None:
        return params[ids]
    if ids.dim() != 2:
        raise ValueError(
            f"Only 2-D dense ids supported with combiner, got ndim={ids.dim()}")
    if ids.shape[1] == 1:
        return params.index_select(0, ids[:, 0])
    embs = params[ids]
    if combiner == "sum":
        return embs.sum(dim=1)
    return embs.mean(dim=1)


def embedding_lookup_weighted(params: torch.Tensor, ids: torch.Tensor,
                              weights: torch.Tensor,
                              combiner: str = "sum") -> torch.Tensor:
    """Dense padded multi-hot lookup with per-id weights: ids [batch, k]
    padded with arbitrary ids, weights [batch, k] carrying 0 for padding."""
    embs = params[ids]                                    # [batch, k, width]
    out = torch.einsum("bk,bkw->bw", weights.to(embs.dtype), embs)
    if combiner == "mean":
        denom = weights.sum(dim=1).clamp_min(1.0).to(out.dtype)
        out = out / denom[:, None]
    return out


def ragged_to_padded(ids: RaggedIds, max_hotness: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR ragged ids -> (padded_ids [batch, k], weights [batch, k]): weights
    are 1.0 on valid slots and 0.0 on padding."""
    starts = ids.row_splits[:-1]
    lengths = ids.row_lengths()
    offs = torch.arange(max_hotness, dtype=ids.row_splits.dtype,
                        device=ids.row_splits.device)
    gather_pos = starts[:, None] + offs[None, :]
    valid = offs[None, :] < lengths[:, None]
    nnz = ids.values.shape[0]
    gather_pos = gather_pos.clamp(0, max(nnz - 1, 0))
    padded = ids.values[gather_pos]
    padded = torch.where(valid, padded, torch.zeros_like(padded))
    return padded, valid.to(torch.float32)


def sorted_member_positions(sorted_keys: torch.Tensor, queries: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership of `queries` in a sorted key table by binary search (the
    hot-row split's primitive; no sort): `sorted_keys` [H] ascending,
    absent slots padded with a sentinel above every real query. Returns
    (pos, hit): pos int32 of the queries' shape, the ``torch.searchsorted``
    (left) position clipped to [0, H), meaningful where hit; hit True
    where ``sorted_keys[pos]`` equals the query."""
    h = sorted_keys.shape[0]
    q = queries.to(sorted_keys.dtype).contiguous()
    pos = torch.searchsorted(sorted_keys.contiguous(), q)
    pos = pos.clamp(0, max(h - 1, 0))
    hit = sorted_keys[pos] == q
    return pos.to(torch.int32), hit


def miss_only_ids(ids: torch.Tensor, slot_idx: torch.Tensor) -> torch.Tensor:
    """Cache-hit lanes' ids set to row 0 for the miss-side table gather
    (JAX `miss_only_ids` :273): lanes with ``slot_idx >= 0`` are served
    from the cache's slots, so the fallback gather reads one dummy row
    for them instead of their own and the table sees no traffic in
    proportion to the hits. Shapes broadcast elementwise."""
    return torch.where(slot_idx >= 0, torch.zeros((), dtype=ids.dtype,
                                                  device=ids.device), ids)


def masked_two_source_gather(slots: torch.Tensor, slot_idx: torch.Tensor,
                             fallback_rows: torch.Tensor) -> torch.Tensor:
    """Rows from a cache tensor or from pre-gathered fallback rows (JAX
    `masked_two_source_gather` :284): lanes with ``slot_idx >= 0`` take
    ``slots[slot_idx]``, the others the matching row of `fallback_rows`.

    Args:
      slots: [capacity, width] cached rows.
      slot_idx: [...] integer slot per lane, negative = miss.
      fallback_rows: [..., width] rows for the miss lanes (the hit lanes'
        values are ignored).

    Returns [..., width] in `fallback_rows`' dtype."""
    hit = slot_idx >= 0
    safe = slot_idx.clamp(0, slots.shape[0] - 1).long()
    cached = slots[safe].to(fallback_rows.dtype)
    return torch.where(hit[..., None], cached, fallback_rows)


def ordered_row_sum(rows: torch.Tensor, weights: Optional[torch.Tensor],
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The combine of an offloaded bucket's rows, [M, k, w] -> [M, w], in
    one fixed order on every device: term j is ``rows[:, j]`` (times
    ``weights[:, j]``, [M, k], where given: its own rounding, never fused
    with the add), and the terms are added left to right, ``((t0 + t1) +
    t2) + ...``, each add rounded. The host path (`DistributedEmbedding.
    _offload_group_out`) and the cached path on the card
    (`serving.cache.cached_group_lookup`) both combine through it, so
    their outputs agree bit for bit; ``torch.sum`` picks its order per
    device and shape. `out`, if given, receives the result."""
    k = rows.shape[1]

    def term(j):
        r = rows[:, j]
        return r if weights is None else r * weights[:, j, None]
    acc = term(0)
    if out is not None:
        out.copy_(acc)
        acc = out
    elif weights is None:
        acc = acc.clone()
    for j in range(1, k):
        acc.add_(term(j))
    return acc
