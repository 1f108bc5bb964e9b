"""Core single-device embedding lookup ops in plain PyTorch.

Counterpart of ``distributed_embeddings_tpu/ops/embedding_ops.py``: dense,
ragged (CSR) and sparse (COO) id inputs, gathered with ``index_select`` and
reduced with ``index_add_``. The hot multi-hot path of the layers goes
through the CUDA kernel in `ops.cuda_lookup` instead.
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
