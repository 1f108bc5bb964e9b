"""Evaluation metrics: the thresholded streaming AUC and the exact AUC.

Counterpart of ``distributed_embeddings_tpu/utils/metrics.py``. The
reference evaluates DLRM with tf.keras.metrics.AUC over allgathered
predictions (reference: examples/dlrm/main.py:223-243); here, as in the
JAX package, the accumulation is a fixed-size histogram update on the
device, with the trapezoidal integration on the host at the end.

The histograms are float32, as the JAX package keeps them: each bin adds
0.0 / 1.0 counts, exact up to 2^24 a bin, so the order of the additions
(``index_add_``'s atomics on a card) does not change them.

`LatencyHistogram`, the host-side histogram of serving latencies and
ingest stages, lives in `obs.registry` and is re-exported here, as the JAX
package does.
"""

from typing import NamedTuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.obs.registry import LatencyHistogram
from distributed_embeddings_tpu_torch.parallel import mesh
from distributed_embeddings_tpu_torch.utils.device import (DeviceLike,
                                                           resolve_device)

__all__ = ["AUCState", "StreamingAUC", "auc_exact", "LatencyHistogram"]


class AUCState(NamedTuple):
    tp: torch.Tensor  # [bins] true positives per score bin
    fp: torch.Tensor  # [bins] false positives per score bin


class StreamingAUC:
    """Histogram-based ROC AUC (the tf.keras.metrics.AUC approach: bucket
    scores into `bins` thresholds, integrate the ROC curve).

    Usage:
      metric = StreamingAUC(bins=8192)
      state = metric.init(device)
      state = metric.update(state, labels, scores)   # no host sync
      value = metric.result(state)                    # host-side float
    """

    def __init__(self, bins: int = 8192, from_logits: bool = True):
        self.bins = bins
        self.from_logits = from_logits

    def init(self, device: DeviceLike = None) -> AUCState:
        """Zero histograms on `device` (None = cuda, as every entry point
        of the port; `resolve_device`)."""
        z = torch.zeros((self.bins,), dtype=torch.float32,
                        device=resolve_device(device))
        return AUCState(tp=z, fp=z.clone())

    @torch.no_grad()
    def update(self, state: AUCState, labels, scores) -> AUCState:
        """Add one batch's labels and scores (logits when `from_logits`)
        to the histograms, in place; returns the state."""
        dev = state.tp.device
        labels = torch.as_tensor(labels, device=dev).reshape(-1).float()
        scores = torch.as_tensor(scores, device=dev).reshape(-1).float()
        if self.from_logits:
            scores = torch.sigmoid(scores)
        # float -> int32 truncates toward zero, as XLA's convert does
        idx = (scores * self.bins).to(torch.int32).clamp(
            0, self.bins - 1).long()
        state.tp.index_add_(0, idx, labels)
        state.fp.index_add_(0, idx, 1.0 - labels)
        return state

    @torch.no_grad()
    def all_reduce(self, state: AUCState) -> AUCState:
        """Sum every rank's histograms, in place (collective at world
        size > 1: every rank calls it); the counterpart of the reference's
        ``hvd.allgather`` of the predictions in its eval loop."""
        if mesh.world_size() > 1:
            import torch.distributed as dist
            both = torch.stack([state.tp, state.fp])
            dist.all_reduce(both)
            state.tp.copy_(both[0])
            state.fp.copy_(both[1])
        return state

    def result(self, state: AUCState) -> float:
        """The trapezoidal area under the ROC curve of the histograms, on
        the host in numpy (float64 cumsums of the float32 counts)."""
        tp = state.tp.detach().cpu().numpy()[::-1]   # descending threshold
        fp = state.fp.detach().cpu().numpy()[::-1]
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        pos, neg = ctp[-1], cfp[-1]
        if pos == 0 or neg == 0:
            return 0.0
        tpr = np.concatenate([[0.0], ctp / pos])
        fpr = np.concatenate([[0.0], cfp / neg])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2
        return float(trapezoid(tpr, fpr))


def auc_exact(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC AUC via the rank-sum (Mann-Whitney U) formulation, ties
    given their average rank; host-side reference for tests and small
    validation sets."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    n = len(scores)
    _, inv, counts = np.unique(scores[order], return_inverse=True,
                               return_counts=True)
    cum = np.cumsum(counts)
    start = cum - counts
    avg = (start + cum + 1) / 2.0
    ranks[order] = avg[inv]
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))
