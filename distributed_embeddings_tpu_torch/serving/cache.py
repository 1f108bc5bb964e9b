"""Device-resident hot-row cache over a host-offloaded bucket.

Counterpart of ``distributed_embeddings_tpu/serving/cache.py``
(`HotRowCache` :64, `cached_group_lookup` :317). An offloaded bucket lives
in pinned host memory, and every lookup into it pays the host round trip;
serving traffic is power-law distributed, so a few rows take most lookups.
The cache keeps those rows on the card:

  * **Device side.** `slots`, a ``[capacity, width]`` float32 tensor on the
    layer's device. The cached lookup (`cached_group_lookup`) gathers the
    hit lanes' rows from it (`ops.embedding_ops.masked_two_source_gather`)
    and only the miss lanes' rows from the host table, with the hit lanes'
    ids set to row 0 (`miss_only_ids`), so a hit makes no traffic in the
    host table.
  * **Host side.** The key -> slot index, the access counters and the
    admission policy: `utils.hotness.HotnessTracker`, the training hot
    shard's tracker. A row is promoted once its count reaches
    `promote_threshold`; when the cache is full, a candidate evicts the
    coldest resident only if its count is strictly higher.
  * **Consistency.** Slots are copies of table rows taken at admission or
    refresh; the cache does not see table writes. After anything mutates
    the bucket, `refresh_from(store)` re-reads every resident row, and
    `apply_rows` patches resident rows straight from a row delta's
    payload.

Slots are written by row (`_update_slots`: an ``index_copy_`` from a
pinned staging buffer), never re-uploaded whole. A quantized bucket is
decoded as its rows are read: slots hold float32 rows (the JAX package's
decode seam). Rows are keyed by ``rank * rows_max + row``.

At world size > 1 every rank serves the same request, so every rank's
tracker observes the same global key stream (the engine's `_group_keys`
mirrors every destination shard's exchanged ids) and makes the same
admissions, evictions and slot numbers, which are the JAX cache's (its
slots are replicated over the mesh); no collective is needed. Each rank
writes into its slots only the rows of keys in its own world slice, read
from its own shard of the bucket, and its lookup reads only the slots of
its own shard's lanes, which never hold another slice's key; a slot of
another slice's key holds whatever it held, and no lane of this rank
reads it. The refresh and the delta patches likewise touch only this
rank's keys; the stats are the same on every rank.
"""

from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    _effective_weights, _scaled)
from distributed_embeddings_tpu_torch.ops import wire
from distributed_embeddings_tpu_torch.ops.embedding_ops import (
    masked_two_source_gather, miss_only_ids, ordered_row_sum)
from distributed_embeddings_tpu_torch.utils.hotness import HotnessTracker

__all__ = ["CACHE_LOOKUP_RANGE", "HotRowCache", "cached_group_lookup"]

# the profiler range of one cached group lookup (the ids to the host, the
# miss rows' gather and copy, the two-source gather and the combine)
CACHE_LOOKUP_RANGE = "cache:lookup"


def _pinned(shape, dtype, cuda: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=cuda)


def _host_rows(emb, b: int, table: torch.Tensor, ids: torch.Tensor,
               scale: Optional[torch.Tensor], out: torch.Tensor
               ) -> torch.Tensor:
    """Rows of host bucket `b` at `ids` ([M] int64 on the host) into
    `out` ([M, w] float32): a float32 table by ``index_select``, a
    quantized one's payload and scale rows gathered and decoded, as the
    layer's decode-gather (`_quantized_rows`) does it."""
    if emb._bucket_store_dtype(b) == "f32":
        return torch.index_select(table.detach(), 0, ids, out=out)
    payload = table.detach()
    rows = wire.decode_rows(
        payload.view(torch.uint8).index_select(0, ids).view(payload.dtype),
        scale.detach().index_select(0, ids), emb._bucket_store_dtype(b))
    return out.copy_(rows)


class HotRowCache:
    """Device-resident cache over one offloaded bucket's rows.

    Args:
      emb: the `DistributedEmbedding` owning the bucket (any world size;
        this rank's shard of it).
      bucket: index into ``emb.plan.tp_buckets`` (must be offloaded).
      capacity: the rows the slots hold.
      promote_threshold: access count at which a row can be promoted (>=
        1; 1 promotes on first touch).
      max_tracked: bound on the tracked counters (default: the tracker's,
        max(64 * capacity, 4096)).
    """

    def __init__(self, emb, bucket: int, capacity: int,
                 promote_threshold: int = 2,
                 max_tracked: Optional[int] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if promote_threshold < 1:
            raise ValueError("promote_threshold must be >= 1")
        bk = emb.plan.tp_buckets[bucket]
        if not (bk.offload and emb._offload_enabled):
            raise ValueError(
                f"bucket {bucket} is not host-offloaded; a hot-row cache "
                "only makes sense over a host-resident table")
        self.emb = emb
        self.bucket = bucket
        self.capacity = int(capacity)
        self.promote_threshold = int(promote_threshold)
        self.width = bk.width
        self.rows_max = max(bk.rows_max, 1)
        # quantized storage: slots hold decoded float32 rows
        self.store_dtype = bk.storage_dtype
        self._tracker = HotnessTracker(capacity,
                                       promote_threshold=promote_threshold,
                                       max_tracked=max_tracked)
        self.max_tracked = self._tracker.max_tracked
        self._slots = torch.zeros((self.capacity, self.width),
                                  dtype=torch.float32, device=emb.device)
        self._cuda = self._slots.device.type == "cuda"
        self.refreshes = 0
        # store version the residents were last refreshed or patched at
        # (None until a store-routed refresh has run)
        self.refreshed_version = None
        # resident slots written from delta payloads (`apply_rows`)
        self.patched = 0

    # tracker views: the host-side state lives on the shared tracker
    @property
    def _index(self) -> Dict[int, int]:
        return self._tracker._index

    @property
    def _counts(self) -> Dict[int, int]:
        return self._tracker._counts

    @property
    def _pending(self) -> set:
        return self._tracker._pending

    @property
    def _slot_keys(self) -> np.ndarray:
        return self._tracker.slot_keys

    @property
    def hits(self) -> int:
        return self._tracker.hits

    @property
    def misses(self) -> int:
        return self._tracker.misses

    @property
    def promotions(self) -> int:
        return self._tracker.promotions

    @property
    def evictions(self) -> int:
        return self._tracker.evictions

    # ------------------------------------------------------------ device IO
    def _update_slots(self, slot_idx, rows) -> None:
        """Write `rows` ([M, w] float32, numpy or a host tensor) into slots
        `slot_idx`: only these rows cross to the card, from a pinned
        staging buffer, by one ``index_copy_``."""
        idx = torch.as_tensor(np.asarray(slot_idx, np.int64))
        rows = torch.as_tensor(rows, dtype=torch.float32)
        if self._cuda:
            if not rows.is_pinned():
                rows = _pinned(rows.shape, torch.float32, True).copy_(rows)
            idx = idx.pin_memory()
        dev = self._slots.device
        self._slots.index_copy_(0, idx.to(dev, non_blocking=True),
                                rows.to(dev, non_blocking=True))

    @property
    def slots(self) -> torch.Tensor:
        """The device-resident ``[capacity, width]`` row tensor."""
        return self._slots

    def _own(self, keys: np.ndarray) -> np.ndarray:
        """True on the keys of this rank's world slice."""
        return np.asarray(keys, np.int64) // self.rows_max == self.emb.rank

    def _read_rows(self, table: Optional[torch.Tensor], keys: np.ndarray,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Table rows for `keys` ([M] int64, this rank's) gathered on the
        host into a pinned buffer, decoded to float32 from a quantized
        bucket (through `scale`, default the bucket's own); `table`
        defaults to the layer's bucket (this rank's shard)."""
        emb, b = self.emb, self.bucket
        table = emb.tp[b] if table is None else table
        if scale is None:
            scale = emb._bucket_scale(b)
        ids = torch.from_numpy(np.asarray(keys, np.int64) % self.rows_max)
        out = _pinned((len(ids), self.width), torch.float32, self._cuda)
        return _host_rows(emb, b, table, ids, scale, out)

    # ------------------------------------------------------- host-side index
    def lookup_slots(self, keys: np.ndarray,
                     valid: Optional[np.ndarray] = None,
                     observe: bool = True) -> np.ndarray:
        """Map row keys to cache slots: >= 0 on a hit, -1 on a miss.

        Args:
          keys: int64 array (any shape) of ``rank * rows_max + row`` keys.
          valid: optional same-shape bool mask; invalid lanes (padding)
            map to -1 and touch no counter.
          observe: update the access counters and the hit / miss stats
            (warmup passes False).

        Returns an int32 array of `keys`' shape."""
        return self._tracker.lookup_slots(keys, valid=valid, observe=observe)

    def admit(self, table: Optional[torch.Tensor] = None,
              scale: Optional[torch.Tensor] = None) -> int:
        """Run the admission policy against the current counters, copying
        the newly promoted rows of this rank's keys out of `table`
        (default: the layer's bucket; decoded through `scale` at a
        quantized storage). Returns the rows promoted (on every rank)."""
        plan = self._tracker.plan_admissions()
        if not plan:
            return 0
        keys = np.asarray([k for _, k in plan], np.int64)
        own = self._own(keys)
        if own.any():
            rows = self._read_rows(table, keys[own], scale=scale)
            self._update_slots(np.asarray([s for s, _ in plan])[own], rows)
        return self._tracker.commit_admissions(plan)

    def _own_residents(self) -> np.ndarray:
        """The slots holding keys of this rank's world slice."""
        keys = self._slot_keys
        return np.flatnonzero((keys >= 0) & self._own(keys))

    def refresh(self, table: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None) -> int:
        """Re-copy every resident row of this rank's keys from `table`
        (default: the layer's bucket) into the slots: required after
        anything mutates the bucket. Prefer `refresh_from(store)` where a
        `TableStore` owns the tables. Returns the rows refreshed."""
        resident = self._own_residents()
        if len(resident):
            rows = self._read_rows(table, self._slot_keys[resident],
                                   scale=scale)
            self._update_slots(resident, rows)
        self.refreshes += 1
        return int(len(resident))

    def refresh_from(self, store) -> int:
        """Re-copy every resident row of this rank's keys through the
        table store's versioned rank-local read (`read_local_rows`), and
        record the store version the residents now reflect
        (`refreshed_version`). Returns the rows refreshed."""
        resident = self._own_residents()
        if len(resident):
            rows = store.read_local_rows(self.bucket,
                                         self._slot_keys[resident])
            self._update_slots(resident, rows)
        self.refreshes += 1
        self.refreshed_version = store.version
        return int(len(resident))

    def apply_rows(self, keys: np.ndarray, rows: np.ndarray) -> int:
        """A row delta's payload written into the resident slots among
        `keys` of this rank's world slice (the publisher's merged rows, so
        no table read happens); counters and stats are untouched. Returns
        the slots updated."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        slot = self._tracker.lookup_slots(keys, observe=False)
        m = (slot >= 0) & self._own(keys)
        if m.any():
            self._update_slots(slot[m], np.asarray(rows)[m])
        self.patched += int(m.sum())
        return int(m.sum())

    def invalidate(self) -> None:
        """Drop every resident row (hits resume after re-admission)."""
        self._tracker.invalidate()

    # ---------------------------------------------------------------- stats
    @property
    def hit_rate(self) -> float:
        return self._tracker.hit_rate

    def stats(self) -> dict:
        return {"bucket": self.bucket, "capacity": self.capacity,
                "resident": int((self._slot_keys >= 0).sum()),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hit_rate, 4),
                "promotions": self.promotions, "evictions": self.evictions,
                "refreshes": self.refreshes}


def cached_group_lookup(emb, grp, table_h, slots, ids_g, slot_g, w_g,
                        scale_h=None):
    """One offloaded exchange group's output through the hot-row cache
    (JAX `cached_group_lookup` :317), bit-equal to the layer's host path
    (`DistributedEmbedding._offload_group_out`): the same rows, the same
    combine order (`ordered_row_sum`), the same cast and scale. Only the
    row source differs:

      1. the ids come to the host, clamped into the bucket; miss lanes
         keep their id, hit lanes read row 0 (`miss_only_ids`);
      2. the rows are gathered on the host (decoded there from a
         quantized bucket) into a pinned buffer and copied to the card
         once, without blocking;
      3. the slot indices go to the card, where the masked two-source
         gather takes each hit lane's row from `slots`;
      4. the combine runs on the card: the weight products first, each
         rounded, then the k terms added left to right;
      5. the cast to the compute dtype and the unweighted mean's scale.

    The host path combines on the host and copies ``[B, f, w]`` combined
    rows; here the raw rows cross, k times as many bytes for a multi-hot
    group, because the hit rows already live on the card: splitting the
    combine between the devices would change the order of the adds. A
    one-hot group (the Criteo shape) moves the same bytes.

    Args:
      table_h: the bucket's host table (its payload at quantized storage).
      slots: [capacity, width] device-resident cached rows.
      ids_g: [B, f, k] exchanged absolute rows (this rank's shard's lanes
        over the global batch).
      slot_g: [B * f * k] integer slot indices on the host (-1 = miss),
        this rank's row of the engine's slot map.
      w_g: [B, f, k] effective weights or None.
      scale_h: the bucket's per-row scale at quantized storage (default
        the layer's).

    Returns [B, f, w_out]: the group's output, as the host path's."""
    b = grp.bucket
    bucket = emb.plan.tp_buckets[b]
    k, wf = grp.k, bucket.width
    rows_max = max(bucket.rows_max, 1)
    scale = (_effective_weights(None, k, bucket.combiner)[1]
             if w_g is None else 1.0)
    if scale_h is None:
        scale_h = emb._bucket_scale(b)
    dev = slots.device
    cuda = dev.type == "cuda"
    b_sz, f = ids_g.shape[0], ids_g.shape[1]
    with record_function(CACHE_LOOKUP_RANGE):
        ids_h = emb._to_host(ids_g.clamp(0, rows_max - 1).reshape(-1)
                             .long())[0]
        slot_h = torch.as_tensor(slot_g).reshape(-1)
        n = ids_h.shape[0]
        miss = _host_rows(emb, b, table_h, miss_only_ids(ids_h, slot_h),
                          scale_h, _pinned((n, wf), torch.float32, cuda))
        if cuda:
            emb.offload_traffic["htod_bytes"] += miss.numel() * 4
            slot_h = slot_h.pin_memory()
        rows = masked_two_source_gather(
            slots, slot_h.to(dev, non_blocking=True),
            miss.to(dev, non_blocking=True))
        if bucket.combiner is None:
            out = rows.view(b_sz, f, k * wf)
        else:
            out = ordered_row_sum(
                rows.view(b_sz * f, k, wf),
                None if w_g is None else w_g.reshape(b_sz * f, k).float()
            ).view(b_sz, f, wf)
    return _scaled(emb._cast(out), scale)
