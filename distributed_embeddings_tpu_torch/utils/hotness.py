"""Counter-based hot-row admission: `HotnessTracker`.

Counterpart of ``distributed_embeddings_tpu/utils/hotness.py``, whose
class it copies (it is pure numpy; the port imports nothing of the JAX
package), with one change of speed, not of policy: a full set's coldest
slot comes from a heap built once an admission round, where the JAX
tracker scans every slot for each candidate (the serving cache holds
10^5–10^6 rows). The training hot shard (`DistributedEmbedding(
hot_rows=...)`: `observe_hot_ids`, `sync_hot_rows`, `hot_stats`) keeps one
tracker a hot bucket: per-row access counters (integer, or lazily decayed),
a bounded-memory pruning rule, the pending threshold-crossers, a
fixed-capacity resident set (key -> slot) and the admission and eviction
policy. It never touches device state: callers copy the rows, the tracker
only decides which rows are hot.

Rows are keyed by a non-negative integer: the stacked bucket's flat key
``rank * rows_max + local_row``.
"""

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["HotnessTracker"]


class HotnessTracker:
    """Access counters + admission policy over a fixed-capacity hot set.

    Args:
      capacity: number of resident slots (static).
      promote_threshold: access count at which a row becomes
        promotion-eligible (>= 1; 1 promotes on first touch).
      max_tracked: bound on the counter dict; beyond it, counters prune
        back to the hottest max_tracked/2 keys (plus residents). Default
        max(64 * capacity, 4096).
      decay: optional exponential aging factor in (0, 1]: each observing
        call ages every tracked count by `decay`, so a long-running
        stream's counts estimate recent frequency rather than all-time
        totals (streaming admission must follow key-universe
        drift — a key hot an hour ago must eventually lose to a key hot
        now). The steady-state count of a key seen n times per
        observation window converges to n / (1 - decay), so
        promote_threshold keeps its meaning as "sustained recent rate",
        and counts that age below `DECAY_EPSILON` are dropped (the
        aged-out analogue of `_prune_counts`, keeping the dict bounded
        by activity, not history). None (default) keeps the original
        integer all-time counters — bit-identical policy to every
        pre-decay caller.

        Implementation is LAZY: aging never sweeps the dict per batch
        (that would be O(tracked) Python work on every training step —
        unaffordable at production key rates). Counts are stored in
        inflated units (`stored = true * decay**-tick`); an observation
        just bumps the global tick and adds at the current inflation,
        so a single stored value ages implicitly as the tick advances.
        The dict is swept only every `DECAY_SWEEP_EVERY` ticks (aged-out
        eviction, amortized), and stored values renormalize before the
        inflation factor can overflow a double.
    """

    DECAY_EPSILON = 0.5       # aged counts below this stop being tracked
    DECAY_SWEEP_EVERY = 64    # aged-out eviction cadence (amortized)
    _SCALE_RENORM = 1e100     # renormalize stored units before overflow

    def __init__(self, capacity: int, promote_threshold: int = 2,
                 max_tracked: Optional[int] = None,
                 decay: Optional[float] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if promote_threshold < 1:
            raise ValueError("promote_threshold must be >= 1")
        if decay is not None and not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.capacity = int(capacity)
        self.promote_threshold = int(promote_threshold)
        self.decay = None if decay is None or decay == 1.0 else float(decay)
        self.max_tracked = int(max_tracked or max(64 * capacity, 4096))
        self._index: Dict[int, int] = {}          # row key -> slot
        self.slot_keys = np.full((self.capacity,), -1, np.int64)
        # row key -> access count. With decay, values are in INFLATED
        # units: true_count = stored / _scale, where _scale grows by
        # 1/decay per observing call (lazy aging — see class docstring)
        self._counts: Dict[int, float] = {}
        self._scale = 1.0
        self._ticks_since_sweep = 0
        self._pending: set = set()                # threshold-crossed keys
        # stats (valid lanes only — callers mask padding before observing)
        self.hits = 0
        self.misses = 0
        self.promotions = 0
        self.evictions = 0

    # ------------------------------------------------------------- observe
    def lookup_slots(self, keys: np.ndarray,
                     valid: Optional[np.ndarray] = None,
                     observe: bool = True) -> np.ndarray:
        """Map row keys to resident slots: >= 0 on hit, -1 on miss.

        Args:
          keys: integer array (any shape) of row keys.
          valid: optional same-shape bool mask; invalid lanes (exchange
            padding) always map to -1 and never touch counters or stats.
          observe: update access counters + hit/miss stats (warmup passes
            set False so compile-ahead does not skew admission).

        Returns an int32 array of `keys`' shape.
        """
        flat = np.asarray(keys, np.int64).reshape(-1)
        vmask = (np.ones(flat.shape, bool) if valid is None
                 else np.asarray(valid, bool).reshape(-1))
        out = np.full(flat.shape, -1, np.int32)
        if observe and self.decay is not None:
            self._tick_decay()
        pthr = self.promote_threshold * self._scale
        uniq, inv, counts = np.unique(flat[vmask], return_inverse=True,
                                      return_counts=True)
        slot_of = np.full(uniq.shape, -1, np.int32)
        for u, key in enumerate(uniq.tolist()):
            s = self._index.get(key)
            if s is not None:
                slot_of[u] = s
            if observe:
                # stored units are inflated by _scale (lazy decay); with
                # decay off, _scale stays 1.0 and these are the original
                # integer counters
                inc = (int(counts[u]) if self.decay is None
                       else counts[u] * self._scale)
                c = self._counts.get(key, 0) + inc
                self._counts[key] = c
                if s is None and c >= pthr:
                    self._pending.add(key)
        if observe and len(self._counts) > self.max_tracked:
            self._prune_counts()
        out[vmask] = slot_of[inv]
        if observe:
            n_hit = int((out[vmask] >= 0).sum())
            self.hits += n_hit
            self.misses += int(vmask.sum()) - n_hit
        return out.reshape(np.asarray(keys).shape)

    def observe(self, keys: np.ndarray,
                valid: Optional[np.ndarray] = None) -> None:
        """Count-only observation (the training warmup scan's form)."""
        self.lookup_slots(keys, valid=valid, observe=True)

    def _tick_decay(self) -> None:
        """One lazy aging tick: the inflation factor advances (every
        stored count is now implicitly `decay` smaller in true units —
        no dict traversal); periodically (DECAY_SWEEP_EVERY ticks, and
        whenever the factor nears double overflow) the dict is swept:
        stored values renormalize to the fresh scale, counts aged below
        DECAY_EPSILON leave (resident keys stay — the eviction policy
        must always be able to rank them), and pending keys whose aged
        count fell back under the threshold lose their eligibility."""
        self._scale /= self.decay
        self._ticks_since_sweep += 1
        if (self._ticks_since_sweep < self.DECAY_SWEEP_EVERY
                and self._scale <= self._SCALE_RENORM):
            return
        self._ticks_since_sweep = 0
        inv = 1.0 / self._scale
        resident = self._index
        kept = {}
        for k, c in self._counts.items():
            c *= inv                       # back to true units
            if c >= self.DECAY_EPSILON or k in resident:
                kept[k] = c
        self._counts = kept
        self._scale = 1.0
        if self._pending:
            self._pending = {k for k in self._pending
                             if kept.get(k, 0.0) >= self.promote_threshold}

    def _prune_counts(self) -> None:
        """Bound the counter dict: keep resident keys plus the hottest
        half of max_tracked; everything colder restarts from zero if seen
        again (an admissible information loss — a pruned key was, by
        construction, colder than max_tracked/2 other keys)."""
        resident = set(self._index)
        keep_n = self.max_tracked // 2
        hottest = sorted(self._counts.items(), key=lambda kv: -kv[1])[:keep_n]
        kept = {k: c for k, c in hottest}
        for k in resident:
            if k in self._counts:
                kept[k] = self._counts[k]
        self._counts = kept
        self._pending &= set(kept)

    # ----------------------------------------------------------- admission
    def _promotion_candidates(self) -> List[Tuple[float, int]]:
        """Uncached keys whose count crossed the threshold, hottest first
        — drawn from the `_pending` set, not a full counter scan.
        Returned counts are TRUE (de-inflated) units; pending keys whose
        count aged back under the threshold are lazily demoted here."""
        self._pending -= set(self._index)
        if self.decay is not None and self._pending:
            pthr = self.promote_threshold * self._scale
            self._pending = {k for k in self._pending
                             if self._counts.get(k, 0.0) >= pthr}
        inv = 1.0 / self._scale
        cands = [(self._counts.get(k, 0) * inv, k) for k in self._pending]
        cands.sort(reverse=True)
        return cands

    def pending_candidates(self) -> List[Tuple[float, int]]:
        """The (count, key) promotion candidates, hottest first — the
        `plan_admissions` input exposed for callers that own slot
        assignment themselves (the vocab manager binds keys through the
        erasable IntegerLookup rather than this tracker's slot table).
        Does not mutate pending; pair with `drop_pending` once bound."""
        return self._promotion_candidates()

    def drop_pending(self, keys) -> None:
        """Remove keys from the pending set (caller admitted or rejected
        them through its own binding structure)."""
        self._pending -= {int(k) for k in np.asarray(keys).reshape(-1)}

    def counts_for(self, keys) -> np.ndarray:
        """Tracked (possibly decayed) counts for `keys` ([n] float64,
        0 for untracked, TRUE units) — the eviction policy's coldness
        ranking."""
        flat = np.asarray(keys, np.int64).reshape(-1)
        inv = 1.0 / self._scale
        return np.asarray([self._counts.get(int(k), 0.0) * inv
                           for k in flat], np.float64)

    def plan_admissions(self) -> List[Tuple[int, int]]:
        """Run the admission policy against the current counters.

        Returns the (slot, key) assignment plan, hottest first. Free slots
        fill first; when full, a candidate evicts the coldest resident row
        only if the candidate's count is strictly higher. The plan updates
        `slot_keys` (and pops evicted keys from the index, counting
        `evictions`) immediately so a second plan in the same round sees
        the new occupancy; callers copy the planned rows, then call
        `commit_admissions(plan)` to make them resident.
        """
        cands = self._promotion_candidates()
        if not cands:
            return []
        free = np.flatnonzero(self.slot_keys < 0).tolist()
        plan: List[Tuple[int, int]] = []
        heap = None
        for count, key in cands:
            if free:
                slot = free.pop()
            else:
                # full: evict the coldest resident only for a strictly
                # hotter row. Slots planned earlier this round already
                # carry their NEW key, so they rank by the newcomer's
                # count, never as empty. The JAX tracker scans every slot
                # for each candidate (the first slot of the least count);
                # a heap of (count, slot), built once a round, picks the
                # same slot without the scan
                if heap is None:
                    heap = [(self._counts.get(k, 0), s) for s, k in
                            enumerate(self.slot_keys.tolist())]
                    heapq.heapify(heap)
                cold_count, coldest = heap[0]
                # candidate counts are true units, stored are inflated
                if count <= cold_count / self._scale:
                    break                          # sorted: nothing hotter left
                heapq.heapreplace(heap, (self._counts.get(key, 0), coldest))
                self._index.pop(int(self.slot_keys[coldest]), None)
                self.evictions += 1
                slot = coldest
            self.slot_keys[slot] = key
            plan.append((slot, key))
        return plan

    def commit_admissions(self, plan: List[Tuple[int, int]]) -> int:
        """Make a `plan_admissions` plan resident (caller copied the rows).
        Returns rows promoted."""
        for slot, key in plan:
            self._index[key] = slot
            self._pending.discard(key)
        self.promotions += len(plan)
        return len(plan)

    def set_resident(self, keys: np.ndarray) -> None:
        """Replace the resident set wholesale (planner-driven admission,
        e.g. top-H from IntegerLookup counts): key i occupies slot i.
        Evicted keys are not counted as evictions — this is a reset, not
        the online policy."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        if len(keys) > self.capacity:
            raise ValueError(
                f"{len(keys)} keys exceed capacity {self.capacity}")
        if len(np.unique(keys)) != len(keys):
            raise ValueError("resident keys must be unique")
        self._index = {int(k): i for i, k in enumerate(keys.tolist())}
        self.slot_keys.fill(-1)
        self.slot_keys[:len(keys)] = keys
        self._pending -= set(self._index)

    def invalidate(self) -> None:
        """Drop every resident row (hits resume only after re-admission)."""
        pthr = self.promote_threshold * self._scale
        for k in self._index:
            if self._counts.get(k, 0) >= pthr:
                self._pending.add(k)       # still hot: re-promotable
        self._index.clear()
        self.slot_keys.fill(-1)

    def resident_keys(self) -> np.ndarray:
        """Current resident keys ([R] int64, slot order, R <= capacity)."""
        return self.slot_keys[self.slot_keys >= 0].copy()

    def top_keys(self, n: Optional[int] = None) -> np.ndarray:
        """The hottest n tracked keys by count (default: capacity) —
        the 'warmup scan' admission input: observe batches, then
        ``set_resident(top_keys())``."""
        n = self.capacity if n is None else int(n)
        items = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return np.asarray([k for k, _ in items[:n]], np.int64)

    # ---------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        """Zero the hit/miss counters (NOT the frequency counters or the
        resident set) — callers window measured hit rates to a residency
        epoch, e.g. the training hot shard resets at each re-admission so
        reported rates describe the CURRENT hot set, not the all-miss
        warmup stream."""
        self.hits = 0
        self.misses = 0

    @property
    def resident(self) -> int:
        return int((self.slot_keys >= 0).sum())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"capacity": self.capacity, "resident": self.resident,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hit_rate, 4),
                "promotions": self.promotions, "evictions": self.evictions,
                "tracked": len(self._counts), "pending": len(self._pending)}
