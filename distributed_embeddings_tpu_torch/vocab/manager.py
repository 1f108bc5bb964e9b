"""Dynamic vocabulary: streaming admission of raw keys, cold-row eviction
and growth inside pre-reserved rows.

Counterpart of ``distributed_embeddings_tpu/vocab/manager.py``. A managed
table's raw (arbitrary int64) keys go through its `ManagedVocab`:

  * **Admission by frequency.** An unknown key translates to the table's
    fallback row 0 (the shared OOV row, `IntegerLookup`'s index 0) or,
    with ``on_miss="drop"``, to a zero-weight lane. A decayed
    `utils.hotness.HotnessTracker` counts the raw stream; a key whose
    recent count crosses ``admit_threshold`` is bound to a free row at the
    next `VocabManager.maintain`.
  * **Eviction.** When admission demand does not fit under
    ``high_watermark``, the coldest bound keys (by the same counters) are
    demoted to the fallback: their rows are stashed on the host and their
    bindings erased (`IntegerLookup.erase`, the slot returns to the free
    list). A re-admitted key gets its stashed row back.
  * **Growth without reallocation.** The planner reserves
    ``vocab_slack`` rows per table (`DistributedEmbedding(vocab_slack=)`),
    so every admission fills rows that exist: no tensor changes shape or
    moves (its ``data_ptr`` stays). At ``replan_watermark`` the manager
    logs a re-plan recommendation.

One owner per piece of state: the binding and its free list are the
erasable `IntegerLookup` (the C++ map by default, its numpy twin with
``use_native=False``); the counters are the tracker's; the rows are the
layer's, read and written only by `maintain`, through the table store's
row helpers. Translation is host numpy on the raw stream.

The port reads no environment: `default_admit_threshold` is 2 and the
stash is float32 unless ``stash_dtype`` says otherwise. The manager is
single-process: at world size > 1 it raises. State and sidecar files are
the JAX package's format, so each package loads the other's.
"""

import os
import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    sorted_unique)
from distributed_embeddings_tpu_torch.layers.embedding import IntegerLookup
from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
from distributed_embeddings_tpu_torch.ops import wire
from distributed_embeddings_tpu_torch.ops.embedding_ops import (RaggedIds,
                                                                SparseIds)
from distributed_embeddings_tpu_torch.store.table_store import (
    _bucket_rows, _set_bucket_rows, padded_scatter_rows)
from distributed_embeddings_tpu_torch.utils.checkpoint import (
    load_row_delta, publish_atomic, save_row_delta)
from distributed_embeddings_tpu_torch.utils.hotness import HotnessTracker

__all__ = ["ManagedVocab", "VocabManager", "default_admit_threshold",
           "latest_vocab_state", "vocab_state_path"]

_HOLE = np.iinfo(np.int64).min
# placeholder keys of a state replay (load_state): far outside any raw key
# space, erased right after the replay
_DUMMY_BASE = -(2 ** 62)

_VOCAB_FILE_RE = re.compile(r"^vocab_v(\d{8})\.npz$")


def default_admit_threshold() -> int:
    """The admission threshold's default, 2: one sighting is noise, a
    repeat is a signal (the JAX package reads ``DET_VOCAB_ADMIT``; the
    port reads no environment)."""
    return 2


def vocab_state_path(directory: str, version: int) -> str:
    """The binding sidecar's path for one published store version."""
    return os.path.join(directory, f"vocab_v{version:08d}.npz")


def latest_vocab_state(directory: str,
                       upto: Optional[int] = None) -> Optional[str]:
    """The newest ``vocab_v{V}.npz`` sidecar in a publish directory with V
    at most `upto` (None: any), or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = _VOCAB_FILE_RE.match(name)
        if not m:
            continue
        v = int(m.group(1))
        if upto is not None and v > upto:
            continue
        if best is None or v > best[0]:
            best = (v, os.path.join(directory, name))
    return best[1] if best else None


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class ManagedVocab:
    """Binding and admission state of one managed table.

    ``capacity`` physical rows (the table's ``input_dim``, which the
    planner inflated by ``vocab_slack``). Row 0 is the fallback row and is
    never bound; rows 1 .. capacity - 1 are the pool. The binding is an
    erasable `IntegerLookup` whose index space is the row space.
    """

    def __init__(self, table_id: int, capacity: int, base_rows: int,
                 slack: int, admit_threshold: int, decay: float,
                 use_native: Optional[bool] = None,
                 stash_max: Optional[int] = None,
                 stash_dtype: Optional[str] = None,
                 stash_max_bytes: Optional[int] = None):
        if capacity < 2:
            raise ValueError(
                f"managed table {table_id}: capacity {capacity} leaves no "
                "bindable row beyond the fallback")
        self.table_id = int(table_id)
        self.capacity = int(capacity)
        self.base_rows = int(base_rows)
        self.slack = int(slack)
        self.binding = IntegerLookup(max_tokens=capacity - 1,
                                     use_native=use_native)
        self.tracker = HotnessTracker(
            capacity=capacity - 1, promote_threshold=admit_threshold,
            decay=decay)
        # evicted keys' rows, restored on re-admission; bounded (oldest
        # demotion dropped first) by `stash_max` rows (default: one
        # table's worth) and the optional `stash_max_bytes`; parked at
        # `stash_dtype` (an int8 / fp8 entry is (payload, scale))
        self.stash: Dict[int, object] = {}
        self.stash_max = (capacity - 1 if stash_max is None
                          else max(0, int(stash_max)))
        self.stash_dtype = wire.resolve_store_dtype(stash_dtype)
        self.stash_max_bytes = (None if stash_max_bytes is None
                                else max(0, int(stash_max_bytes)))
        self._stash_bytes = 0
        self.admissions = 0
        self.evictions = 0
        self.fallback_hits = 0
        self.translated = 0

    # ------------------------------------------------------------ queries
    @property
    def bound(self) -> int:
        """Live bound keys (the fallback row excluded)."""
        return self.binding.size - 1

    @property
    def occupancy(self) -> float:
        """bound / bindable: the watermark the eviction policy runs on."""
        return self.bound / max(self.capacity - 1, 1)

    def resident_keys(self) -> np.ndarray:
        """Bound raw keys ([n] int64, in binding-index order)."""
        vocab = self.binding.get_vocabulary()[1:]
        return np.asarray([k for k in vocab if k is not None], np.int64)

    # ---------------------------------------------------------- translate
    def translate(self, keys: np.ndarray) -> np.ndarray:
        """Raw keys -> physical rows; an unbound key -> 0 (the fallback).
        Query-only: never binds, never counts."""
        rows = self.binding.lookup(keys)
        self.translated += int(np.asarray(keys).size)
        self.fallback_hits += int((np.asarray(rows) == 0).sum())
        return rows

    def observe(self, keys: np.ndarray,
                valid: Optional[np.ndarray] = None) -> None:
        """Feed the admission tracker (decayed recent counts)."""
        self.tracker.observe(keys, valid=valid)

    # ---------------------------------------------------- admission policy
    def pending_fresh(self) -> np.ndarray:
        """Unbound keys whose recent count crossed the threshold, hottest
        first ([n] int64): the admission demand. Pending keys bound since
        they crossed are dropped."""
        cands = self.tracker.pending_candidates()
        if not cands:
            return np.empty((0,), np.int64)
        keys = np.asarray([k for _, k in cands], np.int64)
        bound_rows = np.asarray(self.binding.lookup(keys))
        self.tracker.drop_pending(keys[bound_rows != 0])
        return keys[bound_rows == 0]

    def bind(self, keys: Sequence[int]) -> np.ndarray:
        """Bind keys to rows (freed rows first). Returns the rows."""
        if not len(keys):
            return np.empty((0,), np.int64)
        arr = np.asarray(keys, np.int64)
        rows = np.asarray(self.binding(arr))
        ok = rows != 0
        self.tracker.drop_pending(arr[ok])
        self.admissions += int(ok.sum())
        return rows

    def plan_evictions(self, low_watermark: float) -> np.ndarray:
        """The coldest bound keys to demote so occupancy lands at
        `low_watermark` ([n] int64; empty when nothing is to be done)."""
        n_evict = self.bound - int(low_watermark * (self.capacity - 1))
        if n_evict <= 0:
            return np.empty((0,), np.int64)
        keys = self.resident_keys()
        order = np.argsort(self.tracker.counts_for(keys), kind="stable")
        return keys[order[:n_evict]]

    # --------------------------------------------------- stash internals
    @staticmethod
    def _entry_bytes(entry) -> int:
        """Resident bytes of one stash entry: the 8-byte key, the payload
        and, for a quantized entry, its 4-byte scale."""
        if isinstance(entry, tuple):
            return 8 + entry[0].nbytes + 4
        return 8 + entry.nbytes

    def _stash_put(self, key: int, row_f32: np.ndarray) -> None:
        """Park one demoted float32 row at `stash_dtype` and keep both
        bounds, oldest demotion first."""
        old = self.stash.pop(key, None)        # a re-stash refreshes its age
        if old is not None:
            self._stash_bytes -= self._entry_bytes(old)
        if self.stash_dtype == "f32":
            entry = np.asarray(row_f32, np.float32)
        else:
            p, s = wire.encode_rows_np(
                np.asarray(row_f32, np.float32)[None], self.stash_dtype)
            entry = (p[0], np.float32(s[0, 0]))
        self.stash[key] = entry
        self._stash_bytes += self._entry_bytes(entry)
        while self.stash and (
                len(self.stash) > self.stash_max
                or (self.stash_max_bytes is not None
                    and self._stash_bytes > self.stash_max_bytes)):
            dropped = self.stash.pop(next(iter(self.stash)))
            self._stash_bytes -= self._entry_bytes(dropped)

    def stash_take(self, key: int) -> Optional[np.ndarray]:
        """Pop and decode one stashed row (float32), or None."""
        entry = self.stash.pop(int(key), None)
        if entry is None:
            return None
        self._stash_bytes -= self._entry_bytes(entry)
        if isinstance(entry, tuple):
            return wire.decode_rows_np(entry[0], np.asarray(
                entry[1]).reshape(1), self.stash_dtype)
        return entry

    def stash_bytes(self) -> int:
        """Resident stash bytes (keys, payloads, scales)."""
        return self._stash_bytes

    def unbind(self, keys: np.ndarray,
               rows_payload: Optional[np.ndarray] = None) -> np.ndarray:
        """Erase bindings (eviction); `rows_payload` ([n, width], the keys'
        current rows) is stashed for re-admission. Returns the freed
        rows."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        if rows_payload is not None:
            for i, k in enumerate(keys.tolist()):
                self._stash_put(k, rows_payload[i])
        freed = self.binding.erase(keys)
        self.evictions += int((np.asarray(freed) != 0).sum())
        return freed

    # -------------------------------------------------------------- state
    def state_dict(self, full: bool = True) -> Dict[str, np.ndarray]:
        """The binding (key table in index order, holes as INT64_MIN, and
        the free list); with `full`, also the tracker's counters and the
        stash (the trainer's resume state, which a translating consumer
        does not need)."""
        vocab = self.binding.get_vocabulary()[1:]
        keys = np.asarray([_HOLE if k is None else k for k in vocab],
                          np.int64)
        out = {"keys": keys,
               "free": np.asarray(self.binding.free_slots(), np.int64)}
        if full:
            ck, cv = self._tracker_items()
            stash_keys = np.asarray(sorted(self.stash), np.int64)
            out.update({"count_keys": ck, "count_vals": cv,
                        "stash_keys": stash_keys})
            entries = [self.stash[int(k)] for k in stash_keys]
            if self.stash_dtype == "f32":
                out["stash_rows"] = (np.stack(entries) if entries
                                     else np.zeros((0, 0), np.float32))
            else:
                out["stash_rows"] = (np.stack([e[0] for e in entries])
                                     if entries
                                     else np.zeros((0, 0), np.int8))
                out["stash_scale"] = np.asarray([e[1] for e in entries],
                                                np.float32)
        return out

    def _tracker_items(self) -> Tuple[np.ndarray, np.ndarray]:
        # counts are stored inflated by the tracker's lazy decay: persist
        # true units, so a restore (a fresh tracker, scale 1) is exact
        inv = 1.0 / self.tracker._scale
        items = sorted(self.tracker._counts.items())
        ck = np.asarray([k for k, _ in items], np.int64)
        cv = np.asarray([float(v) * inv for _, v in items], np.float64)
        return ck, cv

    def load_state(self, state: Dict[str, np.ndarray],
                   stash_dtype: str = "f32") -> None:
        """Rebuild binding, free list, counters and stash from a
        `state_dict`. The key table is replayed in index order with
        placeholders in the holes; erasing the placeholders in the saved
        free-list order rebuilds the holes and the LIFO reuse order
        exactly. `stash_dtype` is the saved stash's."""
        keys = np.asarray(state["keys"], np.int64)
        free = np.asarray(state["free"], np.int64)
        fresh = IntegerLookup(max_tokens=self.capacity - 1,
                              use_native=self.binding.native)
        replay = keys.copy()
        holes = replay == _HOLE
        if holes.any():
            replay[holes] = _DUMMY_BASE - np.arange(len(replay))[holes]
        if len(replay):
            got = np.asarray(fresh(replay))
            if not np.array_equal(got, np.arange(1, len(replay) + 1)):
                raise ValueError(
                    "vocab state replay produced non-sequential indices "
                    "(a corrupt state file, or raw keys in the reserved "
                    "placeholder range)")
        if len(free):
            # each erase appends its index to the free list
            fresh.erase(_DUMMY_BASE - (free - 1))
            if not np.array_equal(np.asarray(fresh.free_slots()), free):
                raise ValueError("vocab free-list replay mismatch")
        self.binding = fresh
        self.tracker = HotnessTracker(
            capacity=self.capacity - 1,
            promote_threshold=self.tracker.promote_threshold,
            decay=self.tracker.decay)
        ck = np.asarray(state.get("count_keys", []), np.int64)
        cv = np.asarray(state.get("count_vals", []), np.float64)
        self.tracker._counts = {int(k): float(v) for k, v in zip(ck, cv)}
        if len(ck):
            unbound = np.asarray(fresh.lookup(ck)) == 0
            hot = cv >= self.tracker.promote_threshold
            self.tracker._pending = {int(k) for k in ck[unbound & hot]}
        self.stash = {}
        self._stash_bytes = 0
        sk = np.asarray(state.get("stash_keys", []), np.int64)
        sr = np.asarray(state.get("stash_rows", np.zeros((0, 0))))
        # saved entries decode at the saved dtype, then re-park at this
        # vocabulary's own
        if wire.resolve_store_dtype(stash_dtype) != "f32":
            sr = wire.decode_rows_np(sr, np.asarray(
                state["stash_scale"], np.float32)[:, None], stash_dtype)
        sr = np.asarray(sr, np.float32)
        for i, k in enumerate(sk.tolist()):
            self._stash_put(k, sr[i])

    def stats(self) -> dict:
        return {"capacity": self.capacity, "base_rows": self.base_rows,
                "slack_rows": self.slack, "bound": self.bound,
                "occupancy": round(self.occupancy, 4),
                "admissions": self.admissions, "evictions": self.evictions,
                "fallback_hits": self.fallback_hits,
                "translated": self.translated,
                "fallback_hit_rate": round(
                    self.fallback_hits / self.translated, 4)
                if self.translated else 0.0,
                "stashed": len(self.stash),
                "stash_bytes": self.stash_bytes(),
                "stash_dtype": self.stash_dtype}


class VocabManager:
    """Run-time vocabulary control for a `DistributedEmbedding`.

    Args:
      emb: the layer (data-parallel input). Managed tables are its
        table-parallel tables whose buckets are on the device and hold no
        hot rows (a hot shard's write-back and a rebind would fight over
        rows); the other tables pass through untranslated.
      tables: optional subset of global table ids to manage. Unlike the
        JAX package's manager, an explicit subset may name tables of a
        host-offloaded bucket, for the query-only role of a serving
        replica (`translate`, `load_state`, `stats`; `serving.
        InferenceEngine(vocab_manager=)`): `maintain`, which rewrites
        rows, refuses them.
      admit_threshold: the recent decayed count at which an unknown key is
        bound (None: `default_admit_threshold`, 2).
      decay: the tracker's aging factor per observed batch (1.0: all-time
        counts).
      high_watermark / low_watermark: the occupancy admissions stop at /
        eviction drains down to.
      replan_watermark: the occupancy at which `maintain` logs the re-plan
        recommendation.
      on_miss: "fallback" (unknown keys -> row 0) or "drop" (their lanes
        zero-weighted: translated dense inputs become (ids, weights)
        tuples; reducing combiners only).
      max_admit_per_cycle: bound on bindings a `maintain` (None: every
        free row).
      use_native: the binding's backend (None / True: the C++ map; False:
        its numpy twin).
      stash_max / stash_dtype / stash_max_bytes: the demotion stash's row
        bound (None: one table's worth), its at-rest dtype ("f32", default,
        "int8" or "fp8") and an optional byte bound.
      log_fn: where the re-plan recommendation is logged.
      registry: optional `obs.registry.MetricRegistry` for
        ``vocab/admissions`` and ``vocab/evictions`` (counters) and the
        ``vocab/occupancy``, ``vocab/bound_rows``,
        ``vocab/high_watermark``, ``vocab/low_watermark``,
        ``vocab/fallback_hit_rate``, ``vocab/maintain_cycles`` and
        ``vocab/stash_bytes`` gauges. Default: a private registry.

    Workflow::

        mgr = VocabManager(emb)
        cats = mgr.translate(raw_cats, observe=True)    # every step
        opt_state["emb"] = mgr.maintain(None, opt_state["emb"])  # every N

    or ``training.fit(vocab=mgr, vocab_every=N)``.
    """

    def __init__(self, emb, tables: Optional[Sequence[int]] = None,
                 admit_threshold: Optional[int] = None, decay: float = 0.99,
                 high_watermark: float = 0.9, low_watermark: float = 0.75,
                 replan_watermark: float = 0.98, on_miss: str = "fallback",
                 max_admit_per_cycle: Optional[int] = None,
                 use_native: Optional[bool] = None,
                 stash_max: Optional[int] = None,
                 stash_dtype: Optional[str] = None,
                 stash_max_bytes: Optional[int] = None, log_fn=None,
                 registry=None):
        if not emb.dp_input:
            raise ValueError(
                "VocabManager translates data-parallel input batches; this "
                "layer was built with dp_input=False")
        if emb.world_size > 1:
            # per-rank bindings would send different rows to each rank
            raise NotImplementedError(
                "VocabManager is single-process: per-rank bindings would "
                "diverge the ranks' id streams; run admission on one "
                "process and distribute the translated rows or the saved "
                "binding state")
        if on_miss not in ("fallback", "drop"):
            raise ValueError(f"on_miss must be 'fallback'|'drop', "
                             f"got {on_miss!r}")
        if not 0.0 < low_watermark <= high_watermark <= 1.0:
            raise ValueError(
                f"need 0 < low_watermark <= high_watermark <= 1, got "
                f"{low_watermark}/{high_watermark}")
        self.emb = emb
        self._query_only: List[int] = []
        self.on_miss = on_miss
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.replan_watermark = float(replan_watermark)
        self.max_admit_per_cycle = max_admit_per_cycle
        self.admit_threshold = (default_admit_threshold()
                                if admit_threshold is None
                                else max(1, int(admit_threshold)))
        self._log = log_fn or (lambda msg: None)
        strat = emb.strategy
        eligible = self._eligible_tables()
        if tables is None:
            managed = eligible
        else:
            managed = [int(t) for t in tables]
            # an offloaded table is translated (query-only), never rebound
            with_offloaded = self._eligible_tables(offloaded=True)
            self._query_only = [t for t in managed if t in with_offloaded
                                and t not in eligible]
            bad = [t for t in managed if t not in eligible
                   and t not in self._query_only]
            if bad:
                raise ValueError(
                    f"tables {bad} are not manageable (must be "
                    "table-parallel, non-offloaded, and not in a "
                    "hot-row-replicated bucket: hot write-back and vocab "
                    "rebind would fight over physical rows)")
        if not managed:
            raise ValueError(
                "no manageable tables in this plan (table-parallel, "
                "non-offloaded, hot-rows-free): a VocabManager here would "
                "pass every input through untranslated")
        self.vocabs: Dict[int, ManagedVocab] = {}
        for gtid in managed:
            cfg = strat.global_configs[gtid]
            cap = int(cfg["input_dim"])
            self.vocabs[gtid] = ManagedVocab(
                gtid, capacity=cap,
                base_rows=int(cfg.get("vocab_base_rows", cap)),
                slack=int(cfg.get("vocab_slack", 0)),
                admit_threshold=self.admit_threshold, decay=decay,
                use_native=use_native, stash_max=stash_max,
                stash_dtype=stash_dtype, stash_max_bytes=stash_max_bytes)
        if on_miss == "drop":
            for gtid in self.vocabs:
                if strat.global_configs[gtid].get("combiner") is None:
                    raise ValueError(
                        f"on_miss='drop' zero-weights missed lanes, which "
                        f"needs a reducing combiner; managed table {gtid} "
                        "has combiner=None")
        self._placements = {gtid: self._table_placements(gtid)
                            for gtid in self.vocabs}
        # flat keys per bucket that maintain() rewrote since the last
        # drain: what the next published delta must carry (sorted, merged
        # at write time, so bounded by the bucket, not the run)
        self._touched: Dict[Tuple[str, int], np.ndarray] = {}
        self.maintain_cycles = 0
        # observing translations, one a training step in `fit`: the "per
        # step" denominator of `exchange_padding_report`'s eviction rate
        self.observe_steps = 0
        self._replan_warned: set = set()
        self._metrics = registry if registry is not None \
            else MetricRegistry()
        self._exported = {"admissions": 0, "evictions": 0}

    def use_registry(self, registry) -> None:
        """Rebind the metrics onto `registry` (`training.fit` unifies a
        run's namespace through it). The counter baselines carry over, so
        only the admissions and evictions after the rebind land in the
        new registry."""
        self._metrics = registry

    def _export_metrics(self) -> None:
        adm = sum(mv.admissions for mv in self.vocabs.values())
        ev = sum(mv.evictions for mv in self.vocabs.values())
        m = self._metrics
        m.counter("vocab/admissions").inc(adm - self._exported["admissions"])
        m.counter("vocab/evictions").inc(ev - self._exported["evictions"])
        self._exported = {"admissions": adm, "evictions": ev}
        cap = sum(mv.capacity - 1 for mv in self.vocabs.values())
        bound = sum(mv.bound for mv in self.vocabs.values())
        tr = sum(mv.translated for mv in self.vocabs.values())
        fb = sum(mv.fallback_hits for mv in self.vocabs.values())
        m.gauge("vocab/occupancy").set(bound / cap if cap else 0.0)
        m.gauge("vocab/bound_rows").set(bound)
        m.gauge("vocab/high_watermark").set(self.high_watermark)
        m.gauge("vocab/low_watermark").set(self.low_watermark)
        m.gauge("vocab/fallback_hit_rate").set(fb / tr if tr else 0.0)
        m.gauge("vocab/maintain_cycles").set(self.maintain_cycles)
        m.gauge("vocab/stash_bytes").set(
            sum(mv.stash_bytes() for mv in self.vocabs.values()))
        for gtid, mv in self.vocabs.items():
            m.gauge("vocab/occupancy", table=gtid).set(mv.occupancy)

    # ---------------------------------------------------------- geometry
    def _eligible_tables(self, offloaded: bool = False) -> List[int]:
        """Manageable: table-parallel, not offloaded (unless `offloaded`:
        the query-only role), and not in a hot bucket. While a row is
        hot-resident the hot shard is authoritative and the canonical row
        stale: eviction would stash the stale copy, and the old tenant's
        hot row would overwrite a rebound row at the next write-back. A
        table is managed by at most one of the two."""
        out = []
        for t_local, gtid in enumerate(self.emb.strategy.table_groups[1]):
            pls = [pl for pl in self.emb.plan.tp_placements
                   if pl.table_id == t_local]
            if pls and not any(
                    (self.emb.plan.tp_buckets[pl.bucket].offload
                     and not offloaded)
                    or self.emb.plan.tp_buckets[pl.bucket].hot_rows > 0
                    for pl in pls):
                out.append(gtid)
        return out

    def _table_placements(self, gtid: int):
        t_local = self.emb.strategy.table_groups[1].index(gtid)
        return sorted((pl for pl in self.emb.plan.tp_placements
                       if pl.table_id == t_local),
                      key=lambda pl: pl.col_start)

    # --------------------------------------------------------- translate
    def _managed_for_input(self, i: int) -> Optional[ManagedVocab]:
        return self.vocabs.get(self.emb.strategy.input_table_map[i])

    def _translate_one(self, mv: ManagedVocab, x, raws_out=None):
        """One input through its table's binding, in its form (dense ids,
        an (ids, weights) tuple, RaggedIds, SparseIds), as host numpy;
        the raw keys are appended to `raws_out` when given."""
        if isinstance(x, (RaggedIds, SparseIds)):
            vals = _host(x.values).astype(np.int64)
            if raws_out is not None:
                raws_out.append(vals.reshape(-1))
            if self.on_miss == "drop":
                raise ValueError(
                    f"on_miss='drop' cannot zero-weight "
                    f"{type(x).__name__} inputs; use dense [B, k] "
                    "(+weights) forms")
            rows = mv.translate(vals).astype(np.int32)
            if isinstance(x, RaggedIds):
                return RaggedIds(rows, x.row_splits)
            return SparseIds(x.indices, rows, x.dense_shape)
        weights = None
        if isinstance(x, tuple) and len(x) == 2:
            x, weights = x
        ids = _host(x)
        dtype = ids.dtype if np.issubdtype(ids.dtype, np.integer) \
            else np.int32
        ids = ids.astype(np.int64)
        if raws_out is not None:
            raws_out.append(ids.reshape(-1))
        rows = mv.translate(ids).astype(dtype)
        if self.on_miss == "drop":
            w = (np.ones(ids.shape, np.float32) if weights is None
                 else np.array(_host(weights), np.float32))
            w[rows == 0] = 0.0
            return (rows, w)
        return (rows, weights) if weights is not None else rows

    def translate(self, inputs: Sequence, observe: bool = False) -> List:
        """Translate one batch's raw keys to physical rows on the host;
        unmanaged inputs pass through untouched. `observe` also feeds the
        admission tracker (the training side's form; serving translates
        query-only), once per table and batch over the union of the
        table's inputs: a table shared by k inputs ages once a batch."""
        if len(inputs) != self.emb._n_inputs:
            raise ValueError(
                f"expected {self.emb._n_inputs} inputs, got {len(inputs)}")
        if observe:
            self.observe_steps += 1
        per_table_raws: Dict[int, List[np.ndarray]] = {}
        out = []
        for i, x in enumerate(inputs):
            mv = self._managed_for_input(i)
            if mv is None:
                out.append(x)
                continue
            raws = (per_table_raws.setdefault(mv.table_id, [])
                    if observe else None)
            out.append(self._translate_one(mv, x, raws_out=raws))
        for gtid, chunks in per_table_raws.items():
            self.vocabs[gtid].observe(np.concatenate(chunks))
        if observe:
            self._export_metrics()
        return out

    # ---------------------------------------------------------- maintain
    def _flat_keys(self, gtid: int, rows: np.ndarray):
        """Rows of table `gtid` -> per placement (bucket, flat keys, column
        range): a column-sliced table stores each row in every slice."""
        out = []
        for pl in self._placements[gtid]:
            rows_max = max(self.emb.plan.tp_buckets[pl.bucket].rows_max, 1)
            flat = pl.rank * rows_max + pl.row_offset + np.asarray(
                rows, np.int64)
            out.append((pl.bucket, flat, pl.col_start, pl.col_end))
        return out

    def _width(self, gtid: int) -> int:
        return sum(pl.col_end - pl.col_start
                   for pl in self._placements[gtid])

    def _gather_table_rows(self, gtid: int, rows: np.ndarray) -> np.ndarray:
        """The current [n, width] float32 rows, across placements."""
        out = np.zeros((len(rows), self._width(gtid)), np.float32)
        for bucket, flat, c0, c1 in self._flat_keys(gtid, rows):
            out[:, c0:c1] = _bucket_rows(self.emb, bucket, flat)
        return out

    @torch.no_grad()
    def _write_admitted(self, opt_states: Optional[dict], gtid: int,
                        keys: np.ndarray, rows: np.ndarray) -> None:
        """Write admitted keys' rows, their stashed row (a re-admission)
        or zeros (a fresh key), and zero the rows of the bucket's
        table-shaped optimizer state (adagrad's accumulator, adam's
        moments), in place: a reused row must not inherit its previous
        tenant's state."""
        mv = self.vocabs[gtid]
        payload = np.zeros((len(keys), self._width(gtid)), np.float32)
        for i, k in enumerate(keys.tolist()):
            stashed = mv.stash_take(k)
            if stashed is not None:
                payload[i] = stashed
        for bucket, flat, c0, c1 in self._flat_keys(gtid, rows):
            _set_bucket_rows(self.emb, bucket, flat, payload[:, c0:c1])
            cur = self._touched.get(("tp", bucket))
            self._touched[("tp", bucket)] = sorted_unique(
                flat if cur is None else np.concatenate([cur, flat]))
            if opt_states is None:
                continue
            rows_max = max(self.emb.plan.tp_buckets[bucket].rows_max, 1)
            for leaf in opt_states["tp"][bucket]:
                if torch.is_tensor(leaf) and leaf.dim() == 2 \
                        and leaf.shape[0] == self.emb.tp[bucket].shape[0]:
                    padded_scatter_rows(
                        leaf, flat // rows_max, flat % rows_max,
                        torch.zeros((len(flat), leaf.shape[1]),
                                    dtype=leaf.dtype))

    def maintain(self, params=None, opt_states: Optional[dict] = None):
        """Run one admission / eviction cycle on the layer's tables, in
        place.

        Per table: admissions stop at the high watermark; when the demand
        (pending threshold-crossers) does not fit under it, the coldest
        bound keys drain to the low watermark first, so a stable key
        universe never churns and a drifting one turns over its cold
        tail. When even that cannot absorb the demand, the re-plan
        recommendation is logged (more ``vocab_slack``). Evicted rows are
        stashed before new keys bind: a freed row may be rebound in the
        same cycle.

        `params` is None (the layer holds its tables); `opt_states` the
        train step's ``opt_state["emb"]``, whose rows of admitted slots are
        zeroed in place. Returns `opt_states`."""
        if params is not None:
            raise ValueError("maintain(params=...): the port's layer holds "
                             "its own tables; pass None")
        if self._query_only:
            raise ValueError(
                f"tables {self._query_only} live in host-offloaded buckets: "
                "this manager translates them for serving (query-only) but "
                "does not rebind their rows; maintain the vocabulary on a "
                "layer that keeps them on the device")
        self.maintain_cycles += 1
        for gtid, mv in self.vocabs.items():
            cap_rows = int(self.high_watermark * (mv.capacity - 1))
            fresh = mv.pending_fresh()
            if len(fresh) > cap_rows - mv.bound:
                evict_keys = mv.plan_evictions(self.low_watermark)
                if len(evict_keys):
                    rows = np.asarray(mv.binding.lookup(evict_keys))
                    mv.unbind(evict_keys,
                              self._gather_table_rows(gtid, rows))
            free = cap_rows - mv.bound
            if len(fresh) > max(free, 0) and gtid not in \
                    self._replan_warned:
                self._replan_warned.add(gtid)
                msg = (f"vocab: table {gtid} admission demand "
                       f"({len(fresh)} keys) exceeds post-eviction capacity "
                       f"({max(free, 0)} free rows under the "
                       f"{self.high_watermark} watermark): re-plan with a "
                       "larger vocab_slack at the next restart")
                self._log(msg)
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
            if self.max_admit_per_cycle is not None:
                free = min(free, self.max_admit_per_cycle)
            if free <= 0 or not len(fresh):
                continue
            keys = fresh[:free]
            rows = mv.bind(keys)
            ok = rows != 0
            if ok.any():
                self._write_admitted(opt_states, gtid, keys[ok], rows[ok])
        self._export_metrics()
        return opt_states

    @property
    def pending_publication(self) -> bool:
        """True when maintain() rewrote rows no publication carried yet
        (`training.fit` then publishes once more at the end)."""
        return any(len(v) for v in self._touched.values())

    def drain_touched(self) -> Dict[Tuple[str, int], np.ndarray]:
        """Flat keys maintain() rewrote since the last drain, per bucket,
        for `TableStore.commit(touched=...)`."""
        out = {k: v for k, v in self._touched.items() if len(v)}
        self._touched = {}
        return out

    # -------------------------------------------------------------- state
    def state_dict(self, full: bool = True
                   ) -> Tuple[dict, Dict[str, np.ndarray]]:
        first = self.vocabs[min(self.vocabs)]
        meta = {"kind": "vocab_state",
                "tables": sorted(self.vocabs),
                "admit_threshold": self.admit_threshold,
                "decay": first.tracker.decay,
                "stash_dtype": first.stash_dtype,
                "capacity": {str(t): mv.capacity
                             for t, mv in self.vocabs.items()}}
        arrays = {}
        for gtid, mv in self.vocabs.items():
            for name, arr in mv.state_dict(full=full).items():
                arrays[f"t{gtid}_{name}"] = arr
        return meta, arrays

    def save_state(self, path: str, full: bool = True) -> str:
        """Write the binding state as one stream container (``.npz``).
        `full` (the checkpoint form) adds the counters and the stash;
        ``full=False`` (the publish sidecar `fit` writes) carries only what
        a translating consumer needs: key tables, free lists and the
        policy header. Written under a tmp name and renamed into place
        (`utils.checkpoint.publish_atomic`). Returns the path."""
        meta, arrays = self.state_dict(full=full)
        final = path if path.endswith(".npz") else path + ".npz"
        return publish_atomic(save_row_delta(path + ".tmp", meta, arrays),
                              final)

    def load_state(self, path: str) -> None:
        """Restore saved state, the admission policy (threshold and decay)
        included: a restored manager resumes the saved run's behavior."""
        meta, arrays = load_row_delta(path)
        if meta.get("kind") != "vocab_state":
            raise ValueError(f"{path}: not a vocab state file")
        if "admit_threshold" in meta:
            self.admit_threshold = int(meta["admit_threshold"])
        for gtid, mv in self.vocabs.items():
            mv.tracker.promote_threshold = self.admit_threshold
            if "decay" in meta:
                mv.tracker.decay = (None if meta["decay"] is None
                                    else float(meta["decay"]))
            cap = int(meta.get("capacity", {}).get(str(gtid), mv.capacity))
            if cap != mv.capacity:
                raise ValueError(
                    f"{path}: table {gtid} capacity {cap} != plan capacity "
                    f"{mv.capacity} (different vocab_slack?)")
            prefix = f"t{gtid}_"
            state = {name[len(prefix):]: arr for name, arr in arrays.items()
                     if name.startswith(prefix)}
            if state:
                mv.load_state(state,
                              stash_dtype=meta.get("stash_dtype", "f32"))

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        vs = self.vocabs.values()
        tot_cap = sum(mv.capacity - 1 for mv in vs)
        tot_bound = sum(mv.bound for mv in vs)
        tot_tr = sum(mv.translated for mv in vs)
        tot_fb = sum(mv.fallback_hits for mv in vs)
        return {
            "tables": {t: mv.stats() for t, mv in self.vocabs.items()},
            "occupancy": round(tot_bound / tot_cap, 4) if tot_cap else 0.0,
            "bound": tot_bound,
            "admissions": sum(mv.admissions for mv in vs),
            "evictions": sum(mv.evictions for mv in vs),
            "fallback_hit_rate": round(tot_fb / tot_tr, 4) if tot_tr
            else 0.0,
            "maintain_cycles": self.maintain_cycles,
        }
