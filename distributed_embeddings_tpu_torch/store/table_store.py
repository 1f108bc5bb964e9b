"""TableStore: one versioned owner of a DistributedEmbedding's tables.

Counterpart of ``distributed_embeddings_tpu/store/table_store.py``. The
port's layer owns its tensors, so the store works on the layer's own
buckets (``TableStore(emb)``; the JAX package passes a params pytree) and
on the train step's optimizer state (``opt_states``, the
``opt_state["emb"]`` tree):

  * **One source of truth.** `read_rows` is the versioned read: the
    canonical rows (decoded from a quantized bucket) with the hot-resident
    rows written over them, through the same
    `DistributedEmbedding.hot_resident_rows` that `get_weights` overlays,
    so both agree by construction.
  * **Monotonic versions.** Every `commit` / `replace` / `sync_hot_rows`
    bumps the store version; ``table_versions`` records per original table
    the last commit that touched it.
  * **Row-delta publication.** The producer accumulates each batch's
    touched rows on the host (`observe`, through
    `DistributedEmbedding.touched_row_keys`) and `publish` writes them as
    stream files (`utils.checkpoint.save_row_delta`, the JAX package's
    container, so either package reads the other's stream): the first
    publish, every ``snapshot_every``-th after and any forced one is a
    full snapshot; the others carry the union of touched keys since the
    last publish with their merged rows, and the dp tables whole.
  * **In-place consumption.** A consumer store applies a stream file into
    its layer's tensors (a delta's bucket keys re-keyed onto its own
    placement where the header records another, `_translate_delta`: the
    port's publisher is world 1, its consumers may not be): a bucket on the card by an index write on the
    card (`padded_scatter_rows`), an offloaded bucket through
    `ops.sparse_update.host_apply_rows_inplace(kind="set")` on its host
    buffers, a quantized bucket re-encoded (round to nearest even,
    `ops.wire.encode_rows_np`), payload and scale together.
    `DeltaConsumer` polls a directory: chain order, snapshot fallback,
    quarantine of damaged files, capped retries of transient read errors
    and staleness accounting.

Delta rows are the merged view (`read_rows`), so a consumer's tables equal
the publisher's `get_weights` bit for bit at every consumed version. A
consumer with hot-resident rows of its own would shadow those writes:
applying a delta to it raises.

The producer (`observe`, `publish`, `read_rows`) is single-process: at
world size > 1 it raises (each rank holds only its own rows and batch
slice). Consuming is collective there: every rank applies the same file
(`apply_published`), each writing its own rows (a bucket's keys of its
world slice, a row-sliced table's rows in ``[row_base[r], row_base[r +
1])``, the dp tables whole, a snapshot through `set_weights`). Every rank
reads and decodes the file first; the ranks then agree on the outcome
(`parallel.mesh.gather_objects`), and only if every read succeeded does
any rank write, so a read that fails on one rank fails the apply on
every rank alike, with the same error type, and leaves them all at the
same version. `DeltaConsumer` and `restore_from_published` take the
directory listing and the stream files' headers from rank 0
(`parallel.mesh.broadcast_object`), so every rank chooses the same file.
`serving.InferenceEngine` owns a store and consumes the stream through
it at any world size. Each version's life lands on the flight recorder
(`obs.trace.default_recorder`) as one lineage track: `commit` opens it,
`publish`, a consumer's first scan that sees it and `apply` mark it, and
the engine's first predict at or above it closes it. Not ported: the
fault points of the JAX store (ROADMAP A15b); the port reads no
environment, so ``snapshot_every`` defaults to 0 and
``delta_dtype`` to "f32". Eager PyTorch has nothing to retrace, so the row
helpers pad nothing.
"""

import os
import re
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
    sorted_unique)
from distributed_embeddings_tpu_torch.obs.registry import MetricRegistry
from distributed_embeddings_tpu_torch.obs.trace import default_recorder
from distributed_embeddings_tpu_torch.ops import wire
from distributed_embeddings_tpu_torch.ops.sparse_update import (
    host_apply_rows_inplace)
from distributed_embeddings_tpu_torch.parallel import mesh
from distributed_embeddings_tpu_torch.utils import checkpoint as ckpt

__all__ = ["DeltaChainError", "DeltaConsumer", "TableStore",
           "padded_gather_rows", "padded_scatter_rows",
           "restore_from_published", "scan_published"]


# Two failure classes a consumer tells apart: a transient read error
# (OSError: retried with capped backoff, then given up for this poll) and a
# corrupt file (`StreamIntegrityError`: quarantined for good, the chain
# re-anchors on the next snapshot). Anything else propagates.
def _is_transient_error(e: BaseException) -> bool:
    return isinstance(e, OSError)


def _is_corrupt_error(e: BaseException) -> bool:
    return isinstance(e, ckpt.StreamIntegrityError)


class DeltaChainError(RuntimeError):
    """A delta's base_version does not match the consumer's version: the
    consumer fell off the publish chain and must resync from a
    snapshot."""


# ------------------------------------------------------------ row helpers
def _stack(arr: torch.Tensor) -> torch.Tensor:
    """`arr` as a ``[world, rows, w]`` stack: a rank-local ``[rows, w]``
    table is the stack of one (a view, so writes land in the table)."""
    return arr if arr.dim() == 3 else arr.unsqueeze(0)


def _bytes_view(arr: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as its bytes (indexing float8 is not supported
    everywhere); any other tensor as it is."""
    if arr.dtype.is_floating_point and arr.element_size() == 1:
        return arr.view(torch.uint8)
    return arr


def padded_gather_rows(arr: torch.Tensor, w_idx: np.ndarray,
                       r_idx: np.ndarray) -> torch.Tensor:
    """Rows of a stacked ``[world, rows, w]`` tensor (or a rank-local
    ``[rows, w]`` table, the stack of one) at (`w_idx`, `r_idx`), on its
    device, in its dtype; indices are clipped into range, as the JAX
    package's gather clips them. The one row read the store and the
    vocabulary manager share."""
    stack = _stack(arr)
    w = torch.as_tensor(np.clip(np.asarray(w_idx, np.int64), 0,
                                stack.shape[0] - 1), device=stack.device)
    r = torch.as_tensor(np.clip(np.asarray(r_idx, np.int64), 0,
                                stack.shape[1] - 1), device=stack.device)
    return _bytes_view(stack)[w, r].view(stack.dtype)


def padded_scatter_rows(arr: torch.Tensor, w_idx: np.ndarray,
                        r_idx: np.ndarray, rows) -> torch.Tensor:
    """Set rows of a stacked tensor (or a rank-local table) at (`w_idx`,
    `r_idx`) in place; a lane whose world index is out of range drops (the
    JAX package's contract). `rows` (numpy or a tensor) are cast to the
    tensor's dtype; a float8 tensor also takes raw bytes (uint8, as
    `ops.wire.encode_rows_np` gives an fp8 payload). Returns `arr`."""
    stack = _stack(arr)
    w_idx = np.asarray(w_idx, np.int64)
    keep = (w_idx >= 0) & (w_idx < stack.shape[0])
    if not keep.any():
        return arr
    vals = rows if torch.is_tensor(rows) else torch.from_numpy(
        np.ascontiguousarray(rows))
    dst = stack
    if vals.dtype == torch.uint8 and stack.dtype != torch.uint8:
        dst = _bytes_view(stack)
    keep_t = torch.from_numpy(keep)
    if not keep.all():
        vals = vals[keep_t.to(vals.device)]
    w = torch.as_tensor(w_idx[keep], device=stack.device)
    r = torch.as_tensor(np.asarray(r_idx, np.int64)[keep],
                        device=stack.device)
    dst[w, r] = vals.to(device=stack.device, dtype=dst.dtype)
    return arr


def _host_set_rows(table: torch.Tensor, r_idx: np.ndarray,
                   rows: np.ndarray) -> None:
    """Set rows of a host-resident (offloaded) bucket tensor in place: a
    float32 table through `host_apply_rows_inplace` (``kind="set"``, the
    seam the offloaded update writes through), a quantized payload or
    scale by a numpy index write (the C++ loops are float32-only), so only
    the delta's rows cross a memory boundary."""
    buf = _bytes_view(table.data).numpy()
    r_idx = np.asarray(r_idx, np.int64)
    if buf.dtype == np.float32:
        host_apply_rows_inplace(
            "set", buf, (), r_idx.astype(np.int32),
            np.ascontiguousarray(rows, np.float32),
            np.ones((len(r_idx),), np.float32), 0.0)
    else:
        # an int8 payload, or an fp8 one as bytes (both sides uint8)
        buf[r_idx] = np.asarray(rows, buf.dtype)


def _bucket_rows(emb, b: int, keys: np.ndarray) -> np.ndarray:
    """Bucket `b`'s canonical rows at flat `keys` (``rank * rows_max +
    row``, this rank's) as float32 numpy, decoded from a quantized bucket;
    the read the store (`TableStore.read_rows`, which overlays the hot
    rows) and the vocabulary manager share."""
    rows_max = max(emb.plan.tp_buckets[b].rows_max, 1)
    w_idx, r_idx = keys // rows_max - emb.rank, keys % rows_max
    out = padded_gather_rows(emb.tp[b].detach(), w_idx, r_idx)
    sd = emb._bucket_store_dtype(b)
    if sd != "f32":
        out = wire.decode_rows(out, padded_gather_rows(
            emb._bucket_scale(b).detach(), w_idx, r_idx), sd)
    return out.cpu().numpy().astype(np.float32, copy=False)


@torch.no_grad()
def _set_row_rows(emb, t: int, keys: np.ndarray, rows) -> None:
    """Write float32 `rows` at global row ids `keys` of row-sliced table
    `t` (JAX `_apply_row_rows`): this rank keeps the rows in
    ``[row_base[rank], row_base[rank + 1])``, at their shard-local index;
    the others drop."""
    base = np.asarray(emb.plan.row_tables[t].row_base, np.int64)
    w_idx = np.searchsorted(base, keys, side="right") - 1
    padded_scatter_rows(emb.row[t].data, w_idx - emb.rank,
                        keys - base[w_idx], rows)


@torch.no_grad()
def _set_bucket_rows(emb, b: int, keys: np.ndarray, rows) -> None:
    """Write float32 `rows` at flat `keys` into bucket `b`, in place: on
    the card by an index write, in host memory through `_host_set_rows`;
    a quantized bucket re-encodes the rows at its storage dtype (round to
    nearest even: the write is deterministic), payload and scale
    together. Keys of other ranks' world slices drop."""
    rows_max = max(emb.plan.tp_buckets[b].rows_max, 1)
    # the rank-local table is the stack of one: this rank's slice at 0
    w_idx, r_idx = keys // rows_max - emb.rank, keys % rows_max
    sd = emb._bucket_store_dtype(b)
    targets = [(emb.tp[b].data, rows)]
    if sd != "f32":
        payload, scale = wire.encode_rows_np(rows, sd)
        targets = [(emb.tp[b].data, payload),
                   (emb._bucket_scale(b).data, scale)]
    for tensor, vals in targets:
        if emb._bucket_memory_kind(b) is not None:
            keep = w_idx == 0
            _host_set_rows(tensor, r_idx[keep], np.asarray(vals)[keep])
        else:
            padded_scatter_rows(tensor, w_idx, r_idx, vals)


_FILE_RE = re.compile(r"^stream_v(\d{8})_(delta|snapshot)\.npz$")


def _publish_path(directory: str, version: int, kind: str) -> str:
    return os.path.join(directory, f"stream_v{version:08d}_{kind}.npz")


def scan_published(directory: str) -> List[Tuple[int, str, str]]:
    """Sorted [(version, kind, path)] of the publish stream in a directory
    (the delta log a consumer polls)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _FILE_RE.match(name)
        if m:
            out.append((int(m.group(1)), m.group(2),
                        os.path.join(directory, name)))
    return sorted(out)


# the error types an outcome keeps across ranks, most specific first (a
# `StreamIntegrityError` is a ValueError, a `DeltaChainError` a
# RuntimeError); any other failure agrees as a RuntimeError
_AGREED_ERRORS = (DeltaChainError, ckpt.StreamIntegrityError, OSError,
                  ValueError, RuntimeError)


def _error_kind(e: BaseException) -> int:
    return next((i for i, cls in enumerate(_AGREED_ERRORS)
                 if isinstance(e, cls)), len(_AGREED_ERRORS) - 1)


def _raise_agreed(outcomes: list, err: Optional[BaseException]) -> None:
    """Raise the first failed rank's outcome, ``(kind, message)`` or None
    each, as the same error type on every rank (chained to this rank's
    own `err`, if it failed too)."""
    failed = [(r, o) for r, o in enumerate(outcomes) if o is not None]
    if failed:
        r, (kind, msg) = failed[0]
        raise _AGREED_ERRORS[kind](f"rank {r}: {msg}") from err


def _agreed(emb, fn):
    """``fn()`` on every rank, then the ranks agree on the outcome: its
    result where every rank succeeded, else the first failed rank's error
    type and message raised on every rank (`_raise_agreed`). At world
    size 1, ``fn()`` as it is."""
    if emb.world_size == 1:
        return fn()
    try:
        out, err = fn(), None
    except Exception as e:  # noqa: BLE001 - agreed, then raised
        out, err = None, e
    _raise_agreed(mesh.gather_objects(
        None if err is None
        else (_error_kind(err), f"{type(err).__name__}: {err}"[:300])), err)
    return out


def _from_rank0(emb, fn):
    """``fn()`` on rank 0 (a directory listing, a header read), its result
    or its error type and message the same on every rank. At world size
    1, ``fn()`` as it is."""
    if emb.world_size == 1:
        return fn()
    out = None
    if emb.rank == 0:
        try:
            out = (None, fn())
        except Exception as e:  # noqa: BLE001 - broadcast, then raised
            out = ((_error_kind(e), f"{type(e).__name__}: {e}"[:300]),
                   None)
    failed, value = mesh.broadcast_object(out)
    _raise_agreed([failed], None)
    return value


def _plan_record(emb) -> dict:
    """The layer's table-parallel placement as a delta's header records it
    (``meta["plan"]``): per placement ``[bucket, rank, row_offset, rows,
    global table id, col_start, col_end]``, and each bucket's
    ``rows_max``; a bucket's flat keys mean rows only under its plan."""
    strat = emb.strategy
    return {"tp": sorted(
        [int(pl.bucket), int(pl.rank), int(pl.row_offset), int(pl.rows),
         int(strat.table_groups[1][pl.table_id]), int(pl.col_start),
         int(pl.col_end)] for pl in emb.plan.tp_placements),
        "rows_max": [max(int(b.rows_max), 1) for b in emb.plan.tp_buckets]}


def _translate_delta(emb, plan: dict, tp_parts: dict) -> dict:
    """A delta's bucket rows {("tp", b): (keys, rows)}, keyed under the
    publisher's `plan` (its header's record), re-keyed onto `emb`'s plan:
    each key to its table and row, then to where `emb` holds that table,
    {("tp", b): (flat keys, rows)} of its buckets (a column slice of the
    table each, cut from the row), {("row", t): (global rows, rows)} of
    its row-sliced tables and {("dp_rows", j): (rows ids, rows)} of its
    dp tables. A table that `emb` slices across two of the publisher's
    column slices raises ValueError."""
    strat = emb.strategy
    width = {g: int(c["output_dim"]) for g, c in
             enumerate(strat.global_configs)}
    mine: Dict[int, list] = {}
    for pl in emb.plan.tp_placements:
        rows_max = max(emb.plan.tp_buckets[pl.bucket].rows_max, 1)
        mine.setdefault(strat.table_groups[1][pl.table_id], []).append(
            (pl.col_start, pl.col_end, "tp", pl.bucket,
             pl.rank * rows_max + pl.row_offset))
    for kind, group in (("row", 2), ("dp_rows", 0)):
        for idx, gtid in enumerate(strat.table_groups[group]):
            mine.setdefault(gtid, []).append((0, width[gtid], kind, idx, 0))
    parts: Dict[Tuple[str, int], list] = {}
    for (_, b), (keys, rows) in tp_parts.items():
        rows_max = plan["rows_max"][b]
        rank, local = keys // rows_max, keys % rows_max
        for pb, prank, off, n, gtid, c0, c1 in plan["tp"]:
            if pb != b:
                continue
            sel = (rank == prank) & (local >= off) & (local < off + n)
            if not sel.any():
                continue
            r, part = local[sel] - off, rows[sel]
            for q0, q1, kind, idx, base in mine[gtid]:
                if q1 <= c0 or q0 >= c1:
                    continue                 # another slice of the table
                if q0 < c0 or q1 > c1:
                    raise ValueError(
                        f"table {gtid}: columns [{q0}, {q1}) here span the "
                        f"publisher's column slices ([{c0}, {c1}) one of "
                        "them): its rows cannot be re-keyed")
                parts.setdefault((kind, idx), []).append(
                    (base + r, part[:, q0 - c0:q1 - c0]))
    return {k: (np.concatenate([a for a, _ in v]),
                np.ascontiguousarray(np.concatenate([c for _, c in v])))
            for k, v in parts.items()}


def _multi_rank(emb, what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"TableStore.{what} is single-process: at world size "
        f"{emb.world_size} each rank holds only its own rows and batch "
        f"slice, so it would drop the other ranks' rows; {item}")


class TableStore:
    """Versioned owner of one `DistributedEmbedding`'s tables.

    Args:
      emb: the layer; the store reads and writes its own tensors.
      params: None (the JAX package's params pytree: the port's layer
        holds its tables).
      opt_states: optional sparse-optimizer state (``opt_state["emb"]`` of
        the train step: ``{"tp": [...], "row": [...]}``), the training
        side's; `commit` takes the step's newest.
      snapshot_every: every N-th publish is a full snapshot (0 or None:
        only the first, mandatory one).
      registry: optional `obs.registry.MetricRegistry` for the streaming
        metrics (``store/publishes``, ``store/publish_bytes``,
        ``store/publish_rows``, ``store/applies``, ``store/apply_bytes``,
        ``store/apply_rows``, ``store/version{role=publisher|consumer}``,
        ``store/bytes{dtype=}``; `DeltaConsumer` adds
        ``store/version_lag`` and ``store/publish_to_apply_seconds``).
        Default: a private registry.
      delta_dtype: payload dtype of the published rows ("f32", default,
        "int8" or "fp8": per-row-scaled payloads with a ``*_scale``
        sibling). Keys stay int64 and dp tables float32; consuming follows
        each file's header.
    """

    def __init__(self, emb, params=None, opt_states: Optional[dict] = None,
                 snapshot_every: Optional[int] = None, registry=None,
                 delta_dtype: Optional[str] = None):
        if params is not None:
            raise ValueError(
                "TableStore(params=...): the port's layer holds its own "
                "tables; pass params=None and the store reads the layer")
        self._metrics = registry if registry is not None \
            else MetricRegistry()
        self.emb = emb
        self._opt = opt_states
        self.snapshot_every = int(snapshot_every or 0)
        self.delta_dtype = wire.resolve_store_dtype(delta_dtype)
        self._published_bytes_by_dtype: Dict[str, int] = {}
        self.version = 0
        strat = emb.strategy
        self._n_tables = len(strat.global_configs)
        self.table_versions = [0] * self._n_tables
        # plan signature: consumers refuse a stream of another model
        self._sig = [(int(c["input_dim"]), int(c["output_dim"]))
                     for c in strat.global_configs]
        self._bucket_tables: Dict[int, List[int]] = {}
        for pl in emb.plan.tp_placements:
            gtid = strat.table_groups[1][pl.table_id]
            tables = self._bucket_tables.setdefault(pl.bucket, [])
            if gtid not in tables:
                tables.append(gtid)
        self._row_tables = list(strat.table_groups[2])
        self._dp_tables = list(strat.table_groups[0])
        # the placement a delta's flat keys are read under
        self._plan = _plan_record(emb)
        # producer: touched flat keys since the last publish, and the
        # (kind, index) touched since the last commit (per-table versions)
        self._pending: Dict[Tuple[str, int], np.ndarray] = {}
        self._since_commit: set = set()
        self._publishes = 0
        # the last published version (None: the next publish snapshots)
        self._published_version: Optional[int] = None
        # consumer: True after an out-of-band swap until the next snapshot
        # (a local version bump could alias a publisher's version)
        self._chain_broken = False
        self._swept_dirs: set = set()

    def use_registry(self, registry) -> None:
        """Rebind the store's metrics onto `registry` (`training.fit` puts
        its publisher on the run's registry). Counts already in the
        previous registry stay there."""
        self._metrics = registry

    # ------------------------------------------------------------- state
    @property
    def opt_states(self) -> Optional[dict]:
        return self._opt

    def full_table_bytes(self) -> int:
        """Bytes of one full float32 copy of every table (the denominator
        of the delta-against-full-copy accounting)."""
        return sum(v * w * 4 for v, w in self._sig)

    def _require_single_process(self, what: str) -> None:
        if self.emb.world_size > 1:
            raise _multi_rank(self.emb, what,
                              "publish from a world-1 layer of the same "
                              "tables (get_weights / set_weights)")

    # ------------------------------------------------- producer: touched
    def observe(self, inputs) -> None:
        """Accumulate one training batch's touched rows (the same inputs
        the step sees, numpy or tensors; `touched_row_keys`): the union
        since the last publish is the next delta's key set."""
        self._require_single_process("observe")
        self._merge_touched(self.emb.touched_row_keys(inputs))

    def _merge_touched(self, touched: Dict[Tuple[str, int], np.ndarray]):
        for key, keys in touched.items():
            keys = np.asarray(keys, np.int64).reshape(-1)
            if not len(keys):
                continue
            cur = self._pending.get(key)
            self._pending[key] = sorted_unique(
                keys if cur is None else np.concatenate([cur, keys]))
            self._since_commit.add(key)

    def commit(self, params=None, opt_states: Optional[dict] = None,
               touched: Optional[Dict[Tuple[str, int], np.ndarray]] = None
               ) -> int:
        """Bump the store version after a step (the layer's tensors were
        updated in place); `opt_states` replaces the held optimizer state,
        `touched` merges extra touched keys (`touched_row_keys`' form).
        Returns the new version."""
        if params is not None:
            raise ValueError("commit(params=...): the port's layer holds its "
                             "own tables; pass None")
        if touched:
            self._merge_touched(touched)
        if opt_states is not None:
            self._opt = opt_states
        self.version += 1
        # dp tables train densely: every commit may move every dp row
        for gtid in self._dp_tables:
            self.table_versions[gtid] = self.version
        for kind, idx in self._since_commit:
            gtids = (self._bucket_tables.get(idx, []) if kind == "tp"
                     else [self._row_tables[idx]])
            for gtid in gtids:
                self.table_versions[gtid] = self.version
        self._since_commit = set()
        # a commit opens version V's lineage track: publish, scan, apply
        # and serve land on it
        default_recorder().lineage(self.version, "commit")
        return self.version

    def replace(self, params=None, opt_states: Optional[dict] = None) -> int:
        """A full out-of-band swap of the layer's tables: bumps the
        version and breaks the delta chain (the next publish snapshots; a
        consumer resyncs at the next snapshot)."""
        if params is not None:
            raise ValueError("replace(params=...): the port's layer holds "
                             "its own tables; pass None")
        if opt_states is not None:
            self._opt = opt_states
        self.version += 1
        self.table_versions = [self.version] * self._n_tables
        self._pending = {}
        self._since_commit = set()
        self._published_version = None
        self._chain_broken = True
        return self.version

    # -------------------------------------------------- versioned reads
    def read_rows(self, b: int, keys) -> np.ndarray:
        """The versioned read of tp bucket `b`: float32 rows for flat keys
        (``rank * rows_max + row``), the canonical values (decoded from a
        quantized bucket) with the hot-resident rows written over them,
        equal to what `get_weights` reports for those rows."""
        self._require_single_process("read_rows")
        return self._merged_rows(b, keys)

    def read_local_rows(self, b: int, keys) -> np.ndarray:
        """`read_rows` of keys in this rank's world slice only (the
        serving cache's refresh at any world size: each rank holds its own
        rows); a key of another rank raises ValueError."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        rows_max = max(self.emb.plan.tp_buckets[b].rows_max, 1)
        if np.any(keys // rows_max != self.emb.rank):
            raise ValueError(
                f"read_local_rows: keys outside rank {self.emb.rank}'s "
                "world slice")
        return self._merged_rows(b, keys)

    def _merged_rows(self, b: int, keys) -> np.ndarray:
        keys = np.asarray(keys, np.int64).reshape(-1)
        out = _bucket_rows(self.emb, b, keys)
        overlay = self.emb.hot_resident_rows().get(b)
        if overlay is not None:
            okeys, orows = overlay                  # sorted by construction
            pos = np.searchsorted(okeys, keys)
            pos_c = np.minimum(pos, len(okeys) - 1)
            hit = (pos < len(okeys)) & (okeys[pos_c] == keys)
            if hit.any():
                out = np.array(out)
                out[hit] = orows[pos_c[hit]]
        return out

    def get_weights(self) -> List[np.ndarray]:
        """Portable merged per-table float32 weights at the current
        version (`DistributedEmbedding.get_weights`)."""
        return self.emb.get_weights()

    def set_weights(self, weights) -> int:
        """Write portable per-table weights into the layer (the hot sets
        empty) and bump the version; chain-breaking like `replace`."""
        self.emb.set_weights(weights)
        return self.replace(None, self._opt)

    def sync_hot_rows(self, new_keys=None, admit: bool = False) -> int:
        """The hot shards' consistency step through the store
        (`DistributedEmbedding.sync_hot_rows` on the held optimizer
        state), then a version bump. The merged view does not change."""
        self._opt = self.emb.sync_hot_rows(self._opt, new_keys=new_keys,
                                           admit=admit)
        self.version += 1
        for b in self.emb._hot_buckets:
            for gtid in self._bucket_tables.get(b, []):
                self.table_versions[gtid] = self.version
        return self.version

    # --------------------------------------------------------- publishing
    def publish(self, directory: str, force_snapshot: bool = False) -> dict:
        """Write the next stream file into `directory`.

        The first publish (every `snapshot_every`-th, and a forced one) is
        a full snapshot: one merged float32 array a table. Otherwise a
        delta: per touched bucket the keys accumulated since the last
        publish and their merged rows, and the dp tables whole. Needs a
        commit since the last publish (files are keyed by version). The
        first publish into a directory sweeps the orphaned ``*.tmp*`` files
        a crashed publisher left; the file is written under a tmp name and
        renamed into place (`utils.checkpoint.publish_atomic`), and the
        publisher's state moves only after the rename.

        Returns {"kind", "version", "base_version", "path", "bytes",
        "rows", "dtype", "payload_bytes", "model_payload_bytes"}."""
        self._require_single_process("publish")
        if self.version == self._published_version:
            raise ValueError(
                "publish: nothing committed since the last publish "
                "(stream files are keyed by version)")
        os.makedirs(directory, exist_ok=True)
        m = self._metrics
        if directory not in self._swept_dirs:
            self._swept_dirs.add(directory)
            removed = ckpt.sweep_orphan_tmp(directory)
            if removed:
                m.counter("store/orphan_tmp_swept_total").inc(len(removed))
                warnings.warn(
                    f"publish: swept {len(removed)} orphaned tmp file(s) "
                    f"from {directory}: "
                    f"{[os.path.basename(p) for p in removed]}",
                    RuntimeWarning, stacklevel=2)
        publishes = self._publishes + 1
        snap = (force_snapshot or self._published_version is None
                or (self.snapshot_every
                    and publishes % self.snapshot_every == 0))
        dd = self.delta_dtype
        meta = {"version": self.version,
                "base_version": self._published_version,
                "published_at": time.time(), "dtype": dd, "sig": self._sig,
                "plan": self._plan}
        arrays: Dict[str, np.ndarray] = {}

        def enc(name, rows):
            p, s = wire.encode_rows_np(rows, dd)
            arrays[name] = p
            if s is not None:
                arrays[f"{name}_scale"] = s

        model_bytes = 0
        n_rows = 0
        if snap:
            meta["kind"] = "snapshot"
            for i, w in enumerate(self.get_weights()):
                enc(f"table{i}", w)
                model_bytes += w.shape[0] * wire.snapshot_row_bytes(
                    w.shape[1], dd)
                n_rows += w.shape[0]
        else:
            meta["kind"] = "delta"
            for (kind, idx), keys in sorted(self._pending.items()):
                if kind != "tp":
                    raise _multi_rank(self.emb, "publish",
                                      "row-sliced tables exist only there")
                rows = self.read_rows(idx, keys)
                arrays[f"{kind}{idx}_keys"] = keys
                enc(f"{kind}{idx}_rows", rows)
                model_bytes += len(keys) * wire.delta_row_bytes(
                    rows.shape[1], dd)
                n_rows += len(keys)
            for j, table in enumerate(self.emb.dp):
                # dp tables stay float32: dense-trained, small
                dp = table.detach().cpu().numpy().astype(np.float32)
                arrays[f"dp{j}_full"] = dp
                model_bytes += dp.nbytes
                n_rows += dp.shape[0]
        path = _publish_path(directory, self.version, meta["kind"])
        payload_bytes = int(sum(a.nbytes for a in arrays.values()))
        tmp = ckpt.save_row_delta(path + ".tmp", meta, arrays)
        del arrays
        ckpt.publish_atomic(tmp, path)
        self._publishes = publishes
        self._published_version = self.version
        self._pending = {}
        info = {"kind": meta["kind"], "version": self.version,
                "base_version": meta["base_version"], "path": path,
                "bytes": os.path.getsize(path), "rows": n_rows, "dtype": dd,
                "payload_bytes": payload_bytes,
                "model_payload_bytes": int(model_bytes)}
        m.counter("store/publishes").inc()
        m.counter("store/publish_bytes").inc(info["bytes"])
        m.counter("store/publish_rows").inc(n_rows)
        self._published_bytes_by_dtype[dd] = (
            self._published_bytes_by_dtype.get(dd, 0) + info["bytes"])
        m.gauge("store/bytes", dtype=dd).set(
            self._published_bytes_by_dtype[dd])
        m.gauge("store/version", role="publisher").set(self.version)
        default_recorder().lineage(self.version, "publish",
                                   kind=meta["kind"], bytes=info["bytes"],
                                   rows=n_rows)
        return info

    # --------------------------------------------------------- consuming
    def _check_sig(self, meta: dict, path: str) -> None:
        sig = [tuple(int(x) for x in pair) for pair in meta.get("sig", [])]
        if sig != self._sig:
            raise ValueError(
                f"{path}: published for a different model "
                f"(table shapes {sig} != {self._sig})")

    def _hot_resident_guard(self) -> None:
        if self.emb.hot_resident_rows():
            raise ValueError(
                "delta consumption requires an EMPTY hot set on the "
                "consumer: resident hot rows would shadow the canonical "
                "writes (sync_hot_rows and drop residency first)")

    def apply_published(self, path: str) -> dict:
        """Apply one stream file (delta or snapshot) into the layer in
        place. A delta needs ``meta["base_version"] == self.version``
        (`DeltaChainError` otherwise: resync from a snapshot); a snapshot
        applies from any version. Collective at world size > 1: every rank
        passes the same file, reads and decodes it, and writes its rows
        only once every rank's read succeeded (see the module docstring).
        Returns {"kind", "version", "rows", "bytes", "published_at",
        "payload"}: payload maps ("tp", b) to a delta's (keys, rows)."""
        meta, n_bytes, tables = _agreed(
            self.emb, lambda: self._read_published(path))
        return self._write_published(meta, n_bytes, tables)

    def _read_published(self, path: str):
        """A stream file's header, checked against this store (the model's
        signature, the chain, the hot set), its bytes, and its arrays
        decoded to float32: the per-table weights of a snapshot, {(kind,
        index): (keys, rows)} and {("dp", j): table} of a delta. Writes
        nothing."""
        n_bytes = os.path.getsize(path)
        meta, arrays = ckpt.load_row_delta(path)
        self._check_sig(meta, path)
        stream_dtype = meta.get("dtype", "f32")

        def dec(name):
            if stream_dtype == "f32":
                return np.asarray(arrays[name], np.float32)
            scale = arrays.get(f"{name}_scale")
            if scale is None:
                raise ValueError(
                    f"{path}: array {name} is {stream_dtype}-encoded but "
                    "carries no _scale sibling: a publisher bug, not "
                    "stream damage")
            return wire.decode_rows_np(arrays[name], scale, stream_dtype)

        if meta["kind"] == "snapshot":
            return meta, n_bytes, [dec(f"table{i}")
                                   for i in range(self._n_tables)]
        if self._chain_broken:
            raise DeltaChainError(
                f"{path}: this store's tables were replaced out of band "
                "after its last snapshot; a version match alone cannot "
                "prove the delta chains from them: resync from a "
                "snapshot")
        if meta["base_version"] != self.version:
            raise DeltaChainError(
                f"{path}: delta base_version {meta['base_version']} != "
                f"consumer version {self.version}; resync from a "
                "snapshot")
        self._hot_resident_guard()
        out = {}
        for name in sorted(arrays):
            m = re.match(r"^(tp|row)(\d+)_keys$", name)
            if m:
                kind, idx = m.group(1), int(m.group(2))
                n = len(self.emb.tp if kind == "tp" else self.emb.row)
                if idx >= n:
                    raise ValueError(
                        f"{path}: carries {kind} table {idx}, which this "
                        f"layer does not have ({n})")
                out[(kind, idx)] = (np.asarray(arrays[name], np.int64),
                                    dec(f"{kind}{idx}_rows"))
        plan = meta.get("plan")
        if plan is not None and plan != self._plan:
            # published under another placement (a world-1 publisher's
            # stream at world size > 1): its bucket keys re-keyed here
            out = _translate_delta(self.emb, plan, out)
        for j in range(len(self.emb.dp)):
            name = f"dp{j}_full"
            if name in arrays:
                out[("dp", j)] = np.asarray(arrays[name], np.float32)
        return meta, n_bytes, out

    @torch.no_grad()
    def _write_published(self, meta: dict, n_bytes: int, tables) -> dict:
        payload: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]] = {}
        if "crc" not in meta:
            self._metrics.counter("store/legacy_files_total").inc()
        if meta["kind"] == "snapshot":
            self.emb.set_weights(tables)
            n_rows = sum(t.shape[0] for t in tables)
            self._chain_broken = False         # a snapshot re-anchors
        else:
            n_rows = 0
            for (kind, idx), part in tables.items():
                if kind == "dp":
                    self.emb.dp[idx].data.copy_(torch.from_numpy(part))
                    n_rows += part.shape[0]
                    continue
                keys, rows = part
                n_rows += len(keys)
                if kind == "dp_rows":
                    table = self.emb.dp[idx].data
                    table[torch.as_tensor(keys, device=table.device)] = \
                        torch.from_numpy(rows).to(table.device)
                elif kind == "row":
                    _set_row_rows(self.emb, idx, keys, rows)
                else:
                    _set_bucket_rows(self.emb, idx, keys, rows)
                    payload[("tp", idx)] = (keys, rows)
        self.version = int(meta["version"])
        self._published_version = None     # consumers never publish onward
        info = {"kind": meta["kind"], "version": self.version,
                "rows": n_rows, "bytes": n_bytes,
                "published_at": meta.get("published_at"),
                "payload": payload}
        m = self._metrics
        m.counter("store/applies").inc()
        m.counter("store/apply_bytes").inc(info["bytes"])
        m.counter("store/apply_rows").inc(n_rows)
        m.gauge("store/version", role="consumer").set(self.version)
        default_recorder().lineage(self.version, "apply",
                                   kind=meta["kind"], rows=n_rows)
        return info


class DeltaConsumer:
    """Poll loop and staleness accounting over one store and one publish
    directory: every new stream file applied in chain order, the newest
    snapshot taken when the chain breaks.

    A corrupt file (failed checksum, bad zip, torn payload) is
    quarantined: skipped for good, counted in
    ``store/corrupt_files_total``, one warning, and the chain re-anchors
    on the publisher's next snapshot. A transient read error (`OSError`)
    is retried with capped exponential backoff
    (``store/poll_retries_total``) and, if it persists, given up for this
    poll only. The header cache is bounded by the live stream.

    Args:
      store: the consumer's `TableStore`.
      directory: the publish directory.
      max_transient_retries / retry_backoff_s / retry_backoff_cap_s: the
        retry budget per file and its backoff (2^k * retry_backoff_s,
        capped).
    """

    def __init__(self, store: TableStore, directory: str,
                 max_transient_retries: int = 3,
                 retry_backoff_s: float = 0.005,
                 retry_backoff_cap_s: float = 0.05):
        self.store = store
        self.directory = directory
        self.max_transient_retries = int(max_transient_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self._meta_cache: Dict[str, dict] = {}
        self.applied: List[dict] = []
        self._lag_versions: List[int] = []
        self._lag_seconds: List[float] = []
        self._apply_seconds = 0.0
        self._rows_applied = 0
        # path -> reason; quarantined files are invisible to the chooser
        self.quarantined: Dict[str, str] = {}
        self._retries_total = 0
        self._degraded: set = set()
        self._last_scan: List[Tuple[int, str, str]] = []
        # versions this consumer has stamped "scan" on their lineage track
        self._lineage_scanned: set = set()

    # ------------------------------------------------------------ internals
    def _visible(self, upto: Optional[int] = None
                 ) -> List[Tuple[int, str, str]]:
        # rank 0's listing on every rank: the ranks choose alike while the
        # publisher writes
        self._last_scan = _from_rank0(
            self.store.emb, lambda: scan_published(self.directory))
        files = [f for f in self._last_scan if f[2] not in self.quarantined]
        if upto is not None:
            files = [f for f in files if f[0] <= upto]
        return files

    def _quarantine(self, path: str, err: BaseException) -> None:
        reason = f"{type(err).__name__}: {err}"
        self.quarantined[path] = reason[:300]
        self._degraded.add("corrupt_stream")
        self.store._metrics.counter("store/corrupt_files_total").inc()
        if self.store.emb.rank == 0:
            # every rank skips the file; one says so
            warnings.warn(
                f"stream file quarantined (corrupt, will re-anchor on the "
                f"next snapshot): {path}: {reason[:200]}", RuntimeWarning,
                stacklevel=3)

    def _backoff(self, attempt: int) -> None:
        self._retries_total += 1
        self.store._metrics.counter("store/poll_retries_total").inc()
        time.sleep(min(self.retry_backoff_s * (2 ** attempt),
                       self.retry_backoff_cap_s))

    def _retried(self, fn, path: str):
        """``(fn(), "ok")``, or (None, "transient" | "quarantined"): a
        transient error retried with backoff, a corrupt file
        quarantined."""
        for attempt in range(self.max_transient_retries + 1):
            try:
                return fn(), "ok"
            except DeltaChainError:
                raise                    # the chooser's contract: loud
            except Exception as e:  # noqa: BLE001 - classified below
                if _is_transient_error(e):
                    if attempt >= self.max_transient_retries:
                        self._degraded.add("io_transient")
                        return None, "transient"
                    self._backoff(attempt)
                    continue
                if _is_corrupt_error(e):
                    self._quarantine(path, e)
                    return None, "quarantined"
                raise
        return None, "transient"

    def _meta(self, path: str) -> Optional[dict]:
        """The cached header of a stream file (immutable once renamed), or
        None when it cannot be read this poll."""
        meta = self._meta_cache.get(path)
        if meta is None:
            meta, _ = self._retried(
                lambda: _from_rank0(self.store.emb,
                                    lambda: ckpt.load_row_delta_meta(path)),
                path)
            if meta is not None:
                self._meta_cache[path] = meta
        return meta

    def _choose(self, files: List[Tuple[int, str, str]]) -> Optional[str]:
        """The next applicable file, or None (caught up, or waiting for the
        publisher's next snapshot)."""
        if self.store._chain_broken:
            # after an out-of-band replace only a snapshot can anchor
            snaps = [f for f in files if f[1] == "snapshot"]
            return snaps[-1][2] if snaps else None
        nxt = None
        for version, kind, path in files:
            if version <= self.store.version:
                continue
            if kind == "delta":
                meta = self._meta(path)
                if meta is not None \
                        and meta["base_version"] == self.store.version:
                    return path
            elif nxt is None:
                nxt = path                   # a snapshot applies from any v
        return nxt

    def _apply_one(self, path: str) -> Tuple[Optional[dict], str]:
        t0 = time.perf_counter()
        info, status = self._retried(
            lambda: self.store.apply_published(path), path)
        if status == "ok":
            # rank 0's clock on every rank: the accounting agrees
            self._apply_seconds += _from_rank0(
                self.store.emb, lambda: time.perf_counter() - t0)
            return info, "applied"
        return None, status

    def _evict_meta_cache(self) -> None:
        """Bound the header cache (and the quarantine list) by the live
        stream, from the poll's own last scan."""
        live = {path for _, _, path in self._last_scan}
        self._meta_cache = {p: m for p, m in self._meta_cache.items()
                            if p in live}
        for p in [p for p in self.quarantined if p not in live]:
            del self.quarantined[p]
        # applied versions never stamp again (a stamp needs version >
        # store.version): the set holds the versions in flight
        self._lineage_scanned = {v for v in self._lineage_scanned
                                 if v > self.store.version}

    def degraded_reasons(self) -> frozenset:
        """The current degradation set (empty = healthy):
        ``corrupt_stream`` while quarantined damage keeps the consumer
        behind, ``io_transient`` while reads fail. Cleared when a poll
        ends caught up."""
        return frozenset(self._degraded)

    def poll(self, upto: Optional[int] = None) -> List[dict]:
        """Apply every applicable published file; returns their infos
        (possibly none). Never raises on a corrupt or transiently
        unreadable file. `upto` caps consumption at a version: staleness
        and health are measured against the cap."""
        files = self._visible(upto)
        # lineage: the first time this consumer's scan sees a version it
        # has not applied (the scan -> apply gap is the consumer's half
        # of staleness)
        for version, _, _ in files:
            if (version > self.store.version
                    and version not in self._lineage_scanned):
                self._lineage_scanned.add(version)
                default_recorder().lineage(version, "scan")
        newer = [f for f in files if f[0] > self.store.version]
        if not newer and not self.store._chain_broken:
            self._evict_meta_cache()
            if not any(f[0] > self.store.version for f in self._last_scan
                       if upto is None or f[0] <= upto):
                self._degraded.clear()
            return []
        if newer:
            self._lag_versions.append(newer[-1][0] - self.store.version)
            self.store._metrics.gauge("store/version_lag").set(
                self._lag_versions[-1])
        out = []
        latest_seen = self.store.version
        while True:
            files = self._visible(upto)
            capped = [f for f in self._last_scan
                      if upto is None or f[0] <= upto]
            if capped:
                latest_seen = max(latest_seen, capped[-1][0])
            nxt = self._choose(files)
            if nxt is None:
                break
            info, status = self._apply_one(nxt)
            if status == "quarantined":
                continue                     # rescan: snapshot fallback
            if status != "applied":
                break                        # transient: next poll retries
            self._rows_applied += info["rows"]
            if info.get("published_at"):
                self._lag_seconds.append(_from_rank0(
                    self.store.emb,
                    lambda: max(time.time() - info["published_at"], 0.0)))
                self.store._metrics.histogram(
                    "store/publish_to_apply_seconds").record(
                        self._lag_seconds[-1])
            self.applied.append(info)
            out.append(info)
        residual = max(0, latest_seen - self.store.version)
        if out or residual:
            self.store._metrics.gauge("store/version_lag").set(residual)
        if residual == 0 and not self.store._chain_broken:
            self._degraded.clear()
        self._evict_meta_cache()
        return out

    def stats(self) -> dict:
        d_bytes = [i["bytes"] for i in self.applied if i["kind"] == "delta"]
        s_bytes = [i["bytes"] for i in self.applied
                   if i["kind"] == "snapshot"]
        versions = [i["version"] for i in self.applied]
        return {
            "applied": len(self.applied),
            "applied_deltas": len(d_bytes),
            "applied_snapshots": len(s_bytes),
            "rows_applied": self._rows_applied,
            "delta_bytes_total": int(sum(d_bytes)),
            "delta_bytes_mean": int(np.mean(d_bytes)) if d_bytes else 0,
            "snapshot_bytes": int(s_bytes[-1]) if s_bytes else 0,
            "apply_seconds": round(self._apply_seconds, 6),
            "apply_rows_per_sec": (
                round(self._rows_applied / self._apply_seconds)
                if self._apply_seconds > 0 else 0),
            "staleness_versions_max": (max(self._lag_versions)
                                       if self._lag_versions else 0),
            "staleness_versions_mean": (
                round(float(np.mean(self._lag_versions)), 3)
                if self._lag_versions else 0.0),
            "staleness_s_max": (round(max(self._lag_seconds), 6)
                                if self._lag_seconds else 0.0),
            "staleness_s_mean": (
                round(float(np.mean(self._lag_seconds)), 6)
                if self._lag_seconds else 0.0),
            "version_monotonic": versions == sorted(versions)
            and len(set(versions)) == len(versions),
            "version": self.store.version,
            "quarantined_files": len(self.quarantined),
            "poll_retries": self._retries_total,
            "degraded_reasons": sorted(self._degraded),
        }


def restore_from_published(emb, directory: str,
                           upto: Optional[int] = None) -> TableStore:
    """Rebuild `emb`'s tables from a publish stream, in place: the newest
    snapshot (at most `upto` when given) and every chained delta after it.
    Collective at world size > 1 (rank 0's listing, every apply agreed).
    Returns a consumer `TableStore` at the reconstructed version."""
    files = _from_rank0(emb, lambda: scan_published(directory))
    if upto is not None:
        files = [f for f in files if f[0] <= upto]
    snaps = [f for f in files if f[1] == "snapshot"]
    if not snaps:
        raise FileNotFoundError(
            f"no snapshot in {directory}: a delta chain needs its anchor")
    store = TableStore(emb)
    store.apply_published(snaps[-1][2])
    for version, kind, path in files:
        if version > store.version and kind == "delta":
            store.apply_published(path)
    return store
