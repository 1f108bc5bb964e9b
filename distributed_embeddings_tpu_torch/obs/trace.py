"""Flight recorder: bounded in-memory trace of structured events.

Counterpart of ``distributed_embeddings_tpu/obs/trace.py``, copied. A
span (`obs.span`) has three outputs: a registry histogram, a
``torch.profiler.record_function`` range (seen only while a profiler
runs), and this recorder: a BOUNDED ring of begin/end/instant events that
is always on, cheap enough to feed from every span (one lock and a deque
append per edge), and exportable at any moment as Chrome-trace-format
JSON that loads in Perfetto (ui.perfetto.dev) or chrome://tracing.

Event kinds (Chrome trace `ph` phases on export):

  * ``begin``/``end`` (B/E): span edges, appended by `obs.span` on entry
    and exit with the composed span path, per thread (the training loop,
    pipeline workers and consumer pollers each get their own track).
  * ``instant`` (i): point annotations (degraded entry, fleet membership,
    canary verdicts).
  * ``lineage`` (b/n/e nestable-async, ``cat="version"``): a store
    version's life as one async track keyed by the version number:
    ``commit`` opens the track, ``publish``/``scan``/``apply`` land as
    async instants on it, and the FIRST ``serve`` (a predict answered at
    >= that version) closes it. Publisher and replica report into one
    process-wide recorder, so the track spans threads and components.
    Later phases on a closed track (a second replica applying the same
    version) record as instants, so the async pairing stays balanced.

The ring is bounded (``capacity``, 16384 events by default, the JAX
package's ``DET_OBS_TRACE_EVENTS`` default; the port reads no
environment): old events fall off the front and the drop count is kept.
`export()` re-balances on the way out (an `end` whose `begin` was evicted
is dropped; a still-open `begin` gets a synthetic close at the export
timestamp), so the exported JSON always validates.

`dump_postmortem` is the incident artifact: ring, registry snapshot and
caller context in one timestamped JSON file.
`InferenceEngine.poll_updates` calls it on every degraded-mode entry when
the engine was built with ``postmortem_dir=``.
"""

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["FlightRecorder", "default_recorder", "reset_default_recorder",
           "dump_postmortem", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 16384

# lineage phases in life order; "commit" opens the async track and
# "serve" closes it (first occurrence only — see class docstring)
LINEAGE_PHASES = ("commit", "publish", "scan", "apply", "serve")


class FlightRecorder:
    """Bounded ring of trace events; see module docstring.

    Args:
      capacity: max events held (oldest evicted first; 16384 by
        default).

    Every mutator is thread-safe (one lock around the deque); the
    recording cost is one `time.perf_counter()` read plus an append,
    so spans can feed it unconditionally.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=self.capacity)
        self._dropped = 0
        self._thread_names: Dict[int, str] = {}
        # lineage state: version -> "open" | "closed" (versions the ring
        # has begun an async track for; bounded by eviction reconcile at
        # export, and by being integers — a few bytes per version)
        self._lineage: Dict[int, str] = {}
        # perf_counter at construction: export timestamps are relative
        # to this origin (Chrome trace ts is an arbitrary-epoch us)
        self._t0 = time.perf_counter()
        # wall-clock twin of _t0 so exported args can carry absolute time
        self._wall0 = time.time()

    # ------------------------------------------------------------ record
    def _append_locked(self, ph: str, name: str, ts: float, tid: int,
                       cat: Optional[str] = None,
                       eid: Optional[int] = None,
                       args: Optional[dict] = None):
        """Caller holds self._lock. Split out so `lineage` can make its
        state transition AND its event append one atomic step — a
        check-then-act gap there lets two threads first-sighting the
        same version emit a duplicate async begin (or land an 'n'
        before its 'b'), breaking the balanced-export contract."""
        if tid not in self._thread_names:
            self._thread_names[tid] = threading.current_thread().name
        if len(self._events) == self.capacity:
            self._dropped += 1
        self._events.append((ph, name, ts, tid, cat, eid, args))

    def _append(self, ph: str, name: str, cat: Optional[str] = None,
                eid: Optional[int] = None, args: Optional[dict] = None):
        tid = threading.get_ident()
        ts = time.perf_counter() - self._t0
        with self._lock:
            self._append_locked(ph, name, ts, tid, cat, eid, args)

    def begin(self, name: str) -> None:
        """Open a region (span entry). Paired with `end(name)`."""
        self._append("B", name)

    def end(self, name: str) -> None:
        """Close a region (span exit)."""
        self._append("E", name)

    def instant(self, name: str, **args) -> None:
        """A point event (degraded entry, SLO breach, fault fired...)."""
        self._append("i", name, args=args or None)

    def lineage(self, version: int, phase: str, **args) -> None:
        """One step of store version `version`'s life (see module
        docstring). Unknown-to-the-recorder versions auto-open (a
        consumer can watch a stream whose publisher lives elsewhere);
        the first ``serve`` closes the track, later phases on a closed
        version record as async instants."""
        if phase not in LINEAGE_PHASES:
            raise ValueError(
                f"lineage phase {phase!r} not in {LINEAGE_PHASES}")
        version = int(version)
        name = f"v{version}"
        tid = threading.get_ident()
        # state transition + event append under ONE lock hold: two
        # threads first-sighting a version must serialize into exactly
        # one 'b' followed by the other's 'n'/'e'
        with self._lock:
            ts = time.perf_counter() - self._t0
            state = self._lineage.get(version)
            if state is None:
                # open the async track (commit, or first sight on a
                # consumer that never saw the publisher's commit)
                self._lineage[version] = "open"
                self._append_locked(
                    "b", name, ts, tid, cat="version", eid=version,
                    args={"phase": "commit"} if phase == "commit"
                    else None)
                if phase == "commit":
                    return
                state = "open"
            if phase == "serve" and state == "open":
                self._lineage[version] = "closed"
                self._append_locked(
                    "e", name, ts, tid, cat="version", eid=version,
                    args={"phase": "serve", **args} if args
                    else {"phase": "serve"})
                return
            self._append_locked("n", name, ts, tid, cat="version",
                                eid=version,
                                args={"phase": phase, **args})

    # ------------------------------------------------------------- views
    def events(self) -> List[tuple]:
        """The current ring contents, oldest first (tuples of
        (ph, name, ts_seconds, tid, cat, id, args))."""
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        """Events evicted from the ring so far (0 = nothing lost)."""
        with self._lock:
            return self._dropped

    def lineage_versions(self) -> List[int]:
        """Versions whose lineage track this ring has opened, sorted."""
        with self._lock:
            return sorted(self._lineage)

    def lineage_open_versions(self) -> List[int]:
        """Versions whose track is begun but not yet closed by a
        ``serve`` phase, sorted — the serving seam closes every open
        version <= the version a predict was answered at (a predict at
        V is also the first predict at >= every version below it)."""
        with self._lock:
            return sorted(v for v, s in self._lineage.items()
                          if s == "open")

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._lineage.clear()

    # ------------------------------------------------------------ export
    def to_chrome_trace(self) -> dict:
        """The ring as a Chrome-trace-format dict (`traceEvents` JSON
        object form — what Perfetto and chrome://tracing load).

        Balanced by construction: per-thread `E` events whose `B` was
        evicted from the ring are dropped, still-open `B` events get a
        synthetic close at the export timestamp, and lineage tracks
        likewise (an evicted async begin is re-synthesized at the
        track's first surviving event; an open track closes at export).
        Span timestamps are microseconds relative to the recorder's
        construction.
        """
        with self._lock:
            events = list(self._events)
            thread_names = dict(self._thread_names)
            wall0 = self._wall0
        pid = os.getpid()
        now_us = (time.perf_counter() - self._t0) * 1e6
        out: List[dict] = [{
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": "flight_recorder"}}]
        for tid, tname in thread_names.items():
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": tname}})
        open_spans: Dict[int, List[dict]] = {}
        open_async: Dict[int, dict] = {}
        for ph, name, ts, tid, cat, eid, args in events:
            ev = {"ph": ph, "name": name, "pid": pid, "tid": tid,
                  "ts": round(ts * 1e6, 3)}
            if cat is not None:
                ev["cat"] = cat
            if eid is not None:
                ev["id"] = eid
            if args:
                ev["args"] = dict(args)
            if ph == "B":
                open_spans.setdefault(tid, []).append(ev)
                out.append(ev)
            elif ph == "E":
                stack = open_spans.get(tid)
                if not stack:
                    continue             # begin evicted: drop the orphan
                stack.pop()
                out.append(ev)
            elif ph == "b":
                open_async[eid] = ev
                out.append(ev)
            elif ph in ("n", "e"):
                if eid not in open_async:
                    # async begin evicted: re-open the track just before
                    # this first surviving event so the id still groups
                    synth = {"ph": "b", "name": name, "pid": pid,
                             "tid": tid, "cat": cat or "version",
                             "id": eid, "ts": ev["ts"],
                             "args": {"synthesized": "begin-evicted"}}
                    open_async[eid] = synth
                    out.append(synth)
                if ph == "e":
                    open_async[eid] = None   # closed
                out.append(ev)
            else:                            # "i" and any future phases
                ev["s"] = "t"
                out.append(ev)
        # close whatever export caught mid-flight, deepest first
        for tid, stack in open_spans.items():
            for ev in reversed(stack):
                out.append({"ph": "E", "name": ev["name"], "pid": pid,
                            "tid": tid, "ts": round(now_us, 3),
                            "args": {"synthesized": "open-at-export"}})
        for eid, ev in open_async.items():
            if ev is not None:
                out.append({"ph": "e", "name": ev["name"], "pid": pid,
                            "tid": ev["tid"], "cat": ev.get("cat",
                                                            "version"),
                            "id": eid, "ts": round(now_us, 3),
                            "args": {"synthesized": "open-at-export"}})
        return {
            "displayTimeUnit": "ms",
            "metadata": {"source":
                         "distributed_embeddings_tpu_torch.obs.trace",
                         "wall_time_origin": wall0,
                         "dropped_events": self._dropped},
            "traceEvents": out,
        }

    def export(self, path: str) -> dict:
        """Write `to_chrome_trace()` to `path` (overwrite; the ring is
        a window, not a log — repeated exports supersede). Returns the
        exported dict."""
        doc = self.to_chrome_trace()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


_default_lock = threading.Lock()
_default: Optional[FlightRecorder] = None


def default_recorder() -> FlightRecorder:
    """The process-wide recorder `obs.span`, the store/consumer lineage
    seams, and the serving engine feed — one ring so a postmortem sees
    publisher, pipeline and replica activity on one timeline."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder()
        return _default


def reset_default_recorder() -> None:
    """Drop the process-wide recorder (tests)."""
    global _default
    with _default_lock:
        _default = None


def dump_postmortem(directory: str, reason: str, registry=None,
                    recorder: Optional[FlightRecorder] = None,
                    extra: Optional[dict] = None) -> str:
    """Write the incident artifact: flight-recorder ring (as a chrome
    trace) + registry snapshot + caller context, one timestamped JSON
    file in `directory`. Returns the artifact path.

    The filename carries a monotonic-per-process sequence number so two
    dumps in the same second (two reasons activating on one poll) never
    collide or overwrite."""
    rec = recorder if recorder is not None else default_recorder()
    os.makedirs(directory, exist_ok=True)
    with _default_lock:
        global _postmortem_seq
        _postmortem_seq += 1
        seq = _postmortem_seq
    safe = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(reason))[:60]
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    path = os.path.join(directory,
                        f"postmortem_{stamp}_{seq:04d}_{safe}.json")
    doc = {
        "ts": round(time.time(), 3),
        "reason": str(reason),
        "snapshot": (registry.snapshot() if registry is not None else None),
        "trace": rec.to_chrome_trace(),
        "lineage_versions": rec.lineage_versions(),
        "dropped_events": rec.dropped,
    }
    if extra:
        doc["extra"] = extra
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)       # atomic: a watcher never sees a torn dump
    if registry is not None:
        registry.counter("obs/postmortems_total", reason=safe).inc()
    return path


_postmortem_seq = 0
