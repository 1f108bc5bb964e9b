"""Device-time attribution: profiler trace -> per-span device seconds.

Counterpart of ``distributed_embeddings_tpu/obs/attribution.py``, reading
``torch.profiler``'s Chrome trace where the JAX module reads XLA's.
`obs.span` opens a ``record_function`` range for every span path, so a
capture (`utils.profiling.trace`) holds the span windows (``cat:
"user_annotation"`` events on the host thread that opened them) and the
device operations side by side. This module matches them and answers:
where did a step's device time go, span by span?

The device operations are the events with ``cat`` ``kernel``,
``gpu_memcpy`` or ``gpu_memset``. A CPU-only capture has none; there, as
the JAX module takes XLA:CPU's thunks, each thread's top-level ``cpu_op``
events stand in for them (``op_source`` says which), so a capture on the
CPU sees real coverage.

Matching operations to spans:

  * A CUDA kernel runs after the host has left the span that launched
    it, so the JAX rule (the innermost window containing the operation's
    midpoint) misplaces it. A kernel is attributed through its launch
    instead: the ``cuda_runtime`` (or ``cuda_driver``) launch event and
    the kernel share ``args.correlation``, and the launch's host
    timestamp and thread name the innermost window open at launch.
  * A ``cpu_op`` is attributed the same way, through its own thread and
    midpoint.
  * A launch on a thread with no window open takes, in order: the
    thread that ran the forward of the backward operator enclosing it
    (autograd runs a card's backward on a worker thread of its own; the
    ``autograd::engine::evaluate_function`` operator there carries the
    forward's ``Sequence number``, which names the forward operator and
    so its thread), the innermost window open there at the launch; else
    the innermost window open on any thread at the launch. The second is
    a guess, and so is the first where several threads qualify: both are
    totalled in ``ambiguous_seconds``.
  * An operation with no launch on record takes the JAX rule: the
    innermost window, on any thread, containing its midpoint. Where
    windows of several host threads contain that midpoint the choice is
    a guess, totalled in ``ambiguous_seconds``.

Attribution is exhaustive: every operation lands in one span or in
``unattributed``. The accumulators are integer nanoseconds (``ns``), so
``sum(ns["spans"]) + ns["unattributed"] == ns["total"]`` holds exactly;
the seconds fields are those sums rounded to 9 places. Collectives (NCCL
kernels: ``ncclDevKernel_*``, ``ncclKernel_*``, SendRecv for all_to_all)
match `COLLECTIVE_RE`, gemms (cuBLAS, CUTLASS) and the JAX names
`COMPUTE_RE`, and the exposed share of collective time is the part no
concurrent compute covers. Over gloo a collective is host work with no
device operation: ``collectives`` is then 0, and no exposure is guessed.

Outputs: `attribute_logdir(logdir, registry=)` (the ``device/*`` gauges),
`reconciliation_table(att, projections)` and the CLI
``python -m distributed_embeddings_tpu_torch.tools.device_attribution``.
"""

import bisect
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["find_trace_file", "load_trace_events", "attribute_device_time",
           "export_device_gauges", "attribute_logdir",
           "reconciliation_table", "span_paths_from_snapshot",
           "COLLECTIVE_RE", "COMPUTE_RE"]

# the JAX package's HLO names, and NCCL's kernels (SendRecv carries an
# all_to_all)
COLLECTIVE_RE = re.compile(
    r"(ragged-)?all-to-all|all-gather|all-reduce|reduce-scatter"
    r"|collective-permute|nccl(Dev)?Kernel|SendRecv", re.IGNORECASE)
# the JAX package's dense-compute names, and cuBLAS / CUTLASS gemms
COMPUTE_RE = re.compile(r"\b(dot|convolution|cudnn|fusion)|gemm|cutlass"
                        r"|cublas", re.IGNORECASE)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"


def find_trace_file(logdir: str) -> str:
    """The newest capture's ``*.trace.json(.gz)`` under `logdir`
    (`utils.profiling.trace` writes ``plugins/profile/<run>/
    <host>.trace.json.gz``, the JAX profiler's layout). Raises
    FileNotFoundError when no capture landed."""
    pats = [os.path.join(logdir, "plugins", "profile", "*", p)
            for p in ("*.trace.json.gz", "*.trace.json")]
    pats += [os.path.join(logdir, p)
             for p in ("*.trace.json.gz", "*.trace.json")]
    hits: List[str] = []
    for pat in pats:
        hits.extend(glob.glob(pat))
    if not hits:
        raise FileNotFoundError(
            f"no profiler chrome trace (*.trace.json[.gz]) under "
            f"{logdir!r} — did the capture run?")
    return max(hits, key=os.path.getmtime)


def load_trace_events(path: str) -> List[dict]:
    """The `traceEvents` list of one Chrome-trace JSON file (gzipped or
    plain; object form or bare event list)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        doc = json.loads(f.read().decode("utf-8", errors="replace"))
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def _ns(us) -> int:
    """A trace time in microseconds as integer nanoseconds."""
    return int(round(float(us) * 1000.0))


def _complete(e: dict) -> bool:
    return e.get("ph") == "X" and "dur" in e


def _span_windows(events: Sequence[dict], span_paths
                  ) -> List[Tuple[int, int, str, tuple]]:
    """(start_ns, end_ns, path, (pid, tid)) for every span annotation.

    With `span_paths` (the registry's recorded span set) the match is
    exact. Without, fall back to the shape of an annotation: a name that
    contains ``/`` and is neither a python frame (``$``-prefixed) nor an
    operator (``::``)."""
    wins = []
    for e in events:
        if not _complete(e) or e.get("cat") != SPAN_CAT:
            continue
        name = e.get("name", "")
        if span_paths is not None:
            if name not in span_paths:
                continue
        elif "/" not in name or name.startswith("$") or "::" in name:
            continue
        s = _ns(e["ts"])
        wins.append((s, s + _ns(e["dur"]), name,
                     (e.get("pid"), e.get("tid"))))
    return wins


def _top_level_cpu_ops(events: Sequence[dict]) -> List[dict]:
    """Each thread's ``cpu_op`` events that no other ``cpu_op`` of the same
    thread contains."""
    by_thread: Dict[tuple, List[dict]] = {}
    for e in events:
        if _complete(e) and e.get("cat") == "cpu_op":
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for ops in by_thread.values():
        ops.sort(key=lambda e: (_ns(e["ts"]), -_ns(e["dur"])))
        end = None
        for e in ops:
            s = _ns(e["ts"])
            if end is None or s >= end:
                out.append(e)
                end = s + _ns(e["dur"])
    return out


def _merged_intervals(ivs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, t in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def _overlap(s: int, t: int, merged: List[Tuple[int, int]]) -> int:
    """Length of [s, t] covered by the merged interval list."""
    cov = 0
    for a, b in merged:
        if b <= s:
            continue
        if a >= t:
            break
        cov += min(b, t) - max(a, s)
    return cov


def _innermost(wins_sorted, at2: int, thread=None):
    """The shortest window containing the doubled timestamp `at2` (on
    `thread` when given): ``(start_ns, end_ns, path, thread)`` or None."""
    for w in wins_sorted:
        if ((thread is None or w[3] == thread)
                and 2 * w[0] <= at2 <= 2 * w[1]):
            return w
    return None


def _thread(e: dict) -> tuple:
    return (e.get("pid"), e.get("tid"))


def _backward_index(events: Sequence[dict]):
    """The autograd links of a capture: ({thread: [(start_ns, end_ns,
    sequence number)] of its backward operators, by start},
    {sequence number: the threads whose forward operators carry it}). A
    ``cpu_op`` with a nonzero ``Fwd thread id`` is a backward operator;
    its ``Sequence number`` is its forward operator's."""
    backward: Dict[tuple, list] = {}
    forward: Dict[int, set] = {}
    for e in events:
        if not _complete(e) or e.get("cat") != "cpu_op":
            continue
        args = e.get("args") or {}
        seq = args.get("Sequence number")
        if seq is None:
            continue
        if args.get("Fwd thread id"):
            s = _ns(e["ts"])
            backward.setdefault(_thread(e), []).append(
                (s, s + _ns(e["dur"]), seq))
        else:
            forward.setdefault(seq, set()).add(_thread(e))
    for ops in backward.values():
        ops.sort()
    return backward, forward


def _place(wins_sorted, at2: int, thread, backward, forward):
    """The window of a host instant (doubled, `at2`) on `thread`, by the
    module docstring's rules: (window or None, rule, ambiguous)."""
    w = _innermost(wins_sorted, at2, thread)
    if w is not None:
        return w, "own_thread", False
    ops = backward.get(thread, ())
    # the outermost backward operator containing the instant
    seq = None
    for s, t, q in ops[:bisect.bisect_right(ops, (at2 // 2 + 1,))]:
        if 2 * s <= at2 <= 2 * t:
            seq = q
            break
    if seq is not None:
        hits = [w for w in (_innermost(wins_sorted, at2, c)
                            for c in forward.get(seq, ()) if c != thread)
                if w is not None]
        if hits:
            return (min(hits, key=lambda h: h[1] - h[0]), "forward_thread",
                    len(hits) > 1)
    w = _innermost(wins_sorted, at2)
    return w, "any_thread", w is not None


def attribute_device_time(events: Sequence[dict],
                          span_paths: Optional[set] = None) -> dict:
    """Attribute device-operation time to the span annotations that
    launched it (see the module docstring).

    Args:
      events: Chrome-trace `traceEvents` (from `load_trace_events`).
      span_paths: the span paths to take as windows (typically the
        registry's ``span_seconds{span=}`` key set); None = the shape
        fallback.

    Returns the JAX package's ``device_attribution`` dict:
    ``total_device_seconds``, ``spans`` {path: seconds},
    ``unattributed_seconds``, ``ambiguous_seconds``, ``coverage_frac``,
    ``device_op_count``, ``span_window_count``, ``categories_seconds`` and
    the ``collective`` exposure block (global and per span), seconds
    rounded to 9 places; and the port's own fields: ``ns`` (the exact
    integer sums), ``op_source`` ("device" or "cpu_ops"),
    ``launch_matched`` (operations placed through their launch),
    ``collectives`` (collective operations counted), ``top_ops`` and
    ``unattributed_top_ops`` ([name, seconds] of the ten largest by total
    time, of all operations and of those in no span), and ``placement``
    (operations by the rule that placed them: ``own_thread``,
    ``forward_thread``, ``any_thread``, ``midpoint``, ``none``).
    """
    events = [e for e in events if isinstance(e, dict)]
    wins = _span_windows(events, span_paths)
    # innermost-first candidate order: the shortest window wins
    wins_sorted = sorted(wins, key=lambda w: w[1] - w[0])
    # ambiguity zones: where windows of different host threads coexist
    by_thread: Dict[tuple, List[Tuple[int, int]]] = {}
    for s, t, _, wthread in wins:
        by_thread.setdefault(wthread, []).append((s, t))
    amb_zones: List[Tuple[int, int]] = []
    if len(by_thread) > 1:
        merged = {k: _merged_intervals(iv) for k, iv in by_thread.items()}
        keys = list(merged)
        for i, ka in enumerate(keys):
            for kb in keys[i + 1:]:
                for a1, b1 in merged[ka]:
                    for a2, b2 in merged[kb]:
                        lo, hi = max(a1, a2), min(b1, b2)
                        if lo < hi:
                            amb_zones.append((lo, hi))
        amb_zones = _merged_intervals(amb_zones)

    ops = [e for e in events
           if _complete(e) and e.get("cat") in DEVICE_CATS]
    source = "device"
    if not ops:
        ops = _top_level_cpu_ops(events)
        source = "cpu_ops"
    launches = {}
    for e in events:
        if _complete(e) and e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e

    backward, forward = _backward_index(events)

    total = 0
    per_span: Dict[str, int] = {}
    unattributed = 0
    ambiguous = 0
    matched = 0
    placement: Dict[str, int] = {}
    categories: Dict[str, int] = {}
    by_name: Dict[str, int] = {}
    unplaced_by_name: Dict[str, int] = {}
    compute_ivs: List[Tuple[int, int]] = []
    coll_ops: List[Tuple[int, int, Optional[str]]] = []
    for e in ops:
        ts, dur = _ns(e["ts"]), _ns(e["dur"])
        total += dur
        name = str(e.get("name", ""))
        by_name[name] = by_name.get(name, 0) + dur
        if source == "cpu_ops":
            host = (2 * ts + dur, _thread(e))
        else:
            launch = launches.get((e.get("args") or {}).get("correlation"))
            host = None if launch is None else (
                2 * _ns(launch["ts"]), _thread(launch))
        if host is not None:
            matched += 1
            win, rule, guess = _place(wins_sorted, host[0], host[1],
                                      backward, forward)
        else:
            mid2 = 2 * ts + dur
            win, rule = _innermost(wins_sorted, mid2), "midpoint"
            guess = win is not None and any(
                2 * a <= mid2 <= 2 * b for a, b in amb_zones)
        if guess:
            ambiguous += dur
        if win is None:
            rule = "none"
            assigned = None
            unattributed += dur
            unplaced_by_name[name] = unplaced_by_name.get(name, 0) + dur
        else:
            assigned = win[2]
            per_span[assigned] = per_span.get(assigned, 0) + dur
        placement[rule] = placement.get(rule, 0) + 1
        if COLLECTIVE_RE.search(name):
            categories["collective"] = categories.get("collective", 0) + dur
            coll_ops.append((ts, ts + dur, assigned))
        elif COMPUTE_RE.search(name):
            categories["compute"] = categories.get("compute", 0) + dur
            compute_ivs.append((ts, ts + dur))
        else:
            categories["other"] = categories.get("other", 0) + dur

    merged_compute = _merged_intervals(compute_ivs)
    coll_total = 0
    coll_exposed = 0
    per_span_coll: Dict[str, Dict[str, int]] = {}
    for s, t, path in coll_ops:
        dur = t - s
        exp = dur - _overlap(s, t, merged_compute)
        coll_total += dur
        coll_exposed += exp
        if path is not None:
            d = per_span_coll.setdefault(path, {"seconds": 0,
                                                "exposed_seconds": 0})
            d["seconds"] += dur
            d["exposed_seconds"] += exp

    def sec(v):
        return round(v * 1e-9, 9)

    return {
        "total_device_seconds": sec(total),
        "spans": {p: sec(v) for p, v in sorted(per_span.items())},
        "unattributed_seconds": sec(unattributed),
        "ambiguous_seconds": sec(ambiguous),
        "coverage_frac": round((total - unattributed) / total, 6)
        if total else 0.0,
        "device_op_count": len(ops),
        "span_window_count": len(wins),
        "categories_seconds": {k: sec(v)
                               for k, v in sorted(categories.items())},
        "collective": {
            "device_seconds": sec(coll_total),
            "exposed_seconds": sec(coll_exposed),
            "overlapped_seconds": sec(coll_total - coll_exposed),
            "exposed_fraction": round(coll_exposed / coll_total, 6)
            if coll_total else None,
            "per_span": {
                p: {"seconds": sec(d["seconds"]),
                    "exposed_seconds": sec(d["exposed_seconds"]),
                    "exposed_fraction": round(
                        d["exposed_seconds"] / d["seconds"], 6)
                    if d["seconds"] else None}
                for p, d in sorted(per_span_coll.items())},
        },
        "ns": {"total": total, "spans": dict(sorted(per_span.items())),
               "unattributed": unattributed},
        "op_source": source,
        "launch_matched": matched,
        "collectives": len(coll_ops),
        "top_ops": [[n, sec(v)] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "unattributed_top_ops": [[n, sec(v)] for n, v in sorted(
            unplaced_by_name.items(), key=lambda kv: -kv[1])[:10]],
        "placement": dict(sorted(placement.items())),
    }


def export_device_gauges(att: dict, registry) -> None:
    """Publish an attribution onto a registry: one
    ``device/span_seconds{span=}`` gauge per attributed span, plus
    ``device/unattributed_seconds`` and ``device/total_seconds`` (and
    ``device/exposed_exchange_fraction`` when a collective ran on the
    device): the device-side twins of the host ``span_seconds``
    histograms."""
    for path, seconds in att.get("spans", {}).items():
        registry.gauge("device/span_seconds", span=path).set(seconds)
    registry.gauge("device/unattributed_seconds").set(
        att.get("unattributed_seconds", 0.0))
    registry.gauge("device/total_seconds").set(
        att.get("total_device_seconds", 0.0))
    coll = att.get("collective", {})
    if coll.get("exposed_fraction") is not None:
        registry.gauge("device/exposed_exchange_fraction").set(
            coll["exposed_fraction"])


def span_paths_from_snapshot(snapshot: dict) -> Optional[set]:
    """The span paths a registry snapshot (or a record carrying a
    ``metrics_snapshot``) has recorded: its ``span_seconds{span=}``
    histogram keys."""
    snap = snapshot.get("metrics_snapshot", snapshot)
    paths = set()
    for key in snap.get("histograms", {}):
        m = re.match(r"^span_seconds\{span=(.+)\}$", key)
        if m:
            paths.add(m.group(1))
    return paths or None


def attribute_logdir(logdir: str, registry=None,
                     span_paths: Optional[set] = None) -> dict:
    """Parse the newest capture under `logdir` and attribute it. With a
    `registry`: the window set defaults to the registry's recorded span
    paths and the ``device/*`` gauges are exported onto it. Returns the
    attribution dict (plus ``trace_file``)."""
    path = find_trace_file(logdir)
    if span_paths is None and registry is not None:
        span_paths = span_paths_from_snapshot(registry.snapshot())
    att = attribute_device_time(load_trace_events(path),
                                span_paths=span_paths)
    att["trace_file"] = os.path.basename(path)
    if registry is not None:
        export_device_gauges(att, registry)
    return att


def reconciliation_table(att: dict, projections: Dict[str, float],
                         tolerance_frac: float = 0.5) -> List[dict]:
    """Measured-against-projected rows: for each projection
    ``{phase_or_span: projected_ms}``, the measured per-span device
    milliseconds (exact path, else the sum over spans whose path contains
    it, else the total for "total" / "step"), ``settled`` within
    ``tolerance_frac`` relative, else ``falsified``; ``unmeasured`` when
    the capture has no such signal."""
    spans_ms = {p: s * 1e3 for p, s in att.get("spans", {}).items()}
    rows = []
    for phase, projected_ms in sorted(projections.items()):
        measured = spans_ms.get(phase)
        if measured is None:
            hits = [v for p, v in spans_ms.items() if phase in p]
            measured = sum(hits) if hits else None
        if measured is None and phase in ("total", "step"):
            measured = att.get("total_device_seconds", 0.0) * 1e3
        if measured is None or projected_ms is None:
            verdict = "unmeasured"
        else:
            rel = (abs(measured - float(projected_ms))
                   / max(abs(float(projected_ms)), 1e-9))
            verdict = "settled" if rel <= tolerance_frac else "falsified"
        rows.append({
            "phase": phase,
            "projected_ms": (round(float(projected_ms), 3)
                             if projected_ms is not None else None),
            "measured_ms": (round(measured, 3)
                            if measured is not None else None),
            "verdict": verdict,
        })
    return rows
