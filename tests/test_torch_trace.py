"""The port's flight recorder, version lineage, device-time attribution and
postmortems against the JAX package's, case for case with
tests/test_trace.py.

* the recorder: bounded under a long run, its export balanced after the
  eviction cut, and equal to the JAX recorder's after the same begin /
  end / instant / lineage sequence with the clocks pinned;
* spans feed the recorder with the histogram's paths, from any thread;
* lineage through the real seams (commit, publish, a consumer's scan and
  apply, the engine's first predict) in the JAX package's order;
* attribution: the JAX fixture written as a `torch.profiler` trace gives
  the JAX result (innermost window, exposure, cross-thread ambiguity,
  the logdir gauges, reconciliation); a kernel that runs after its span
  closed is placed through its launch; a real CPU capture of a small
  `fit` has nonzero span coverage with the sum identity exact;
* the fleet's and the engine's instants equal the JAX package's;
* a degraded entry dumps a postmortem with ``postmortem_dir`` (the JAX
  package's ``DET_OBS_POSTMORTEM_DIR``) and not without it;
* the export satellites, and every metric family a composed run exports
  in docs/observability.md's catalog.
"""

import gzip
import json
import os
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_embeddings_tpu import faults  # noqa: E402
from distributed_embeddings_tpu import obs as jobs  # noqa: E402
from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.obs import attribution as jattribution  # noqa: E402
from distributed_embeddings_tpu.obs.trace import (  # noqa: E402
    FlightRecorder as JaxRecorder)
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu.serving import (  # noqa: E402
    InferenceEngine as JaxEngine)
from distributed_embeddings_tpu.store import TableStore as JaxStore  # noqa: E402
from distributed_embeddings_tpu_torch import obs  # noqa: E402
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.obs import attribution  # noqa: E402
from distributed_embeddings_tpu_torch.obs.trace import FlightRecorder  # noqa: E402
from distributed_embeddings_tpu_torch.serving import (  # noqa: E402
    InferenceEngine, MicroBatcher)
from distributed_embeddings_tpu_torch.store import (  # noqa: E402
    DeltaConsumer, TableStore)
from distributed_embeddings_tpu_torch.training import fit  # noqa: E402
from distributed_embeddings_tpu_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(96, 8), (200, 8)]


def _weights(rng):
    return [rng.randn(v, w).astype(np.float32) * 0.1 for v, w in SIZES]


def _zeros():
    return [np.zeros((v, w), np.float32) for v, w in SIZES]


def _layer():
    return DistributedEmbedding([Embedding(v, w, device="meta")
                                 for v, w in SIZES], device="cpu")


def _jax_layer():
    return JaxDistributedEmbedding([JaxEmbedding(v, w) for v, w in SIZES],
                                   mesh=create_mesh(jax.devices()[:1]))


def _balance(doc):
    """Per-thread B/E depth check; returns the final depths."""
    depth = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "B":
            depth[ev["tid"]] = depth.get(ev["tid"], 0) + 1
        elif ev["ph"] == "E":
            depth[ev["tid"]] = depth.get(ev["tid"], 0) - 1
            assert depth[ev["tid"]] >= 0, "E without a B"
    return depth


def _async_balance(doc):
    """Nestable-async b/e pairing per id; returns the open ids."""
    open_ids = set()
    for ev in doc["traceEvents"]:
        if ev["ph"] == "b":
            assert ev["id"] not in open_ids, "double async begin"
            open_ids.add(ev["id"])
        elif ev["ph"] == "n":
            assert ev["id"] in open_ids, "async instant off-track"
        elif ev["ph"] == "e":
            assert ev["id"] in open_ids, "async end without begin"
            open_ids.discard(ev["id"])
    return open_ids


# ---------------------------------------------------------------- ring
def test_ring_bounded_under_long_run_and_export_balances(tmp_path):
    rec = FlightRecorder(capacity=64)
    for i in range(500):
        rec.begin(f"step{i}")
        rec.instant("tick", i=i)
        rec.end(f"step{i}")
    assert len(rec.events()) == 64
    assert rec.dropped == 500 * 3 - 64
    doc = rec.to_chrome_trace()
    assert all(v == 0 for v in _balance(doc).values())
    assert _async_balance(doc) == set()
    rec2 = FlightRecorder(capacity=4)
    rec2.begin("a")
    for i in range(10):
        rec2.instant(f"x{i}")       # evicts the begin
    rec2.end("a")                   # orphan: its B left the ring
    rec2.begin("open")              # never closed before export
    doc2 = rec2.to_chrome_trace()
    assert all(v == 0 for v in _balance(doc2).values())
    names = [e["name"] for e in doc2["traceEvents"] if e["ph"] == "E"]
    assert "a" not in names and "open" in names
    path = tmp_path / "t.json"
    rec2.export(str(path))
    assert json.load(open(path))["traceEvents"]


def _recorded(cls, monkeypatch, capacity):
    """The same begin / end / instant / lineage sequence on a `cls`
    recorder with the clocks pinned (each perf_counter read one step of
    0.25 ms, wall time 1e9); its export."""
    clock = iter(np.arange(1000) * 0.00025)
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    monkeypatch.setattr(time, "time", lambda: 1e9)
    rec = cls(capacity=capacity)
    rec.begin("train/step")
    rec.lineage(1, "commit")
    rec.instant("serve/degraded_entry", reason="poll_error", error=None)
    rec.lineage(1, "publish", kind="snapshot", bytes=10, rows=3)
    rec.end("train/step")
    rec.lineage(2, "apply", kind="delta", rows=2)      # opened on sight
    rec.lineage(1, "scan")
    rec.lineage(1, "serve", served_at_version=2)
    rec.lineage(1, "apply", kind="snapshot", rows=3)   # after its close
    rec.begin("open")
    for i in range(3):
        rec.instant("tick", i=i)
    doc = rec.to_chrome_trace()
    doc["metadata"].pop("source")
    return doc, rec.dropped, rec.lineage_open_versions()


@pytest.mark.parametrize("capacity", [64, 6])
def test_export_equals_the_jax_recorder(monkeypatch, capacity):
    """Identical sequences, clocks pinned: the exports are equal (capacity
    6 cuts the ring mid-track: both re-balance alike)."""
    mine = _recorded(FlightRecorder, monkeypatch, capacity)
    want = _recorded(JaxRecorder, monkeypatch, capacity)
    assert mine == want
    assert all(v == 0 for v in _balance(mine[0]).values())
    ends = [e["id"] for e in mine[0]["traceEvents"] if e["ph"] == "e"]
    begins = [e["id"] for e in mine[0]["traceEvents"] if e["ph"] == "b"]
    assert sorted(ends) == sorted(begins)


def test_capacity_validation_and_default():
    """The JAX package reads DET_OBS_TRACE_EVENTS (default 16384); the
    port takes the capacity as an argument at that default."""
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=1)
    assert FlightRecorder().capacity == 16384 == JaxRecorder().capacity
    assert FlightRecorder(capacity=128).capacity == 128


# ------------------------------------------------------- span -> ring
def test_spans_feed_recorder_and_nesting_matches_histogram_paths():
    obs.reset_default_recorder()
    reg = obs.MetricRegistry()
    with obs.span("train", reg):
        with obs.span("step", reg):
            pass
        with obs.span("publish", reg):
            pass
    doc = obs.default_recorder().to_chrome_trace()
    seq = [(e["ph"], e["name"]) for e in doc["traceEvents"]
           if e["ph"] in "BE"]
    assert seq == [("B", "train"), ("B", "train/step"),
                   ("E", "train/step"), ("B", "train/publish"),
                   ("E", "train/publish"), ("E", "train")]
    hist_paths = {k[len("span_seconds{span="):-1]
                  for k in reg.snapshot()["histograms"]}
    assert {n for _, n in seq} == hist_paths


def test_recorder_is_thread_safe_across_span_threads():
    obs.reset_default_recorder()
    reg = obs.MetricRegistry()

    def worker(i):
        for _ in range(50):
            with obs.span(f"w{i}", reg):
                pass

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    doc = obs.default_recorder().to_chrome_trace()
    assert all(v == 0 for v in _balance(doc).values())
    assert sum(1 for e in doc["traceEvents"] if e["ph"] == "B") == 200


# ------------------------------------------------------------- lineage
def _lineage_events(doc):
    return [(e["ph"], e["id"], (e.get("args") or {}).get("phase"))
            for e in doc["traceEvents"] if e.get("cat") == "version"]


def _port_lineage(d):
    obs.reset_default_recorder()
    rng = np.random.RandomState(3)
    pub = _layer()
    pub.set_weights(_weights(rng))
    store = TableStore(pub)
    store.commit()
    store.publish(d)                               # v1 snapshot
    cats = [rng.randint(0, v, (8,)).astype(np.int32) for v, _ in SIZES]
    store.commit(touched=pub.touched_row_keys(cats))
    store.publish(d)                               # v2 delta
    served = _layer()
    served.set_weights(_zeros())
    eng = InferenceEngine(served, device="cpu")
    assert [i["version"] for i in eng.poll_updates(d)] == [1, 2]
    req = [np.zeros((4,), np.int32) for _ in SIZES]
    eng.predict(req)                               # closes v1 and v2
    rec = obs.default_recorder()
    n_lineage = sum(1 for e in rec.events() if e[4] == "version")
    eng.predict(req)
    # a second predict at the same version closes nothing
    assert sum(1 for e in rec.events() if e[4] == "version") == n_lineage
    return rec


def _jax_lineage(d):
    jobs.reset_default_recorder()
    rng = np.random.RandomState(3)
    dist = _jax_layer()
    store = JaxStore(dist, dist.set_weights(_weights(rng)))
    store.commit(store.params)
    store.publish(d)
    import jax.numpy as jnp
    cats = [jnp.asarray(rng.randint(0, v, (8,)).astype(np.int32))
            for v, _ in SIZES]
    store.commit(store.params, touched=dist.touched_row_keys(cats))
    store.publish(d)
    served = _jax_layer()
    eng = JaxEngine(served, served.set_weights(_zeros()))
    assert [i["version"] for i in eng.poll_updates(d)] == [1, 2]
    eng.predict([np.zeros((4,), np.int32) for _ in SIZES])
    return jobs.default_recorder()


def test_lineage_tracks_through_publish_poll_predict(tmp_path):
    """commit opens V's track, publish / scan / apply ride it, the first
    predict at >= V closes it: version-monotonic, balanced, and the same
    events as the JAX package's seams on the same stream."""
    rec = _port_lineage(str(tmp_path / "pub"))
    assert rec.lineage_versions() == [1, 2]
    assert rec.lineage_open_versions() == []
    evs = [e for e in rec.to_chrome_trace()["traceEvents"]
           if e.get("cat") == "version"]
    begins = [e["id"] for e in evs if e["ph"] == "b"]
    assert begins == sorted(begins) == [1, 2]
    assert _async_balance({"traceEvents": evs}) == set()
    phases = {(e["id"], e.get("args", {}).get("phase")) for e in evs}
    for v in (1, 2):
        for phase in ("publish", "scan", "apply"):
            assert (v, phase) in phases
    closes = [e for e in evs if e["ph"] == "e"]
    assert {e["id"] for e in closes} == {1, 2}
    assert all(e["args"]["served_at_version"] == 2 for e in closes)
    jrec = _jax_lineage(str(tmp_path / "jax_pub"))
    assert _lineage_events(rec.to_chrome_trace()) == _lineage_events(
        jrec.to_chrome_trace())


def test_lineage_rejects_unknown_phase_and_autoopens_consumer_side():
    rec = FlightRecorder(capacity=64)
    with pytest.raises(ValueError, match="phase"):
        rec.lineage(1, "observe")
    rec.lineage(7, "apply")
    assert [e[0] for e in rec.events()] == ["b", "n"]
    assert rec.lineage_versions() == [7]


# --------------------------------------------------------- attribution
def _jax_fixture():
    """tests/test_trace.py's synthetic XLA trace: two nested span windows
    on a host thread, device ops on a /device: process (us)."""
    return [
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1000,
         "name": "bench/outer"},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 100, "dur": 300,
         "name": "bench/outer/inner"},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 2000,
         "name": "$runpy.py:1 run"},
        {"ph": "X", "pid": 9, "tid": 2, "ts": 150, "dur": 100,
         "name": "fusion.1", "args": {"hlo_op": "fusion.1"}},
        {"ph": "X", "pid": 9, "tid": 2, "ts": 500, "dur": 200,
         "name": "all-to-all.2", "args": {"hlo_op": "all-to-all.2"}},
        {"ph": "X", "pid": 9, "tid": 3, "ts": 550, "dur": 100,
         "name": "fusion.3", "args": {"hlo_op": "fusion.3"}},
        {"ph": "X", "pid": 9, "tid": 2, "ts": 1500, "dur": 50,
         "name": "copy.4", "args": {"hlo_op": "copy.4"}},
    ]


def _torch_fixture():
    """The same windows and ops as `torch.profiler` writes them: the spans
    ``user_annotation`` ranges, the python frame a ``python_function``,
    the ops a gemm, NCCL's SendRecv, a CUTLASS gemm on a second stream
    and a copy (no launch on record: the JAX rule places them)."""
    return [
        {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1, "ts": 0,
         "dur": 1000, "name": "bench/outer"},
        {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1,
         "ts": 100, "dur": 300, "name": "bench/outer/inner"},
        {"ph": "X", "cat": "python_function", "pid": 1, "tid": 1, "ts": 0,
         "dur": 2000, "name": "runpy.py(1): run"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 150,
         "dur": 100, "name": "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 500,
         "dur": 200, "name": "ncclDevKernel_SendRecv(ncclDevWorkColl)"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 8, "ts": 550,
         "dur": 100, "name": "void cutlass::Kernel2<cutlass_80_gemm>"},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 1500,
         "dur": 50, "name": "Memcpy DtoD (Device -> Device)"},
    ]


def _jax_keys(att):
    return {k: v for k, v in att.items()
            if k not in ("ns", "op_source", "launch_matched", "collectives",
                         "top_ops", "unattributed_top_ops", "placement",
                         "trace_file")}


def test_attribution_innermost_window_sum_identity_and_exposure():
    att = attribution.attribute_device_time(_torch_fixture())
    want = jattribution.attribute_device_time(_jax_fixture())
    assert _jax_keys(att) == want
    assert att["spans"] == {"bench/outer": pytest.approx(300e-6),
                            "bench/outer/inner": pytest.approx(100e-6)}
    ns = att["ns"]
    assert sum(ns["spans"].values()) + ns["unattributed"] == ns["total"]
    assert ns["total"] == 450_000 and att["device_op_count"] == 4
    assert att["span_window_count"] == 2
    assert att["collective"]["exposed_fraction"] == pytest.approx(0.5)
    assert att["collectives"] == 1 and att["launch_matched"] == 0
    assert att["op_source"] == "device"
    assert _jax_keys(attribution.attribute_device_time(
        _torch_fixture(), span_paths={"bench/outer"})) == \
        jattribution.attribute_device_time(_jax_fixture(),
                                           span_paths={"bench/outer"})


def test_attribution_flags_cross_thread_window_ambiguity():
    def ev(fmt, tid, ts, dur, name, cat):
        e = {"ph": "X", "pid": 1 if cat == "user_annotation" else 9,
             "tid": tid, "ts": ts, "dur": dur, "name": name}
        if fmt == "torch":
            e["cat"] = cat
        elif cat == "kernel":
            e["args"] = {"hlo_op": name}
        return e

    def events(fmt):
        return [ev(fmt, 1, 0, 1000, "train/step", "user_annotation"),
                ev(fmt, 2, 400, 200, "serve/predict", "user_annotation"),
                ev(fmt, 5, 450, 100, "fusion.1", "kernel"),
                ev(fmt, 5, 700, 100, "fusion.2", "kernel")]
    att = attribution.attribute_device_time(events("torch"))
    assert _jax_keys(att) == jattribution.attribute_device_time(
        events("jax"))
    assert att["spans"]["serve/predict"] == pytest.approx(100e-6)
    assert att["ambiguous_seconds"] == pytest.approx(100e-6)


def test_attribution_places_a_kernel_through_its_launch():
    """A kernel that runs after its span closed is the launching span's
    (``args.correlation`` joins it to its ``cuda_runtime`` launch); the
    midpoint rule would leave it unattributed. A kernel launched outside
    every span stays unattributed; launched from a thread with no window
    while another thread's window is open, it is that window's, a guess
    counted ambiguous."""
    events = [
        {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1, "ts": 0,
         "dur": 100, "name": "train/step"},
        {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 2,
         "ts": 150, "dur": 100, "name": "serve/predict"},
        {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1, "ts": 40,
         "dur": 5, "name": "cudaLaunchKernel", "args": {"correlation": 5}},
        {"ph": "X", "cat": "cuda_driver", "pid": 1, "tid": 1, "ts": 120,
         "dur": 5, "name": "cuLaunchKernel", "args": {"correlation": 6}},
        {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1, "ts": 160,
         "dur": 5, "name": "cudaLaunchKernel", "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 200,
         "dur": 300, "name": "lookup_combine_kernel",
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 500,
         "dur": 40, "name": "adagrad_rows_kernel",
         "args": {"correlation": 6}},
        {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7, "ts": 600,
         "dur": 10, "name": "Memset (Device)", "args": {"correlation": 7}},
    ]
    att = attribution.attribute_device_time(events)
    assert att["ns"]["spans"] == {"train/step": 300_000,
                                  "serve/predict": 10_000}
    assert att["ns"]["unattributed"] == 40_000
    assert att["launch_matched"] == 3
    assert att["ambiguous_seconds"] == pytest.approx(10e-6)
    assert att["placement"] == {"any_thread": 1, "none": 1,
                                "own_thread": 1}
    assert att["top_ops"][0] == ["lookup_combine_kernel", 300e-6]
    assert att["unattributed_top_ops"] == [["adagrad_rows_kernel", 40e-6]]


def test_attribution_places_a_backward_kernel_on_its_forward_thread():
    """On a card autograd launches the backward from a worker thread of
    its own, where no span is open. Its kernel belongs to the window the
    forward's thread has open at the launch: the backward operator
    enclosing the launch carries the forward's ``Sequence number`` (and a
    nonzero ``Fwd thread id``), which names the forward operator's
    thread. That placement is no guess, even where another thread's
    shorter window is open too; a worker launch outside any backward
    operator takes the innermost window open on any thread, a guess."""
    def op(tid, ts, dur, name, cat="cpu_op", **args):
        return {"ph": "X", "cat": cat, "pid": 1, "tid": tid, "ts": ts,
                "dur": dur, "name": name, "args": args}
    events = [
        op(1, 0, 1000, "train/step", "user_annotation"),
        op(2, 250, 250, "serve/predict", "user_annotation"),
        op(1, 10, 20, "aten::mm", **{"Sequence number": 3,
                                     "Fwd thread id": 0}),
        op(2, 260, 5, "aten::mm", **{"Sequence number": 8,
                                     "Fwd thread id": 0}),
        op(9, 300, 100, "autograd::engine::evaluate_function: "
           "MmBackward0", **{"Sequence number": 3, "Fwd thread id": 1}),
        op(9, 320, 5, "cudaLaunchKernel", "cuda_runtime", correlation=11),
        op(9, 450, 5, "cudaLaunchKernel", "cuda_runtime", correlation=12),
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 1200,
         "dur": 50, "name": "sm90_xmma_gemm_f32f32", "args": {
             "correlation": 11}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 1300,
         "dur": 30, "name": "reduce_kernel", "args": {"correlation": 12}},
    ]
    att = attribution.attribute_device_time(events)
    assert att["ns"]["spans"] == {"train/step": 50_000,
                                  "serve/predict": 30_000}
    assert att["ns"]["unattributed"] == 0
    assert att["ambiguous_seconds"] == pytest.approx(30e-6)
    assert att["placement"] == {"any_thread": 1, "forward_thread": 1}


def test_attribution_logdir_gauges_and_reconciliation(tmp_path):
    def logdir(name, events):
        run = tmp_path / name / "plugins" / "profile" / "2026_01_01"
        os.makedirs(run)
        with gzip.open(run / "host.trace.json.gz", "wb") as f:
            f.write(json.dumps({"traceEvents": events}).encode())
        return str(tmp_path / name)

    gauges = []
    for o, attr, events in ((obs, attribution, _torch_fixture()),
                            (jobs, jattribution, _jax_fixture())):
        reg = o.MetricRegistry()
        reg.histogram("span_seconds", span="bench/outer").record(0.001)
        reg.histogram("span_seconds",
                      span="bench/outer/inner").record(0.0003)
        att = attr.attribute_logdir(logdir(o.__name__, events), registry=reg)
        assert att["trace_file"] == "host.trace.json.gz"
        gauges.append(reg.snapshot()["gauges"])
        rows = attr.reconciliation_table(
            att, {"bench/outer/inner": 0.1, "bench/outer": 10.0,
                  "nope": 1.0})
        by = {r["phase"]: r["verdict"] for r in rows}
        assert by == {"bench/outer/inner": "settled",
                      "bench/outer": "falsified", "nope": "unmeasured"}
    assert gauges[0] == gauges[1]
    assert gauges[0]["device/exposed_exchange_fraction"] == \
        pytest.approx(0.5)
    with pytest.raises(FileNotFoundError, match="chrome trace"):
        attribution.find_trace_file(str(tmp_path / "empty"))


def test_cpu_capture_of_a_fit_attributes_its_steps(tmp_path):
    """A real `torch.profiler` capture (`utils.profiling.trace` on the CPU)
    of a small `fit`: the capture lands where `find_trace_file` looks,
    each thread's top-level operators stand in for device ops, every step
    span has time, and the sum identity is exact."""
    from test_torch_lookahead import TinyModel, _batches
    reg = obs.MetricRegistry()
    with profiling.trace(str(tmp_path), device="cpu"):
        fit(TinyModel(), iter(_batches(3)), 3, "adagrad", lr=0.05,
            registry=reg, log_every=0)
    att = attribution.attribute_logdir(str(tmp_path), registry=reg)
    assert att["trace_file"].endswith(".trace.json.gz")
    assert att["op_source"] == "cpu_ops" and att["device_op_count"] > 0
    ns = att["ns"]
    assert sum(ns["spans"].values()) + ns["unattributed"] == ns["total"]
    assert att["spans"]["train/step/update/xla"] > 0
    assert att["coverage_frac"] > 0
    assert att["collectives"] == 0 and att["launch_matched"] > 0
    g = reg.snapshot()["gauges"]
    assert g["device/total_seconds"] == att["total_device_seconds"]


# ----------------------------------------------------- fleet instants
def _instants(doc):
    return [(e["name"], e.get("args")) for e in doc["traceEvents"]
            if e["ph"] == "i"]


def test_fleet_instants_match_the_jax_fleet(tmp_path):
    """join / enter / leave and canary promote / rollback land on the
    recorder with the JAX package's names and arguments."""
    from distributed_embeddings_tpu.fleet import FleetRouter as JaxRouter
    from distributed_embeddings_tpu.obs.registry import (
        MetricRegistry as JaxRegistry)
    from test_torch_fleet import SPECS as FLEET_SPECS
    from test_torch_fleet import _Pub, _fleet, _jax_engine
    rng = np.random.RandomState(0)
    pub = _Pub(str(tmp_path / "pub"))
    w1 = [rng.randn(v, w).astype(np.float32) * 0.1
          for v, w, _ in FLEET_SPECS]
    pub.publish(w1)
    obs.reset_default_recorder()
    jobs.reset_default_recorder()
    router = _fleet(obs.MetricRegistry(), pub, n=2)
    jrouter = _fleet(JaxRegistry(), pub, n=2, make=_jax_engine,
                     router=JaxRouter)
    for r in (router, jrouter):
        assert r.step()["event"]["event"] == "promote"
    bad = pub.publish([w + 1.5 for w in w1])
    pub.bad.add(bad)
    for r in (router, jrouter):
        assert r.step()["event"]["event"] == "rollback"
        r.remove_replica("r1")
    mine = _instants(obs.default_recorder().to_chrome_trace())
    want = _instants(jobs.default_recorder().to_chrome_trace())
    assert mine == want
    assert [n for n, _ in mine] == [
        "fleet/replica_join", "fleet/replica_enter", "fleet/replica_join",
        "fleet/replica_enter", "fleet/canary_promote",
        "fleet/canary_rollback", "fleet/replica_leave"]


# ---------------------------------------------------------- postmortem
def _flaky_polls(monkeypatch, fail_at):
    """`DeltaConsumer.poll` raising OSError at the given calls (the JAX
    test's ``consumer.poll`` fault plan; the port's fault seams are
    ROADMAP A15b)."""
    calls = {"n": 0}
    real = DeltaConsumer.poll

    def poll(self, upto=None):
        n = calls["n"]
        calls["n"] += 1
        if n in fail_at:
            raise OSError(f"injected transient error #{n}")
        return real(self, upto)
    monkeypatch.setattr(DeltaConsumer, "poll", poll)


def _published(d):
    rng = np.random.RandomState(5)
    pub = _layer()
    pub.set_weights(_weights(rng))
    store = TableStore(pub)
    store.commit()
    store.publish(d)
    return rng


def test_degraded_entry_dumps_postmortem_artifact(tmp_path, monkeypatch):
    """Entering a degraded state writes the artifact (ring, snapshot,
    context) once per activation: healthy -> degraded -> degraded ->
    healthy -> degraded dumps twice, as the JAX engine does under its
    fault plan."""
    d = str(tmp_path / "pub")
    _published(d)
    obs.reset_default_recorder()
    reg = obs.MetricRegistry()
    served = _layer()
    served.set_weights(_zeros())
    eng = InferenceEngine(served, device="cpu", registry=reg,
                          postmortem_dir=str(tmp_path / "pm"))
    _flaky_polls(monkeypatch, (0, 1, 3))
    counts = []
    for _ in range(4):
        eng.poll_updates(d)
        counts.append((len(eng.postmortems), eng.degraded_reasons()))

    monkeypatch.setenv("DET_OBS_POSTMORTEM_DIR", str(tmp_path / "jpm"))
    jobs.reset_default_recorder()
    jreg = jobs.MetricRegistry()
    jserved = _jax_layer()
    jeng = JaxEngine(jserved, jserved.set_weights(_zeros()), registry=jreg)
    jcounts = []
    plan = faults.FaultPlan([{"point": "consumer.poll", "kind": "io_error",
                              "at": [0, 1, 3]}])
    with faults.use_plan(plan):
        for _ in range(4):
            jeng.poll_updates(d)
            jcounts.append((len(jeng.postmortems),
                            jeng.degraded_reasons()))
    assert counts == jcounts
    assert [c for c, _ in counts] == [1, 1, 1, 2]
    assert len(set(eng.postmortems)) == 2
    doc = json.load(open(eng.postmortems[0]))
    jdoc = json.load(open(jeng.postmortems[0]))
    assert doc["reason"] == jdoc["reason"] == "degraded:poll_error"
    assert doc["snapshot"]["gauges"][
        "serve/degraded{reason=poll_error}"] == 1
    assert doc["extra"]["publish_dir"] == d
    assert set(doc) == set(jdoc) and set(doc["extra"]) == set(jdoc["extra"])
    marks = [e for e in doc["trace"]["traceEvents"]
             if e.get("name") == "serve/degraded_entry"]
    assert marks and marks[0]["args"]["reason"] == "poll_error"
    key = "obs/postmortems_total"
    assert reg.counter(key, reason="degraded_poll_error").value == 2 == \
        jreg.counter(key, reason="degraded_poll_error").value


def test_postmortem_not_dumped_without_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "pub")
    _published(d)
    served = _layer()
    served.set_weights(_zeros())
    eng = InferenceEngine(served, device="cpu")
    _flaky_polls(monkeypatch, (0,))
    eng.poll_updates(d)
    assert eng.degraded_reasons() == frozenset({"poll_error"})
    assert eng.postmortems == []
    assert not os.path.exists(str(tmp_path / "pm"))


# --------------------------------------------- registry export satellites
def test_export_jsonl_flushes_per_line_and_fsyncs_final(tmp_path):
    reg = obs.MetricRegistry()
    reg.counter("n").inc()
    path = str(tmp_path / "m.jsonl")
    reg.export_jsonl(path)
    reg.export_jsonl(path, extra={"source": "final"}, fsync=True)
    lines = [json.loads(ln) for ln in open(path)]
    assert len(lines) == 2 and lines[1]["source"] == "final"


def test_prometheus_label_values_escaped():
    def drive(o):
        reg = o.MetricRegistry()
        reg.gauge("serve/degraded", reason='C:\\tmp\\"bad"\nfile').set(1)
        reg.counter("ok", plain="simple").inc()
        return reg.to_prometheus()
    text = drive(obs)
    assert text == drive(jobs)
    line = [ln for ln in text.splitlines()
            if ln.startswith("serve_degraded{")][0]
    assert line == ('serve_degraded{reason="C:\\\\tmp\\\\\\"bad\\"'
                    '\\nfile"} 1.0')
    assert "\n\n" not in text
    for ln in text.splitlines():
        if ln.startswith("#"):
            continue
        assert re.match(r'^[a-zA-Z0-9_:]+(\{([a-zA-Z0-9_]+="(\\.|[^"\\])*")'
                        r'(,[a-zA-Z0-9_]+="(\\.|[^"\\])*")*\})? \S+$', ln), ln


# --------------------------------------------------------------- catalog
# families the JAX package emits too that docs/observability.md's catalog
# does not list (each is checked against the JAX sources below)
CATALOG_GAPS = {"serve/cache_bypassed_buckets", "lookahead/patched_samples_max"}


def _jax_sources() -> str:
    out = []
    for dirpath, _, files in os.walk(os.path.join(
            REPO, "distributed_embeddings_tpu")):
        out += [open(os.path.join(dirpath, f)).read() for f in files
                if f.endswith(".py")]
    return "\n".join(out)


def test_every_exported_family_is_in_the_catalog(tmp_path):
    """A composed run (fit publishing under a vocabulary manager and
    lookahead's engine, an engine consuming the stream and serving
    through a batcher, a device-time attribution) exports only families
    that docs/observability.md catalogs, or that the JAX package emits
    uncatalogued as well."""
    from test_torch_lookahead import SPECS, TinyModel, _batches
    from distributed_embeddings_tpu_torch.vocab import VocabManager

    class SlackModel(TinyModel):
        def __init__(self):
            torch.nn.Module.__init__(self)
            self.embedding = DistributedEmbedding(
                [Embedding(v, w, combiner=c, device="meta")
                 for v, w, c in SPECS], device="cpu", vocab_slack=8)
            self.head = torch.nn.Parameter(torch.full(
                (sum(w for _, w, _ in SPECS), 1), 0.1))

    reg = obs.MetricRegistry()
    d = str(tmp_path / "pub")
    model = SlackModel()
    raw = []
    for num, cats, labels in _batches(4):
        cats = [(c[0] + 10**6, c[1]) if isinstance(c, tuple)
                else c + 10**6 for c in cats]
        raw.append((num, cats, labels))
    mgr = VocabManager(model.embedding, admit_threshold=1,
                       use_native=False)
    with profiling.trace(str(tmp_path / "prof"), device="cpu"):
        fit(model, iter(raw), 4, "adagrad", lr=0.05, registry=reg,
            store=TableStore(model.embedding), publish_every=2,
            publish_dir=d, vocab=mgr, vocab_every=2, log_every=0)
    fit(TinyModel(), iter(_batches(2)), 2, "adagrad", lr=0.05,
        registry=reg, lookahead=1, log_every=0)
    attribution.attribute_logdir(str(tmp_path / "prof"), registry=reg)
    served = SlackModel()
    eng = InferenceEngine(served.embedding, device="cpu", registry=reg)
    eng.poll_updates(d)
    batcher = MicroBatcher(eng, registry=reg)
    batcher.submit([np.asarray(c[0] if isinstance(c, tuple) else c)
                    for c in _batches(1)[0][1]])
    batcher.flush()
    snap = reg.snapshot()
    families = {k.split("{")[0] for kind in snap.values() for k in kind}
    doc = open(os.path.join(REPO, "docs", "observability.md")).read()

    def cataloged(family):
        if re.search(r"`" + re.escape(family) + r"[`{\[]", doc):
            return True
        return f"`{family.split('/')[0]}/*`" in doc

    missing = sorted(f for f in families if not cataloged(f))
    assert set(missing) <= CATALOG_GAPS, missing
    sources = _jax_sources()
    assert all(f'"{f}"' in sources for f in CATALOG_GAPS)
    for family in ("train/steps", "ingest/stage_seconds", "store/publishes",
                   "store/applies", "vocab/admissions", "exchange/ratio",
                   "kernels/gate_verdict", "lookahead/steps",
                   "device/total_seconds", "serve/request_seconds",
                   "span_seconds"):
        assert family in families, family
