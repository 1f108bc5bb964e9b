"""The port's telemetry (`distributed_embeddings_tpu_torch.obs`) against the
JAX package's, case for case with tests/test_obs.py: the metric registry,
the spans, the SLO rules, `fit(registry=)`; and
`DistributedEmbedding.exchange_padding_report` with its ``exchange/*``
gauges against tests/test_exchange.py's plans at world 1 (world 2 and 4:
`tests/test_torch_multigpu.py`'s placement cases).

The same operations go into a registry of each package: snapshots,
JSONL lines (less their timestamps) and Prometheus text are equal; SLO
findings are equal field for field; the reports are equal, not close.
`fit` runs tests/test_schedule.py's model in both packages (the JAX one
on a 1-device mesh) with numpy-seeded batches: equal counters and
``exchange/*`` gauges, the same snapshot keys less the documented
exception (lookahead's compile gauges, which eager PyTorch has no
counterpart of); both CPU runs label their update span "xla".
"""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_embeddings_tpu import obs as jobs  # noqa: E402
from distributed_embeddings_tpu import training as jtraining  # noqa: E402
from distributed_embeddings_tpu.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.layers.embedding import (  # noqa: E402
    Embedding as JaxEmbedding)
from distributed_embeddings_tpu.obs.registry import (  # noqa: E402
    LatencyHistogram as JaxHistogram)
from distributed_embeddings_tpu.parallel.mesh import create_mesh  # noqa: E402
from distributed_embeddings_tpu_torch import obs  # noqa: E402
from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (  # noqa: E402
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.layers.embedding import Embedding  # noqa: E402
from distributed_embeddings_tpu_torch.obs.registry import LatencyHistogram  # noqa: E402
from distributed_embeddings_tpu_torch.training import fit  # noqa: E402

from test_schedule import TinyModel as JaxTinyModel  # noqa: E402
from test_torch_lookahead import TinyModel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_RULES = os.path.join(REPO, "distributed_embeddings_tpu_torch", "tools",
                          "slo_tier1.json")
JAX_RULES = os.path.join(REPO, "tools", "slo_tier1.json")
# the JAX tier-1 rules whose metric the port cannot produce: eager PyTorch
# compiles nothing; the audit is ROADMAP A15d
DROPPED_RULES = {"one-prefetch-compile", "one-fused-compile",
                 "zero-audit-findings"}


def _both(drive):
    """`drive(obs_module)` on a fresh registry of each package: (port's,
    JAX's)."""
    return drive(obs), drive(jobs)


# ------------------------------------------------------------- registry
def _families(o):
    reg = o.MetricRegistry()
    c = reg.counter("train/steps")
    c.inc()
    c.inc(3)
    reg.gauge("vocab/occupancy", table=0).set(0.5)
    reg.gauge("vocab/occupancy", table=1).set(0.9)
    h = reg.histogram("serve/request_seconds")
    for v in (0.001, 0.002, 0.0035, 0.2):
        h.record(v)
    return reg


def test_registry_families_and_identity():
    reg = obs.MetricRegistry()
    c = reg.counter("train/steps")
    c.inc()
    c.inc(3)
    assert reg.counter("train/steps") is c and c.value == 4
    g0 = reg.gauge("vocab/occupancy", table=0)
    g1 = reg.gauge("vocab/occupancy", table=1)
    assert g0 is not g1
    h = reg.histogram("serve/request_seconds")
    assert isinstance(h, LatencyHistogram)
    assert reg.histogram("serve/request_seconds") is h
    mine, ref = _both(_families)
    assert mine.snapshot() == ref.snapshot()


def _conflict(o):
    reg = o.MetricRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered") as e:
        reg.gauge("x")
    return str(e.value)


def test_registry_kind_conflict_raises():
    mine, ref = _both(_conflict)
    assert mine == ref


def _layouts(o):
    reg = o.MetricRegistry()
    reg.histogram("h", bins_per_decade=32)
    msgs = []
    for kw in (dict(bins_per_decade=8), dict(hi=1.0)):
        with pytest.raises(ValueError, match="bucket layout") as e:
            reg.histogram("h", **kw)
        msgs.append(str(e.value))
    assert reg.histogram("h") is reg.histogram("h")
    return msgs


def test_registry_histogram_layout_first_wins():
    mine, ref = _both(_layouts)
    assert mine == ref


def _flat(o):
    reg = o.MetricRegistry()
    reg.counter("a/b").inc(2)
    reg.gauge("g", table=3, stage="x").set(1.5)
    reg.histogram("lat").record(0.01)
    return reg.snapshot()


def test_snapshot_schema_and_flat_keys():
    mine, ref = _both(_flat)
    assert mine == ref
    assert mine["counters"] == {"a/b": 2}
    assert mine["gauges"] == {"g{stage=x,table=3}": 1.5}
    assert mine["histograms"]["lat"]["count"] == 1


def test_jsonl_export_appends_parseable_lines(tmp_path):
    def drive(o):
        reg = o.MetricRegistry()
        reg.counter("n").inc()
        path = str(tmp_path / f"{o.__name__}.jsonl")
        reg.export_jsonl(path, extra={"source": "test"})
        reg.counter("n").inc()
        reg.export_jsonl(path, fsync=True)
        lines = [json.loads(ln) for ln in open(path)]
        assert all("ts" in ln for ln in lines)
        return [{k: v for k, v in ln.items() if k != "ts"} for ln in lines]
    mine, ref = _both(drive)
    assert mine == ref and len(mine) == 2
    assert mine[0]["source"] == "test" and mine[1]["counters"]["n"] == 2


def test_prometheus_dump():
    def drive(o):
        reg = o.MetricRegistry()
        reg.counter("train/steps").inc(7)
        reg.gauge("vocab/occupancy", table=0).set(0.25)
        reg.gauge("serve/degraded", reason='C:\\tmp\\"bad"\nfile').set(1)
        h = reg.histogram("serve/request_seconds")
        for _ in range(10):
            h.record(0.002)
        return reg.to_prometheus()
    mine, ref = _both(drive)
    assert mine == ref
    assert "train_steps_total 7" in mine
    assert 'vocab_occupancy{table="0"} 0.25' in mine
    assert "serve_request_seconds_count 10" in mine


def test_default_registry_process_local():
    obs.reset_default_registry()
    try:
        a = obs.default_registry()
        assert obs.default_registry() is a
        a.counter("x").inc()
        obs.reset_default_registry()
        assert obs.default_registry() is not a
    finally:
        obs.reset_default_registry()


def test_latency_histogram_merge_matches_concatenated_samples():
    """merge(a, b) equals the histogram of the concatenated samples (the
    bucket counts, every percentile, the max) and the JAX package's merge
    of the same streams."""
    rng = np.random.RandomState(7)
    for trial in range(5):
        s1 = 10.0 ** rng.uniform(-6.5, 2.5, size=rng.randint(1, 400))
        s2 = 10.0 ** rng.uniform(-6.5, 2.5, size=rng.randint(1, 400))
        out = {}
        for cls in (LatencyHistogram, JaxHistogram):
            a, b, ref = cls(), cls(), cls()
            for v in s1:
                a.record(v)
            for v in s2:
                b.record(v)
            for v in np.concatenate([s1, s2]):
                ref.record(v)
            merged = a.merge(b)
            assert merged is a
            np.testing.assert_array_equal(merged._counts, ref._counts)
            for p in (1, 25, 50, 90, 95, 99, 100):
                assert merged.percentile(p) == ref.percentile(p), (trial, p)
            assert merged._max == ref._max
            out[cls] = merged
        mine, want = out[LatencyHistogram], out[JaxHistogram]
        np.testing.assert_array_equal(mine._counts, want._counts)
        assert mine.summary() == want.summary()


def test_latency_histogram_merge_layout_mismatch_raises():
    msgs = []
    for cls in (LatencyHistogram, JaxHistogram):
        with pytest.raises(ValueError, match="bucket layouts") as e:
            cls().merge(cls(bins_per_decade=8))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------------- spans
def _nested(o):
    reg = o.MetricRegistry()
    with o.span("train", reg):
        assert o.current_span() == "train"
        with o.span("step", reg) as path:
            assert path == "train/step"
            assert o.current_span() == "train/step"
    assert o.current_span() is None
    return {k: v["count"] for k, v in reg.snapshot()["histograms"].items()}


def test_spans_nest_paths_and_record():
    mine, ref = _both(_nested)
    assert mine == ref == {"span_seconds{span=train}": 1,
                           "span_seconds{span=train/step}": 1}


def test_span_records_on_exception():
    reg = obs.MetricRegistry()
    with pytest.raises(RuntimeError):
        with obs.span("boom", reg):
            raise RuntimeError("x")
    assert reg.histogram("span_seconds", span="boom").count == 1
    assert obs.current_span() is None


def test_span_stack_is_thread_local():
    reg = obs.MetricRegistry()
    seen = {}

    def worker():
        with obs.span("worker", reg):
            seen["inner"] = obs.current_span()

    with obs.span("outer", reg):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["inner"] == "worker"
    assert reg.histogram("span_seconds", span="worker").count == 1


# ------------------------------------------------------------------- slo
def _snap(**over):
    base = {"counters": {"train/steps": 8},
            "gauges": {"lookahead/compiles{stage=fused}": 1.0},
            "histograms": {"serve/request_seconds": {
                "count": 10, "mean_ms": 1.0, "p50_ms": 1.0,
                "p95_ms": 2.0, "p99_ms": 3.0, "max_ms": 4.0}}}
    base.update(over)
    return base


def _findings(rules, snaps):
    mine, ref = _both(lambda o: o.evaluate_rules(rules, snaps))
    assert [f.to_dict() for f in mine] == [f.to_dict() for f in ref]
    return mine


def test_slo_green_and_violation():
    rules = [{"name": "one-compile",
              "metric": "lookahead/compiles{stage=fused}",
              "op": "==", "threshold": 1},
             {"name": "p99", "metric": "serve/request_seconds:p99_ms",
              "op": "<=", "threshold": 5}]
    assert _findings(rules, _snap()) == []
    bad = _snap(gauges={"lookahead/compiles{stage=fused}": 2.0})
    findings = _findings(rules, bad)
    assert len(findings) == 1
    f = findings[0]
    assert f.pass_name == "slo" and f.fid == "slo:one-compile"
    assert f.severity == "error" and "2" in f.message
    assert obs.summarize(findings) == jobs.summarize(
        jobs.evaluate_rules(rules, bad))


def test_slo_absent_metric_is_a_finding():
    rules = [{"name": "occ", "metric": "vocab/occupancy", "op": "<=",
              "threshold": 0.9}]
    assert [f.fid for f in _findings(rules, _snap())] == ["slo:occ:absent"]


def test_slo_window_over_snapshot_sequence():
    rules = [{"name": "p99", "metric": "serve/request_seconds:p99_ms",
              "op": "<=", "threshold": 5, "window": 2}]
    spike = _snap(histograms={"serve/request_seconds": {
        "count": 10, "mean_ms": 1.0, "p50_ms": 1.0, "p95_ms": 2.0,
        "p99_ms": 50.0, "max_ms": 60.0}})
    assert _findings(rules, [spike, _snap(), _snap()]) == []
    assert len(_findings(rules, [_snap(), _snap(), spike])) == 1


def test_slo_malformed_rules_raise():
    cases = [([{"metric": "x", "op": "==", "threshold": 1}], "missing"),
             ([{"name": "n", "metric": "x", "op": "~", "threshold": 1}],
              "op"),
             ([{"name": "n", "metric": "serve/request_seconds", "op": "<=",
                "threshold": 1}], "summary field")]
    for rules, match in cases:
        msgs = []
        for o in (obs, jobs):
            with pytest.raises(ValueError, match=match) as e:
                o.evaluate_rules(rules, _snap())
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_slo_load_rules_file(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": [
        {"name": "a", "metric": "train/steps", "op": ">=",
         "threshold": 1}]}))
    rules = obs.load_rules(str(path))
    assert rules == jobs.load_rules(str(path))
    assert obs.evaluate_rules(rules, _snap()) == []


def test_checked_in_tier1_rule_file_is_valid():
    """The port's tier-1 rule file is the JAX package's less the rules
    whose metric it cannot produce, and loads and validates."""
    rules = obs.load_rules(PORT_RULES)
    want = [r for r in jobs.load_rules(JAX_RULES)
            if r["name"] not in DROPPED_RULES]
    assert rules == want and len(rules) >= 6


# ------------------------------------------------------- fit integration
SPECS = [(60, 8, "sum"), (40, 8, "sum"), (500, 16, "mean"), (120, 8, "sum")]
FIT_BATCH = 16
FIT_STEPS = 6
FIT_LR = 0.05


def _fit_batches(seed=2):
    rng = np.random.RandomState(seed)
    return [(np.zeros((FIT_BATCH, 1), np.float32),
             [rng.randint(0, v, size=(FIT_BATCH, 2)).astype(np.int32)
              for v, _, _ in SPECS],
             rng.randn(FIT_BATCH).astype(np.float32))
            for _ in range(FIT_STEPS)]


def _jax_fit(batches, **kw):
    from test_torch_lookahead import _weights
    mesh = create_mesh(jax.devices()[:1])
    jm = JaxTinyModel(mesh, specs=SPECS)
    w, head = _weights(SPECS)
    params = {"embedding": jm.embedding.set_weights(w),
              "head": {"w": jnp.asarray(head)}}
    reg = jobs.MetricRegistry()
    _, _, hist = jtraining.fit(
        jm, params, iter(batches), steps=len(batches), optimizer="adagrad",
        lr=FIT_LR, log_every=0, registry=reg, **kw)
    return hist, reg


def _port_fit(batches, **kw):
    model = TinyModel(SPECS)
    reg = obs.MetricRegistry()
    _, _, hist = fit(model, iter(batches), len(batches), "adagrad",
                     lr=FIT_LR, log_every=0, registry=reg, **kw)
    return hist, reg, model


def _keys(snap, drop=()):
    return {(kind, k) for kind, d in snap.items() for k in d
            if not any(k.startswith(p) for p in drop)}


@pytest.mark.parametrize("lookahead", [0, 1])
def test_fit_reports_through_one_registry(lookahead):
    """`fit(registry=)` in both packages on the same model and batches:
    the same snapshot keys less the documented exceptions, equal counters
    and ``exchange/*`` and ``kernels/*`` gauges, equal losses (rtol 1e-5),
    and the history's snapshot is the registry's."""
    batches = _fit_batches()
    jhist, jreg = _jax_fit(batches, lookahead=lookahead)
    hist, reg, _ = _port_fit(batches, lookahead=lookahead)
    snap, jsnap = hist["metrics_snapshot"], jhist["metrics_snapshot"]
    assert snap == reg.snapshot() and "metrics_error" not in hist
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    assert snap["counters"] == jsnap["counters"]
    assert snap["counters"]["train/steps"] == FIT_STEPS
    assert snap["counters"]["train/examples"] == FIT_STEPS * FIT_BATCH
    for key in jsnap["gauges"]:
        if key.startswith(("exchange/", "kernels/", "lookahead/patched")):
            assert snap["gauges"][key] == jsnap["gauges"][key], key
    update = "span_seconds{span=train/step/update/"
    assert _keys(snap) == _keys(jsnap, ("lookahead/compiles",))
    assert snap["histograms"][f"{update}xla}}"]["count"] == FIT_STEPS
    assert jsnap["histograms"][f"{update}xla}}"]["count"] == FIT_STEPS
    assert snap["histograms"]["span_seconds{span=train/step}"][
        "count"] == FIT_STEPS
    assert (hist["ingest_stages"]["read"]
            == snap["histograms"]["ingest/stage_seconds{stage=read}"])
    assert snap["gauges"]["train/examples_per_sec"] > 0
    # a CPU run loads no kernel library: every verdict "never loaded"
    assert {k: v for k, v in snap["gauges"].items()
            if k.startswith("kernels/")} == {
        f"kernels/gate_verdict{{impl={i}}}": -1
        for i in ("pallas", "pallas-dma", "tiled")}


class _Table:
    """A table's device and shape, as `update_family` reads them."""

    def __init__(self, device, rows, width):
        self.device, self.shape = torch.device(device), (rows, width)


def test_update_label_names_the_route_each_table_takes():
    """The ``update/<impl>`` label follows the route a table's update
    takes, not a constant: on the CPU "xla" (plain PyTorch, the JAX
    package's CPU label); on the card "xla" for a table the "auto" route
    aggregates densely (`index_add_`), "pallas" for the deduplicated rows
    (and every quantized bucket), "tiled" for the raw stream; the buckets'
    families joined, so full Tiny on the card reads "pallas+xla"."""
    from types import SimpleNamespace
    from distributed_embeddings_tpu_torch.ops.sparse_update import (
        DENSE_ELEMS_MAX, update_family)
    from distributed_embeddings_tpu_torch.training import update_impl_label
    small = ("cuda", 1000, 16)
    big = ("cuda", DENSE_ELEMS_MAX // 16 + 1, 16)
    assert update_family("adagrad", "auto", _Table("cpu", *big[1:])) == "xla"
    assert update_family("adagrad", "auto", _Table(*small)) == "xla"
    assert update_family("adagrad", "auto", _Table(*big)) == "pallas"
    assert update_family("adam", "tiled", _Table(*small)) == "tiled"
    assert update_family("sgd", "auto", _Table(*small)) == "pallas"
    assert update_family("sgd", "dense", _Table(*big)) == "xla"
    assert update_family("adagrad", "auto", _Table(*small),
                         quantized=True) == "pallas"

    def model(*tables, row=()):
        buckets = [SimpleNamespace(storage_dtype="f32") for _ in tables]
        return SimpleNamespace(embedding=SimpleNamespace(
            tp=[_Table(*t) for t in tables], row=[_Table(*t) for t in row],
            plan=SimpleNamespace(tp_buckets=buckets)))
    assert update_impl_label(model(small, big), "adagrad") == "pallas+xla"
    assert update_impl_label(model(big, row=[big]), "adagrad") == "pallas"
    assert update_impl_label(model(("cpu", 10, 4)), "adagrad") == "xla"
    assert update_impl_label(model(), "adagrad") == "xla"


def test_fit_exports_jsonl_and_trace(tmp_path):
    """`obs_export` / `obs_trace` (the JAX package's DET_OBS_EXPORT and
    DET_OBS_TRACE): one fsynced JSONL line of the final snapshot, and the
    flight recorder's window with the run's step spans."""
    obs.reset_default_recorder()
    export, trace = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    hist, _, _ = _port_fit(_fit_batches()[:2], obs_export=export,
                           obs_trace=trace)
    (line,) = [json.loads(ln) for ln in open(export)]
    assert line["source"] == "fit"
    assert {k: line[k] for k in ("counters", "gauges", "histograms")} == \
        hist["metrics_snapshot"]
    doc = json.load(open(trace))
    begins = [e["name"] for e in doc["traceEvents"] if e["ph"] == "B"]
    assert begins.count("train/step") == 2
    assert begins.count("train/step/update/xla") == 2


# ---------------------------------------- exchange_padding_report parity
EX_SPECS = [(96, 8, "sum"), (50, 8, "sum"), (100, 16, "sum"),
            (120, 8, "sum")]
HOT_SPECS = [(500, 8, "sum")] + [(100 + i, 8, None) for i in range(7)]


def _jumbo(port: bool, strategy):
    """tests/test_exchange.py's jumbo plan with its rows cut to 1,000 a
    table (the port allocates its tables; the report reads the plan)."""
    if port:
        from distributed_embeddings_tpu_torch.models import synthetic as syn
    else:
        from distributed_embeddings_tpu.models import synthetic as syn
    cfg = syn.SYNTHETIC_MODELS["jumbo"]
    cfg = cfg._replace(embedding_configs=[
        e._replace(num_rows=min(e.num_rows, 1000))
        for e in cfg.embedding_configs])
    if port:
        return syn.SyntheticModel(cfg, device="cpu",
                                  strategy=strategy).embedding
    return syn.SyntheticModel(cfg, mesh=create_mesh(jax.devices()[:1]),
                              strategy=strategy).embedding


def _layer(port: bool, specs, **kw):
    if port:
        return DistributedEmbedding(
            [Embedding(v, w, combiner=c, device="meta")
             for v, w, c in specs], device="cpu", **kw)
    return JaxDistributedEmbedding(
        [JaxEmbedding(v, w, combiner=c) for v, w, c in specs],
        mesh=create_mesh(jax.devices()[:1]), **kw)


def _vocab_layer(port: bool):
    """A slack plan under a manager with a live binding and evictions
    (tests/test_exchange.py `test_vocab_occupancy_report_schema`)."""
    if port:
        from distributed_embeddings_tpu_torch.vocab import VocabManager
    else:
        from distributed_embeddings_tpu.vocab import VocabManager
    layer = _layer(port, EX_SPECS, input_max_hotness=[4] * 4,
                   vocab_slack=16)
    mgr = VocabManager(layer, admit_threshold=1, use_native=False)
    mgr.vocabs[0].bind([10**9, 10**9 + 1, 10**9 + 2])
    mgr.maintain_cycles = 2
    mgr.vocabs[0].evictions = 4
    return layer, dict(vocab=mgr)


REPORT_CASES = {
    "jumbo_auto": (lambda port: (_jumbo(port, "auto"), {})),
    "jumbo_memory_balanced": (
        lambda port: (_jumbo(port, "memory_balanced"), {})),
    "bf16_wire": (lambda port: (_layer(
        port, EX_SPECS, exchange_wire="bf16",
        input_max_hotness=[4] * 4), {})),
    "touched_batch": (lambda port: (_layer(
        port, EX_SPECS, input_max_hotness=[4] * 4), dict(batch=10**6))),
    "hot_rows": (lambda port: (_layer(
        port, HOT_SPECS, hot_rows=64, input_max_hotness=[4] + [1] * 7),
        {})),
    "hot_rows_rate": (lambda port: (_layer(
        port, HOT_SPECS, hot_rows=64, input_max_hotness=[4] + [1] * 7),
        dict(hot_hit_rate=0.5))),
    "int8_delta": (lambda port: (_layer(
        port, EX_SPECS, input_max_hotness=[4] * 4),
        dict(delta_dtype="int8"))),
    "lookahead": (lambda port: (_layer(
        port, EX_SPECS, input_max_hotness=[4] * 4),
        dict(lookahead=1, batch=64))),
    "vocab": _vocab_layer,
}


@pytest.mark.parametrize("case", list(REPORT_CASES))
def test_exchange_report_matches_jax(case):
    """`exchange_padding_report` on tests/test_exchange.py's plans at
    world 1 is the JAX layer's, field for field."""
    build = REPORT_CASES[case]
    layer, kw = build(True)
    jlayer, jkw = build(False)
    got = layer.exchange_padding_report(**kw)
    want = jlayer.exchange_padding_report(**jkw)
    assert got == want
    assert got["exchange_paths"] == {}        # world 1 exchanges nothing


def test_exchange_report_matches_registry_gauges_after_driven_run():
    """The ``exchange/*`` gauges a driven `fit` exports equal a fresh
    `exchange_padding_report` over the same (batch, vocab, lookahead), at
    the top level and per group, and the JAX package's `fit` exports the
    same gauges on the same model, keys and cycles."""
    from distributed_embeddings_tpu.vocab import VocabManager as JaxManager
    from distributed_embeddings_tpu_torch.obs.instrument import (
        EXCHANGE_GAUGE_FIELDS, EXCHANGE_GROUP_GAUGE_FIELDS)
    from distributed_embeddings_tpu_torch.vocab import VocabManager

    sizes = [(48, 8), (32, 8), (100, 8), (64, 8)]
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(6):
        cats = [rng.randint(10**8, 10**8 + 40, size=(16, 2)).astype(
            np.int64) for _ in sizes]
        batches.append((np.zeros((16, 1), np.float32), cats,
                        rng.randn(16).astype(np.float32)))

    class _Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = DistributedEmbedding(
                [Embedding(v, w, combiner="sum", device="meta")
                 for v, w in sizes], device="cpu",
                strategy="memory_balanced", vocab_slack=16)

        def loss_fn(self, numerical, cats, labels, taps=None,
                    return_residuals=False):
            out = self.embedding(list(cats), taps=taps,
                                 return_residuals=return_residuals)
            outs, res = out if return_residuals else (out, None)
            x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], 1)
            loss = torch.mean((x.sum(1) - torch.as_tensor(labels)) ** 2)
            return (loss, res) if return_residuals else loss

    class _Jax:
        def __init__(self):
            self.embedding = JaxDistributedEmbedding(
                [JaxEmbedding(v, w, combiner="sum") for v, w in sizes],
                mesh=create_mesh(jax.devices()[:1]),
                strategy="memory_balanced", vocab_slack=16)

        def loss_fn(self, params, numerical, cats, labels, taps=None,
                    return_residuals=False):
            outs, res = self.embedding.apply(
                params["embedding"], cats, taps=taps,
                return_residuals=True)
            x = jnp.concatenate([o.reshape(o.shape[0], -1) for o in outs],
                                axis=1)
            loss = jnp.mean((jnp.sum(x, axis=1) - labels.reshape(-1)) ** 2)
            return (loss, res) if return_residuals else loss

    model = _Port()
    mgr = VocabManager(model.embedding, admit_threshold=1, decay=0.99,
                       use_native=False)
    reg = obs.MetricRegistry()
    _, _, hist = fit(model, iter(batches), 6, "adagrad", lr=0.05,
                     vocab=mgr, vocab_every=3, registry=reg, log_every=0)
    assert "metrics_error" not in hist, hist.get("metrics_error")
    gauges = reg.snapshot()["gauges"]
    rep = model.embedding.exchange_padding_report(batch=16, vocab=mgr,
                                                  lookahead=0)
    for field in EXCHANGE_GAUGE_FIELDS:
        assert gauges[f"exchange/{field}"] == rep[field], field
    for gi, entry in enumerate(rep["groups"]):
        for field in EXCHANGE_GROUP_GAUGE_FIELDS:
            key = (f"exchange/{field}"
                   f"{{bucket={entry['bucket']},group={gi}}}")
            assert gauges[key] == entry[field], key
    assert 0.0 < gauges["exchange/occupancy"] < 1.0
    assert gauges["exchange/touched_rows_per_step"] > 0

    jm = _Jax()
    jmgr = JaxManager(jm.embedding, admit_threshold=1, decay=0.99,
                      use_native=False)
    jreg = jobs.MetricRegistry()
    params = {"embedding": jm.embedding.init(jax.random.PRNGKey(0))}
    jtraining.fit(jm, params, iter(batches), steps=6, optimizer="adagrad",
                  lr=0.05, vocab=jmgr, vocab_every=3, registry=jreg,
                  log_every=0)
    jgauges = jreg.snapshot()["gauges"]
    ex = {k: v for k, v in gauges.items() if k.startswith("exchange/")}
    assert ex == {k: v for k, v in jgauges.items()
                  if k.startswith("exchange/")}
    vocab_keys = {k for k in gauges if k.startswith("vocab/")}
    assert vocab_keys and all(gauges[k] == jgauges[k] for k in vocab_keys)
