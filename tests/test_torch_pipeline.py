"""The port's ingest pipeline, prefetch iterator and device stager.

Mirrors tests/test_pipeline.py (its ingest-bench record test aside, which
the JAX package fails and whose bench is ROADMAP A15): worker exceptions
surface at the consumer after the items already produced, shutdown joins
every thread, backpressure bounds the batches in flight, and pipelined
output is bit-identical to serial iteration. Every blocking wait here is
bounded. Plus the prefetch iterator's drain-then-raise tail, and the
stager on the CPU (the pinned, side-stream path runs on the card:
`chip_smoke.py`).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_embeddings_tpu_torch.parallel.staging import (  # noqa: E402
    DeviceStager, StagedBatch, dp_slice, ready, stage_dp_batch)
from distributed_embeddings_tpu_torch.utils.pipeline import (  # noqa: E402
    IngestPipeline, SerialPipeline, staged_batches)
from distributed_embeddings_tpu_torch.utils.prefetch import (  # noqa: E402
    prefetch_to_device)

JOIN_S = 5.0


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield (rng.rand(8, 3).astype(np.float32),
               rng.randint(0, 100, (8, 2)).astype(np.int64))


def _stages():
    return [
        ("preprocess", lambda b: (b[0] * 2.0, b[1].astype(np.int32))),
        ("stage", lambda b: (b[0].copy(), b[1] + 1)),
    ]


def _drain(pipe, got, limit_s=JOIN_S):
    t0 = time.monotonic()
    for item in pipe:
        got.append(item)
        assert time.monotonic() - t0 < limit_s
    return got


def test_pipelined_bit_identical_to_serial():
    serial = list(SerialPipeline(_batches(7), _stages()))
    with IngestPipeline(_batches(7), _stages(), depth=2) as pipe:
        pipelined = _drain(pipe, [])
    assert len(serial) == len(pipelined) == 7
    for (sn, si), (pn, pi) in zip(serial, pipelined):
        np.testing.assert_array_equal(sn, pn)
        np.testing.assert_array_equal(si, pi)
        assert sn.dtype == pn.dtype and si.dtype == pi.dtype


def test_source_exception_surfaces_after_drain():
    def bad_source():
        yield from _batches(3)
        raise ValueError("disk on fire")

    pipe = IngestPipeline(bad_source(), _stages(), depth=2)
    got = []
    with pytest.raises(ValueError, match="disk on fire"):
        _drain(pipe, got)
    assert len(got) == 3
    assert all(not t.is_alive() for t in pipe._threads)


def test_stage_exception_surfaces_within_one_batch():
    calls = {"n": 0}

    def flaky(b):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("bad decode")
        return b

    pipe = IngestPipeline(_batches(10), [("flaky", flaky)], depth=1)
    got = []
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="bad decode"):
        _drain(pipe, got)
    assert len(got) == 2
    assert time.monotonic() - t0 < JOIN_S


def test_close_joins_all_threads_no_leak():
    before = set(threading.enumerate())
    pipe = IngestPipeline(_batches(4), _stages(), depth=2)
    _drain(pipe, [])
    pipe2 = IngestPipeline(_batches(100), _stages(), depth=2)
    next(iter(pipe2))
    pipe2.close()
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
    assert not leaked, f"leaked ingestion threads: {leaked}"
    pipe.close()
    pipe2.close()


def test_backpressure_bounds_in_flight_batches():
    pulled = {"n": 0}

    def counting_source():
        while True:
            pulled["n"] += 1
            yield np.zeros((4,), np.float32)

    depth, nstages = 2, 2
    pipe = IngestPipeline(counting_source(),
                          [("a", lambda x: x), ("b", lambda x: x)],
                          depth=depth)
    next(iter(pipe))
    time.sleep(1.0)    # the consumer stalls: the workers block, not grow
    bound = (nstages + 1) * depth + nstages + 2
    assert pulled["n"] <= bound, (pulled["n"], bound)
    pipe.close()


def test_empty_source_and_no_stages():
    assert _drain(IngestPipeline(iter(()), [("s", lambda x: x)]), []) == []
    assert _drain(IngestPipeline(iter([1, 2, 3]), []), []) == [1, 2, 3]


def test_stage_summaries_account_every_stage():
    pipe = IngestPipeline(_batches(5), _stages(), depth=2)
    _drain(pipe, [])
    s = pipe.stage_summaries()
    assert set(s) == {"read", "preprocess", "stage"}
    assert all(v["count"] == 5 for v in s.values())
    assert all(0 <= v["mean_ms"] <= v["max_ms"] for v in s.values())


def test_stages_run_under_profiler_ranges():
    """Each stage body runs inside its ``ingest/<stage>`` range."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        list(SerialPipeline(_batches(2), _stages()))
    names = {e.name for e in prof.events()}
    assert {"ingest/read", "ingest/preprocess", "ingest/stage"} <= names


def test_staged_batches_serial_vs_pipelined_parity():
    data = [(np.full((2, 2), i, np.float32),) for i in range(5)]
    stage = DeviceStager("cpu").stage
    serial = [ready(b) for b in staged_batches(iter(data), stage,
                                               pipelined=False)]
    pipelined = [ready(b) for b in _drain(
        staged_batches(iter(data), stage, pipelined=True), [])]
    assert len(serial) == len(pipelined) == 5
    for (s,), (p,) in zip(serial, pipelined):
        assert torch.is_tensor(p)
        assert torch.equal(s, p)


def test_order_holds_under_thread_switching():
    """More stage workers than cores, the interpreter switching threads
    every microsecond: every item arrives once, in order, each stage
    applied once."""
    import os
    import sys
    n_stages = (os.cpu_count() or 1) + 2
    stages = [(f"s{i}", lambda x: x + 1) for i in range(n_stages)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = IngestPipeline(iter(range(300)), stages, depth=1)
        got = _drain(pipe, [], limit_s=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert got == [i + n_stages for i in range(300)]
    assert all(not t.is_alive() for t in pipe._threads)


def test_duplicate_stage_names_rejected():
    with pytest.raises(ValueError):
        IngestPipeline(iter(()), [("x", id), ("x", id)])
    with pytest.raises(ValueError):
        IngestPipeline(iter(()), [("read", id)])   # reserved


# ---------------------------------------------------------------- prefetch
def test_prefetch_drains_staged_then_raises():
    staged = []

    def bad_source():
        yield 1
        yield 2
        raise OSError("pread failed")

    it = prefetch_to_device(bad_source(), size=4,
                            stage=lambda x: staged.append(x) or x * 10)
    got = []
    with pytest.raises(OSError, match="pread failed"):
        for v in it:
            got.append(v)
    assert got == [10, 20]
    assert staged == [1, 2]


def test_prefetch_happy_path_order():
    it = prefetch_to_device(iter(range(5)), size=2, stage=lambda x: x + 100)
    assert list(it) == [100, 101, 102, 103, 104]


def test_prefetch_default_stage_takes_the_device():
    got = list(prefetch_to_device(_batches(3), device="cpu"))
    want = list(_batches(3))
    assert len(got) == 3
    for (gn, gi), (wn, wi) in zip(got, want):
        assert torch.equal(gn, torch.from_numpy(wn))
        assert torch.equal(gi, torch.from_numpy(wi))


# ------------------------------------------------------------------ stager
def test_stager_keeps_the_batch_structure_on_the_cpu():
    batch = (np.ones((4, 2), np.float16), [np.arange(4, dtype=np.int8),
                                           (np.zeros(4, np.int32),
                                            np.ones(4, np.float32))],
             {"labels": np.array([True, False, True, True])}, None)
    out = DeviceStager("cpu")(batch)
    assert out[3] is None and isinstance(out[1][1], tuple)
    for got, want in ((out[0], batch[0]), (out[1][0], batch[1][0]),
                      (out[1][1][0], batch[1][1][0]),
                      (out[2]["labels"], batch[2]["labels"])):
        assert torch.equal(got, torch.from_numpy(want))


def test_stage_dp_batch_cuts_this_ranks_slice():
    """At world size 1 the slice is the whole batch, through the stager."""
    batch = (np.arange(12, dtype=np.float32).reshape(6, 2),
             [np.arange(6, dtype=np.int32)])
    got = stage_dp_batch(batch, DeviceStager("cpu"))
    assert torch.equal(got[0], torch.from_numpy(batch[0]))
    assert torch.equal(got[1][0], torch.from_numpy(batch[1][0]))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_dp_slice_takes_the_ranks_block(monkeypatch, rank):
    """Rank r of 3 takes rows [2r, 2r + 2) of every leaf; a batch that
    does not divide by the world raises."""
    from distributed_embeddings_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "rank", lambda: rank)
    monkeypatch.setattr(mesh, "world_size", lambda: 3)
    batch = (np.arange(12, dtype=np.float32).reshape(6, 2),
             [np.arange(6, dtype=np.int32), None])
    got = dp_slice(batch)
    assert torch.equal(got[0], torch.from_numpy(batch[0][2 * rank:
                                                         2 * rank + 2]))
    assert torch.equal(got[1][0], torch.arange(2 * rank, 2 * rank + 2,
                                               dtype=torch.int32))
    assert got[1][1] is None
    with pytest.raises(ValueError, match="not divisible"):
        dp_slice((np.zeros((4, 2)),))


def test_stage_returns_a_batch_that_ready_takes():
    """`stage` hands back a `StagedBatch`; `ready` takes it (once or
    twice alike) and passes a plain stage result through."""
    batch = (np.arange(6, dtype=np.int64), [np.ones((3, 2), np.float32)])
    staged = DeviceStager("cpu").stage(batch)
    assert isinstance(staged, StagedBatch)
    got = ready(staged)
    assert got is ready(staged) is staged.take()
    assert torch.equal(got[0], torch.from_numpy(batch[0]))
    assert torch.equal(got[1][0], torch.from_numpy(batch[1][0]))
    plain = object()
    assert ready(plain) is plain
