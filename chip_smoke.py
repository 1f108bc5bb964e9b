#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root, one H100

Phases, each printing JSON lines before the last line:
  1. device: the card's name and power limit; TF32 off for matmuls and
     convolutions, so float32 means float32.
  2. build: nvcc compiles every kernel of the path from ``csrc/`` (one
     nvcc per source, all at once).
  3. kernel: `lookup_combine` against its plain PyTorch version at the
     zoo's widths (8..256), hotness 1/10/30, sum/mean, weighted (with
     zero-weight slots) and unweighted, int32 and int64 ids, some of them
     out of range or negative. Bit-equal at hotness 1 unweighted, rtol 1e-5
     / atol 1e-6 otherwise (the K-term sum order differs). Tables are drawn
     like the model's (uniform +-0.05).
  4. slice: Tiny V3 at full table size (55 tables, 4.2 GiB) built on the
     card, an InferenceEngine warmed at [4096, 65536], power-law requests
     (alpha 1.05, seed 0) of 1 .. 65536 rows served through `predict` and a
     MicroBatcher flush. The kernel's launch count must rise by exactly 4
     (one per (bucket, hotness) group) per forward. Every output is held
     against a CPU engine built from the same weights (plain lookups) at
     rtol/atol 1e-5. Then the kernel at the two real Tiny buckets and the
     four group shapes of a 65536-row forward: its inputs are captured from
     that forward, checked against the plain version, and timed on the
     device (CUDA graph replays, CUDA events) beside the plain version,
     F.embedding_bag (one library call computing the same function, a
     yardstick only) and the memory bound; ``eager_ms`` is the same kernel
     called back to back from Python, host launch cost included.
     Per-request latency (synchronized), rows/s and peak device memory;
     then one 4096-row and one 65536-row request under torch.profiler:
     the device's busy time and idle share, device time by kernel, host
     time by operator.
  5. the kernels line, the card's line, and the last line
     ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or when the port
is not beside this script.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ["lookup_combine"]
BATCH = 65536
REQUEST_ROWS = (1, 1000, 4096, 30000, 65536)
BATCHER_SPANS = ((0, 100), (100, 2100), (2100, 7100), (7100, 37100))
WARM_SIZES = [4096, 65536]
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
SLICE_TOL = dict(rtol=1e-5, atol=1e-5)
# device memory rate by card (NVIDIA data sheets); float32 outside the
# tensor cores: 67 TFLOP/s (H100 SXM)
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H100", 3.35e12))
F32_FLOP_PER_S = 67e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(**fields):
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _event_ms(run, count):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def eager_ms(fn, reps, warmup=2):
    """Time per call of `fn` called back to back from Python (CUDA events):
    the device time, or the host's launch cost where that is longer."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _event_ms(run, reps)


def device_ms(fn, reps, replays=3):
    """Device time of one `fn` call: `reps` calls captured in one CUDA
    graph, replayed `replays` times (CUDA events), so no host launch cost
    sits between the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def run():
        for _ in range(replays):
            graph.replay()
    ms = _event_ms(run, reps * replays)
    del graph
    return ms


def mean_weights(weights, combiner):
    """The wrapper's mean pre-normalization, for the plain side."""
    if combiner == "mean":
        return weights / weights.sum(dim=1, keepdim=True).clamp_min(1.0)
    return weights


def kernel_cases(torch, cuda_lookup):
    """Phase 3: the kernel against its plain version. Returns the max
    absolute error over all cases."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    vocab, rows = 5000, 777
    worst = 0.0
    for width in (8, 16, 32, 64, 128, 256):
        table = torch.empty((vocab, width), device="cuda").uniform_(
            -0.05, 0.05, generator=gen)
        for hot in (1, 10, 30):
            base = torch.randint(0, vocab, (rows, hot), device="cuda",
                                 generator=gen)
            base[::97, 0] = -1              # negative: clamps to row 0
            base[1::89, -1] = vocab + 5     # past the end: clamps to V-1
            w = torch.rand((rows, hot), device="cuda", generator=gen)
            w[:, 1::3] = 0.0                # zero-weight (padded) slots
            errs = {}
            for id_dtype in (torch.int32, torch.int64):
                ids = base.to(id_dtype)
                cases = [("raw", None, None)]
                for combiner in ("sum", "mean"):
                    cases += [(combiner, None, combiner),
                              (combiner + "_weighted", w, combiner)]
                for name, weights, combiner in cases:
                    if combiner is None:
                        got = cuda_lookup.lookup_combine(table, ids)
                        want = cuda_lookup.lookup_combine_plain(table, ids)
                    else:
                        got = cuda_lookup.fused_embedding_lookup(
                            table, ids, weights, combiner)
                        dense = (torch.ones((rows, hot), device="cuda")
                                 if weights is None else weights)
                        want = cuda_lookup.lookup_combine_plain(
                            table, ids, mean_weights(dense, combiner))
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    # bar: bit-equal at hotness 1 unweighted, else tolerance
                    exact = hot == 1 and weights is None
                    ok = (torch.equal(got, want) if exact
                          else torch.allclose(got, want, **KERNEL_TOL))
                    check(ok, f"kernel disagrees: width {width} hot {hot} "
                              f"{id_dtype} {name}: max abs err {err}")
                    errs[f"{name}/{str(id_dtype).split('.')[-1]}"] = err
                    worst = max(worst, err)
            # one line per (width, hotness): every case's max abs error
            emit(phase="kernel", width=width, hot=hot, ok=True,
                 max_abs_err=errs)
    return worst


def profile_request(torch, engine, request):
    """One synchronized `predict` under torch.profiler: the device's busy
    time (the union of its kernel and copy intervals), its idle share of
    the profiled request, the device time by kernel and the host's self
    time by operator. The profiler's own host cost inflates the wall time,
    so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine.predict(request)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(request)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us, reach = 0.0, None
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in device):
        if reach is None or start >= reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    by_kernel: dict = {}
    for e in device:
        by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                             + e.time_range.elapsed_us())
    top_device = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    host = sorted((a for a in prof.key_averages()
                   if a.self_cpu_time_total > 0),
                  key=lambda a: -a.self_cpu_time_total)[:8]
    measured = bool(device)
    emit(phase="profile", rows=int(request[0].shape[0]),
         wall_ms=wall_us / 1e3, device_events=len(device),
         device_busy_ms=busy_us / 1e3 if measured else None,
         device_idle_share=1 - busy_us / wall_us if measured else None,
         device_ms_by_kernel=[[n[:80], us / 1e3] for n, us in top_device],
         host_self_ms_by_op=[[a.key, a.self_cpu_time_total / 1e3,
                              a.count] for a in host])


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    return HBM_BYTES_PER_S[-1][1]


def tiny_bucket_kernels(torch, cuda_lookup, captured, rate):
    """Phase 4b: the kernel at the real buckets and group shapes captured
    from one 65536-row forward: check, time, bound, yardstick."""
    import torch.nn.functional as F
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                  bytes_ms=0.0, ops_ms=0.0)
    worst = 0.0
    for g, (table, ids, weights) in enumerate(captured):
        n, k = ids.shape
        width = table.shape[1]
        got = cuda_lookup.lookup_combine(table, ids, weights)
        want = cuda_lookup.lookup_combine_plain(table, ids, weights)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        exact = k == 1 and weights is None
        ok = (torch.equal(got, want) if exact
              else torch.allclose(got, want, **KERNEL_TOL))
        check(ok, f"kernel disagrees at Tiny group {g}: max abs err {err}")
        worst = max(worst, err)
        kernel = lambda: cuda_lookup.lookup_combine(table, ids, weights)
        ms = device_ms(kernel, reps=20)
        eager = eager_ms(kernel, reps=20)
        plain_ms = device_ms(
            lambda: cuda_lookup.lookup_combine_plain(table, ids, weights),
            reps=5)
        bag_ids = ids.clamp(0, table.shape[0] - 1)
        library_ms = device_ms(
            lambda: F.embedding_bag(bag_ids, table, mode="sum",
                                    per_sample_weights=weights), reps=20)
        # least bytes: each distinct row this batch touches read once, ids
        # (and weights) read once, the output written once
        unique_rows = int(torch.unique(bag_ids).numel())
        n_bytes = (unique_rows * width * 4 + ids.numel() * ids.element_size()
                   + (0 if weights is None else weights.numel() * 4)
                   + n * width * 4)
        bytes_ms = n_bytes / rate * 1e3
        ops_ms = 2 * n * k * width / F32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        emit(phase="tiny_kernel", group=g, table=list(table.shape),
             ids=list(ids.shape), weighted=weights is not None,
             unique_rows=unique_rows, bytes=n_bytes, max_abs_err=err,
             ms=ms, eager_ms=eager, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound_ms, ok=ok)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound_ms), ("library_ms", library_ms),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            totals[key] += val
    return worst, totals


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import distributed_embeddings_tpu_torch as port
    check(os.path.dirname(os.path.abspath(port.__file__))
          == os.path.join(REPO, "distributed_embeddings_tpu_torch"),
          "the port is not beside this script")
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.ops import cuda_lookup, kernel_build
    from distributed_embeddings_tpu_torch.serving.batcher import MicroBatcher
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)

    # ---- 1. device
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    libs = kernel_build.build(KERNELS)
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p, REPO) for p in libs.values()])

    # ---- 3. kernel against its plain version
    worst = kernel_cases(torch, cuda_lookup)

    # ---- 4. the slice at full width
    torch.cuda.reset_peak_memory_stats()
    tiny = SYNTHETIC_MODELS["tiny"]
    t0 = time.perf_counter()
    model = SyntheticModel(tiny, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
    torch.cuda.synchronize()
    emit(phase="model", config=tiny.name, seconds=time.perf_counter() - t0,
         buckets=[list(t.shape) for t in model.embedding.tp],
         table_bytes=sum(t.numel() * 4 for t in model.embedding.tp))
    engine = InferenceEngine(model, device="cuda")
    engine.warmup(WARM_SIZES)
    num, cats, _ = InputGenerator(tiny, BATCH, alpha=1.05, num_batches=1,
                                  seed=0)[0]
    requests = [(num[:r], [c[:r] for c in cats]) for r in REQUEST_ROWS]
    spans = [(num[lo:hi], [c[lo:hi] for c in cats])
             for lo, hi in BATCHER_SPANS]

    # the main path: counts to 0, drive, read
    cuda_lookup.launches = 0
    outs = [engine.predict(req) for req in requests]
    batcher = MicroBatcher(engine)
    handles = [batcher.submit(req) for req in spans]
    flushed = batcher.flush()
    torch.cuda.synchronize()
    launches = cuda_lookup.launches
    forwards = len(requests) + batcher.batches
    emit(phase="main_path", forwards=forwards, launches=launches,
         launches_per_forward=launches / forwards)
    check(launches == 4 * forwards,
          f"{launches} kernel launches over {forwards} forwards, want 4 each")

    # every output against a CPU engine with the same weights
    t0 = time.perf_counter()
    cpu_model = SyntheticModel(tiny, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    cpu_model.load_state_dict(model.state_dict())
    cpu_engine = InferenceEngine(cpu_model, device="cpu")
    pairs = list(zip(requests, outs)) + [
        (req, flushed[h]) for req, h in zip(spans, handles)]
    slice_err = 0.0
    for req, out in pairs:
        rows = req[0].shape[0]
        want = cpu_engine.predict(req)
        got = out.cpu()
        check(tuple(got.shape) == (rows, 1), f"shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "non-finite logits")
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, **SLICE_TOL)
        emit(phase="slice_check", rows=rows, max_abs_err=err, ok=ok)
        check(ok, f"{rows}-row request disagrees with the CPU engine: {err}")
        slice_err = max(slice_err, err)
    emit(phase="cpu_reference", seconds=time.perf_counter() - t0,
         max_abs_err=slice_err)
    del cpu_engine, cpu_model

    # per-request latency, synchronized
    for req in requests:
        rows = req[0].shape[0]
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            engine.predict(req)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times[2:])
        emit(phase="latency", rows=rows,
             padded_to=engine._target_batch(rows), median_ms=med * 1e3,
             min_ms=min(times[2:]) * 1e3, rows_per_s=rows / med)
    emit(phase="memory",
         max_memory_allocated=torch.cuda.max_memory_allocated())
    for req in (requests[2], requests[-1]):
        profile_request(torch, engine, req)

    # the kernel at the four group shapes of one 65536-row forward
    captured = []
    real = cuda_lookup.lookup_combine

    def capture(table, ids, weights=None):
        captured.append((table, ids, weights))
        return real(table, ids, weights)

    cuda_lookup.lookup_combine = capture
    try:
        engine.predict(requests[-1])
    finally:
        cuda_lookup.lookup_combine = real
    check(len(captured) == 4, f"{len(captured)} groups captured, want 4")
    rate = hbm_rate(name)
    tiny_worst, totals = tiny_bucket_kernels(torch, cuda_lookup, captured,
                                             rate)
    emit(phase="tiny_kernel_total", hbm_bytes_per_s=rate, **totals)

    # ---- 5. result lines
    print(json.dumps({"kernels": [{
        "name": "lookup_combine", "route": "cuda",
        "source": "distributed_embeddings_tpu_torch/csrc/lookup_combine.cu",
        "replaces": "distributed_embeddings_tpu/ops/pallas_lookup.py:116",
        "launches": launches, "max_abs_err": max(worst, tiny_worst),
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("bytes" if totals["bytes_ms"] >= totals["ops_ms"]
                     else "operations"),
        "library_ms": totals["library_ms"]}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
