#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one H100

Phases, each printing JSON lines before the last line:
  1. device: the card's name and power limit; TF32 off for matmuls and
     convolutions, so float32 means float32.
  2. build: nvcc compiles every kernel of the paths from ``csrc/`` (one
     nvcc per source, all at once): lookup_combine.cu, sparse_apply.cu.
  3. kernel: `lookup_combine` against its plain PyTorch version at the
     zoo's widths (8..256), hotness 1/10/30, sum/mean, weighted (with
     zero-weight slots) and unweighted, int32 and int64 ids, some of them
     out of range or negative. Bit-equal at hotness 1 unweighted, rtol 1e-5
     / atol 1e-6 otherwise (the K-term sum order differs). Tables are drawn
     like the model's (uniform +-0.05).
     sparse_kernel: `segment_sum_sorted` (through `dedup_sum`) and the
     three row kernels against their plain versions at widths 8..256, on
     streams with duplicates, negative ids, ids >= V and the dedup filler
     tail, three accumulating steps each. The segment sum bit-equal to its
     plain version on a CPU copy (both add in sorted order) and within
     atol 1e-6 + rtol 1e-5 of the segment's sum of magnitudes of the card's
     `index_add_` (atomics, another order each run); the row
     kernels bit-equal to their plain versions on the card (else the
     largest ulp difference is printed and rtol 1e-6 holds).
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
  5. train: the same full-size Tiny model and its adagrad accumulators
     (4.49 GB more) trained by `make_sparse_train_step(model, "adagrad",
     lr=0.01)` on power-law batches of 65536 rows (alpha 1.05, seed 0).
     Main path: 3 steps with launches 4 / 2 / 2 per step (lookup_combine /
     segment_sum_sorted / adagrad_rows), each held against a CPU trainer
     (the same weights, plain versions) started from the card's state:
     losses rtol 1e-5; the change of every touched table and accumulator
     element within rtol 1e-4 of it plus one ulp, the MLPs at rtol 1e-4 /
     atol 1e-6; a sample of untouched rows bit-unchanged. Then the median
     of 10 synchronized steps after 2 warm ones, samples/s, peak memory,
     one step under torch.profiler, and the new kernels at the shapes one
     step gives them (the segment sum bit-equal to its plain version on
     CPU copies), timed like phase 4's, with U (unique rows) and the
     longest segment per bucket.
  6. sgd and adam: Tiny with every table cut to at most 100,000 rows
     (widths, hotness, sharing kept), 3 steps each held like phase 5's
     but by value (rtol 1e-4 / atol 1e-6); adam by 1e-2 * lr where the
     step's gradient is a sum that cancels. `sgd_rows` / `adam_rows`
     launch once per bucket per step and are timed at the shapes those
     steps give them.
  7. the kernels line, the card's line, and the last line
     ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or when the port
is not beside this script.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ["lookup_combine", "sparse_apply"]
BATCH = 65536
REQUEST_ROWS = (1, 1000, 4096, 30000, 65536)
BATCHER_SPANS = ((0, 100), (100, 2100), (2100, 7100), (7100, 37100))
WARM_SIZES = [4096, 65536]
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
SLICE_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
# a gradient below this share of the sum of its terms' magnitudes is a sum
# that cancels (`training.gradient_scale`)
ILL_SCALE = 1e-3
TRAIN_LR = 0.01
TRAIN_STEPS = 3
CUT_ROWS = 100_000
UNTOUCHED_SAMPLE = 4096
SPARSE_WIDTHS = (8, 16, 32, 64, 128, 256)
TPU_SITES = {
    "lookup_combine": ["distributed_embeddings_tpu/ops/pallas_lookup.py:116",
                       "distributed_embeddings_tpu/ops/pallas_lookup.py:224"],
    "segment_sum_sorted": ["distributed_embeddings_tpu/ops/sparse_update.py:683 (XLA segment_sum; no TPU kernel)"],
    "sgd_rows": ["distributed_embeddings_tpu/ops/pallas_tiled.py:340",
                 "distributed_embeddings_tpu/ops/pallas_scatter.py:135"],
    "adagrad_rows": ["distributed_embeddings_tpu/ops/pallas_tiled.py:340",
                     "distributed_embeddings_tpu/ops/pallas_scatter.py:244"],
    "adam_rows": ["distributed_embeddings_tpu/ops/pallas_tiled.py:340"],
}
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


def profile_call(torch, fn):
    """One synchronized `fn()` under torch.profiler (after one warm call):
    the device's busy time (the union of its kernel and copy intervals),
    the wall time, the device events and the profiler. The profiler's own
    host cost inflates the wall time, so an idle share from it is an upper
    bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, reach = 0.0, None
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in device):
        if reach is None or start >= reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    return busy_us, wall_us, device, prof


def _by_name(device):
    by_kernel: dict = {}
    for e in device:
        by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                             + e.time_range.elapsed_us())
    return by_kernel


def _host_ops(prof, top=8):
    host = sorted((a for a in prof.key_averages()
                   if a.self_cpu_time_total > 0),
                  key=lambda a: -a.self_cpu_time_total)[:top]
    return [[a.key, a.self_cpu_time_total / 1e3, a.count] for a in host]


def profile_request(torch, engine, request):
    """One synchronized `predict` under torch.profiler: device busy time,
    idle share, device time by kernel, host self time by operator."""
    busy_us, wall_us, device, prof = profile_call(
        torch, lambda: engine.predict(request))
    top_device = sorted(_by_name(device).items(), key=lambda kv: -kv[1])[:8]
    measured = bool(device)
    emit(phase="profile", rows=int(request[0].shape[0]),
         wall_ms=wall_us / 1e3, device_events=len(device),
         device_busy_ms=busy_us / 1e3 if measured else None,
         device_idle_share=1 - busy_us / wall_us if measured else None,
         device_ms_by_kernel=[[n[:80], us / 1e3] for n, us in top_device],
         host_self_ms_by_op=_host_ops(prof))


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


class Capture:
    """Within the block, records the arguments of every call of
    ``module.name`` (which still runs)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def record(*args):
            self.calls.append(args)
            return self.real(*args)
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def max_ulp(torch, a, b) -> int:
    """Largest distance in float32 units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def hold_equal(torch, name, got, want):
    """The bar for a sparse kernel against its plain version: bit-equal,
    else print the largest ulp difference and hold rtol 1e-6. Returns the
    max absolute error."""
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        emit(phase="not_bit_equal", kernel=name, max_abs_err=err,
             max_ulp=max_ulp(torch, got, want))
        check(torch.allclose(got, want, rtol=1e-6, atol=0.0),
              f"{name} disagrees with its plain version: {err}")
    return err


def hold_segment_sum(torch, got, want):
    """The bar for `segment_sum_sorted` against its plain version on a CPU
    copy: bit-equal (both add each segment in sorted order)."""
    err = (got - want).abs().max().item() if got.numel() else 0.0
    check(torch.equal(got, want),
          f"segment_sum_sorted differs from its plain version: {err}")
    return err


def _sparse_stream(torch, gen, vocab, n, width):
    """Ids with a hot row, negative ids and ids >= V; contribution rows."""
    ids = torch.randint(0, vocab, (n,), device="cuda", generator=gen)
    hot = torch.rand((n,), device="cuda", generator=gen) < 0.2
    ids[hot] = 7
    ids[::97] = -1
    ids[1::89] = vocab + 5
    return ids.int(), torch.randn((n, width), device="cuda", generator=gen)


def sparse_kernel_cases(torch, cuda_sparse, sparse_update):
    """Phase 3b: the four sparse kernels against their plain versions.
    Returns the max absolute error per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    vocab, n = 5000, 20000
    worst = dict.fromkeys(["segment_sum_sorted", "sgd_rows", "adagrad_rows",
                           "adam_rows"], 0.0)
    for width in SPARSE_WIDTHS:
        ids, contribs = _sparse_stream(torch, gen, vocab, n, width)
        with Capture(cuda_sparse, "segment_sum_sorted") as cap:
            rep, sums = sparse_update.dedup_sum(ids, contribs, vocab)
        rep_c, sums_c = sparse_update.dedup_sum(ids.cpu(), contribs.cpu(),
                                                vocab)
        torch.cuda.synchronize()
        check(torch.equal(rep.cpu(), rep_c), f"dedup rep differs, w{width}")
        errs = {"segment_sum_sorted": hold_segment_sum(torch, sums.cpu(),
                                                       sums_c)}
        contribs_p, perm, starts = cap.calls[0]
        atomics = cuda_sparse.segment_sum_sorted_plain(contribs_p, perm,
                                                       starts)
        # a sum in another order differs by up to ~n*eps*sum|x|: the bar
        # is relative to the sum of magnitudes (a column of a 4,000-row hot
        # segment may cancel to near zero)
        magnitude = cuda_sparse.segment_sum_sorted_plain(contribs_p.abs(),
                                                         perm, starts)
        torch.cuda.synchronize()
        diff = (sums - atomics).abs()
        check(bool((diff <= KERNEL_TOL["atol"]
                    + KERNEL_TOL["rtol"] * magnitude).all()),
              f"segment_sum_sorted against index_add_, w{width}")
        errs["against_index_add"] = diff.max().item()
        for kind, n_state in (("sgd", 0), ("adagrad", 1), ("adam", 2)):
            table = torch.empty((vocab, width), device="cuda").uniform_(
                -0.05, 0.05, generator=gen)
            states = [torch.full_like(table, 0.1 if kind == "adagrad"
                                      else 0.0) for _ in range(n_state)]
            ref = [t.clone() for t in [table] + states]
            for step in range(1, 4):
                ids, contribs = _sparse_stream(torch, gen, vocab, n, width)
                rep, sums = sparse_update.dedup_sum(ids, contribs, vocab)
                if kind == "sgd":
                    cuda_sparse.sgd_rows(table, rep, sums, TRAIN_LR)
                    cuda_sparse.sgd_rows_plain(ref[0], rep, sums, TRAIN_LR)
                elif kind == "adagrad":
                    cuda_sparse.adagrad_rows(table, states[0], rep, sums,
                                             TRAIN_LR, 1e-7)
                    cuda_sparse.adagrad_rows_plain(ref[0], ref[1], rep, sums,
                                                   TRAIN_LR, 1e-7)
                else:
                    c1, c2 = sparse_update.bias_corrections(step, 0.9, 0.999)
                    args = (rep, sums, TRAIN_LR, 0.9, 0.999, 1e-8, c1, c2)
                    cuda_sparse.adam_rows(table, *states, *args)
                    cuda_sparse.adam_rows_plain(*ref, *args)
            torch.cuda.synchronize()
            errs[f"{kind}_rows"] = max(
                hold_equal(torch, f"{kind}_rows", got, want)
                for got, want in zip([table] + states, ref))
        for key in worst:
            worst[key] = max(worst[key], errs[key])
        emit(phase="sparse_kernel", width=width, ok=True, max_abs_err=errs)
    return worst


def set_counts(cuda_lookup, cuda_sparse, value=0):
    cuda_lookup.launches = value
    for key in cuda_sparse.launches:
        cuda_sparse.launches[key] = value


def read_counts(cuda_lookup, cuda_sparse) -> dict:
    return {"lookup_combine": cuda_lookup.launches, **cuda_sparse.launches}


def dense_names(model):
    return [n for n, p in model.named_parameters() if p.requires_grad]


def ulp(torch, x):
    """The float32 spacing at |x|."""
    x = x.abs()
    return torch.nextafter(x, torch.full_like(x, math.inf)) - x


def hold(torch, what, got, want, before, steps, mode, ill=None, lr=None):
    """The card's trainer (`got`) against the CPU trainer (`want`) after
    `steps` steps from `before`, on the same elements (CPU tensors).
    mode "change": |change(got) - change(want)| within rtol 1e-4 of the
    change plus `steps` ulps of the values (each step rounds once on each
    side); sgd and adagrad at batch 65,536 move most table elements by far
    less than TRAIN_TOL's atol, where a value check would not see a row
    left out. mode "value": TRAIN_TOL (adam moves each element by about lr per
    step), but 1e-2 * lr at `ill` elements, whose gradient is a sum that
    cancels: adam's step does not scale with the gradient, so the low
    digits that the summation order sets (cuBLAS against the CPU's BLAS)
    move such an element by a share of lr. Returns (max |got - want|,
    |change(want)|, how many changes exceed the rounding allowance)."""
    got64, want64 = got.double(), want.double()
    change = (want64 - before.double()).abs()
    diff = (got64 - want64).abs()
    rounding = steps * ulp(torch, torch.maximum(
        torch.maximum(got.abs(), want.abs()), before.abs())).double()
    if mode == "change":
        bar = TRAIN_TOL["rtol"] * change + rounding
    else:
        bar = TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * want64.abs()
        if ill is not None:
            bar = torch.where(ill, torch.full_like(bar, 1e-2 * lr), bar)
    bad = diff > bar
    if bool(bad.any()):
        i = int((diff - bar).flatten().argmax())
        raise SmokeFailure(
            f"{what}: {int(bad.sum())} of {diff.numel()} elements disagree "
            f"with the CPU trainer; worst {diff.flatten()[i].item()} "
            f"against a change of {change.flatten()[i].item()}")
    err = diff.max().item() if diff.numel() else 0.0
    return err, change, int((change > rounding).sum())


def trained_arrays(torch, model, state, touched):
    """The trained arrays on the CPU: {dense parameter name: tensor} and,
    per bucket, the table and its state tensors at rows `touched`."""
    dense = {n: p.detach().cpu().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    rows = []
    for b, idx in enumerate(touched):
        table = model.embedding.tp[b].detach()
        arrays = [table] + [x for x in state["emb"]["tp"][b]
                            if torch.is_tensor(x)]
        rows.append([x.index_select(0, idx.to(table.device)).cpu()
                     for x in arrays])
    return dense, rows


def hold_trainers(torch, label, after, cpu_after, before, touched, steps,
                  mode, scale=None, lr=None):
    """Every trained array of the card's trainer against the CPU
    trainer's (`trained_arrays` of each, and of the card's before the
    steps), by `hold`: the touched table and state rows, which the kernels
    update, in `mode`; the MLPs by value (their gradients sum all 65,536
    rows of a batch, and where such a sum cancels, its change carries the
    low digits that cuBLAS's summation order and the CPU's set). `scale`
    (adam): `gradient_scale` of the step, whose ill-conditioned
    elements `hold` gives the wider bar (the state arrays never get it).
    Returns (max abs error, |change| of the touched table elements, how
    many of them moved past the rounding allowance)."""
    worst, table_change, moved = 0.0, [], 0

    def ill(name, rows=None):
        if scale is None:
            return None
        g, t = scale[name]
        if rows is not None:
            g, t = g.index_select(0, rows), t.index_select(0, rows)
        return (t > 0) & (g.abs() < ILL_SCALE * t)
    for name, got in after[0].items():
        err, _, _ = hold(torch, f"{label}: {name}", got, cpu_after[0][name],
                         before[0][name], steps, "value", ill(name), lr)
        worst = max(worst, err)
    for b, (got_b, want_b, before_b) in enumerate(zip(after[1], cpu_after[1],
                                                      before[1])):
        for i, (got, want, old) in enumerate(zip(got_b, want_b, before_b)):
            what = f"{label}: bucket {b} " + ("table" if i == 0
                                                else f"state {i - 1}")
            if i == 0:
                err, change, n = hold(torch, what, got, want, old, steps,
                                      mode, ill(f"embedding.tp.{b}",
                                                touched[b]), lr)
                worst = max(worst, err)
                table_change.append(change.flatten())
                moved += n
            else:
                hold(torch, what, got, want, old, steps, mode)
    return worst, torch.cat(table_change), moved


def train_against_cpu(torch, cuda_sparse, kind, mode, step, model, state,
                      cpu_step, cpu_model, batches):
    """Drive the card's trainer over `batches`, each step held against a
    CPU trainer started from the card's state before it (the model runs
    chaotically at lr 0.01: over several steps the two trainers' rounding
    differences grow until they move well-conditioned gradients too). The
    CPU step runs first and names the rows the step touches. The tables
    and their state are held in `mode` (`hold`); adam's ill-conditioned
    elements are named by `gradient_scale` on the CPU. Returns the card's
    state and a dict of what was held."""
    from distributed_embeddings_tpu_torch.training import gradient_scale
    out = dict(losses=[], cpu_losses=[], max_abs_err=0.0, changes=[],
               moved=0, touched=[], ill=0, with_gradient=0)
    for batch in batches:
        cpu_model.load_state_dict(model.state_dict())
        scale = (gradient_scale(cpu_model, *batch) if kind == "adam"
                 else None)
        cpu_state, cpu_loss, touched = run_trainer(
            cpu_step, cpu_model, to_cpu(torch, state), [batch], kind,
            cuda_sparse)
        touched = touched_rows(torch, cpu_model, touched)
        cpu_after = trained_arrays(torch, cpu_model, cpu_state, touched)
        del cpu_state
        before = trained_arrays(torch, model, state, touched)
        state, loss, _ = run_trainer(step, model, state, [batch])
        err, change, moved = hold_trainers(
            torch, kind, trained_arrays(torch, model, state, touched),
            cpu_after, before, touched, 1, mode, scale, TRAIN_LR)
        out["losses"] += loss
        out["cpu_losses"] += cpu_loss
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["changes"].append(change)
        out["moved"] += moved
        out["touched"].append(touched)
        if scale is not None:
            for g, t in scale.values():
                ill = (t > 0) & (g.abs() < ILL_SCALE * t)
                out["ill"] += int(ill.sum())
                out["with_gradient"] += int((t > 0).sum())
    check(torch.allclose(torch.tensor(out["losses"]),
                         torch.tensor(out["cpu_losses"]), **LOSS_TOL),
          f"{kind}: losses {out['losses']} against the CPU trainer's "
          f"{out['cpu_losses']}")
    out["changes"] = torch.cat(out["changes"])
    out["touched"] = [torch.unique(torch.cat(rows))
                      for rows in zip(*out["touched"])]
    return state, out


def to_cpu(torch, tree):
    """A copy of an optimizer state on the CPU (ints kept)."""
    if isinstance(tree, dict):
        return {k: to_cpu(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(torch, v) for v in tree)
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def run_trainer(step, model, state, batches, capture_kind=None,
                cuda_sparse=None):
    """Steps over `batches`; returns (state, losses, touched rep per table
    data pointer) — the latter recorded from the row kernel's calls."""
    losses = []
    touched: dict = {}
    cap = (Capture(cuda_sparse, f"{capture_kind}_rows")
           if capture_kind else None)
    if cap:
        cap.__enter__()
    try:
        for num, cats, labels in batches:
            _, state, loss = step(model, state, num, cats, labels)
            losses.append(float(loss))
    finally:
        if cap:
            cap.__exit__()
    if cap:
        rep_arg = {"sgd": 1, "adagrad": 2, "adam": 3}[capture_kind]
        for args in cap.calls:
            table, rep = args[0], args[rep_arg]
            valid = rep[(rep >= 0) & (rep < table.shape[0])].long()
            touched.setdefault(table.data_ptr(), []).append(valid)
    return state, losses, touched


def touched_rows(torch, cpu_model, touched_by_ptr):
    out = []
    for t in cpu_model.embedding.tp:
        parts = touched_by_ptr.get(t.data_ptr(), [])
        out.append(torch.unique(torch.cat(parts)) if parts
                   else torch.zeros(0, dtype=torch.long))
    return out


def sparse_bound(kind, rep, width, n_valid, rate):
    """(bytes_ms, ops_ms) of a row kernel: rep read once; the valid rows'
    sums read and their table and n_state state rows read and written;
    about 2/5/12 flops per element (sgd/adagrad/adam)."""
    n_state = {"sgd": 0, "adagrad": 1, "adam": 2}[kind]
    n_bytes = (rep.numel() * rep.element_size()
               + 4 * width * n_valid * (1 + 2 * (1 + n_state)))
    flops = {"sgd": 2, "adagrad": 5, "adam": 12}[kind] * n_valid * width
    return n_bytes / rate * 1e3, flops / F32_FLOP_PER_S * 1e3


def time_row_calls(torch, cuda_sparse, kind, calls, rate):
    """The row kernel at the shapes of one step (one call per bucket):
    a check against its plain version on compact copies of the touched
    rows, then kernel / plain / library time and the bound. Returns
    (totals, worst abs error)."""
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                  ops_ms=0.0, library_ms=0.0 if kind == "sgd" else None)
    worst = 0.0
    kernel = getattr(cuda_sparse, f"{kind}_rows")
    plain = getattr(cuda_sparse, f"{kind}_rows_plain")
    n_arrays = {"sgd": 1, "adagrad": 2, "adam": 3}[kind]
    for b, args in enumerate(calls):
        arrays, rep, sums = (args[:n_arrays], args[n_arrays],
                             args[n_arrays + 1])
        rest = args[n_arrays + 2:]
        vocab, width = arrays[0].shape
        valid = (rep >= 0) & (rep < vocab)
        rows = rep[valid].long()
        u = int(rows.numel())
        # compact copies: the touched rows only, rep renumbered 0..U-1
        compact_rep = torch.full_like(rep, u)
        compact_rep[valid] = torch.arange(u, device="cuda",
                                          dtype=rep.dtype)
        got = [a.index_select(0, rows) for a in arrays]
        want = [g.clone() for g in got]
        kernel(*got, compact_rep, sums, *rest)
        plain(*want, compact_rep, sums, *rest)
        torch.cuda.synchronize()
        err = max(hold_equal(torch, f"{kind}_rows", g, w)
                  for g, w in zip(got, want))
        worst = max(worst, err)
        ms = device_ms(lambda: kernel(*arrays, rep, sums, *rest), reps=10)
        plain_ms = eager_ms(lambda: plain(*arrays, rep, sums, *rest),
                            reps=3)
        library_ms = None
        if kind == "sgd":
            delta = sums[valid] * (-rest[0])
            library_ms = device_ms(
                lambda: arrays[0].index_add_(0, rows, delta), reps=10)
            totals["library_ms"] += library_ms
        bytes_ms, ops_ms = sparse_bound(kind, rep, width, u, rate)
        emit(phase=f"{kind}_rows_kernel", bucket=b, table=[vocab, width],
             slots=int(rep.numel()), unique_rows=u, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ok=True)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", max(bytes_ms, ops_ms)),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            totals[key] += val
    return totals, worst


def time_segment_calls(torch, cuda_sparse, calls, rate):
    """`segment_sum_sorted` at the shapes of one step (one call per
    bucket): the kernel bit-equal to its plain version on CPU copies of
    the same inputs, U, the longest segment, kernel / plain / `index_add_`
    time and the bound. Returns (totals, worst abs error)."""
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                  ops_ms=0.0, library_ms=0.0)
    worst = 0.0
    for b, (contribs, perm, starts) in enumerate(calls):
        n, width = contribs.shape
        got = cuda_sparse.segment_sum_sorted(contribs, perm, starts).cpu()
        want = cuda_sparse.segment_sum_sorted_plain(
            contribs.cpu(), perm.cpu(), starts.cpu())
        err = hold_segment_sum(torch, got, want)
        worst = max(worst, err)
        del got, want
        lengths = starts[1:] - starts[:-1]
        unique = int((lengths > 0).sum().item())
        longest = int(lengths.max().item())
        seg = cuda_sparse._segment_ids(starts, n)
        seg_of_row = torch.empty_like(seg)
        seg_of_row[perm] = seg
        out = torch.zeros((n, width), device="cuda")
        ms = device_ms(lambda: cuda_sparse.segment_sum_sorted(
            contribs, perm, starts), reps=3)
        plain_ms = device_ms(lambda: cuda_sparse.segment_sum_sorted_plain(
            contribs, perm, starts), reps=3)
        library_ms = device_ms(
            lambda: out.index_add_(0, seg_of_row, contribs), reps=3)
        n_bytes = (contribs.numel() * 4 + perm.numel() * 8
                   + starts.numel() * 8 + n * width * 4)
        bytes_ms = n_bytes / rate * 1e3
        ops_ms = n * width / F32_FLOP_PER_S * 1e3
        emit(phase="segment_sum_kernel", bucket=b, rows=n, width=width,
             unique_rows=unique, longest_segment=longest, max_abs_err=err,
             ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=max(bytes_ms, ops_ms), bytes=n_bytes)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms),
                         ("bound_ms", max(bytes_ms, ops_ms)),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            totals[key] += val
    return totals, worst


# device-time categories of a training step, by kernel name
CATEGORIES = (("lookup", ("lookup_combine",)),
              ("segment_sum", ("segment_sum_sorted",)),
              ("row_update", ("_rows_kernel",)),
              ("sort", ("sort", "Sort", "radix", "Radix")),
              ("mlp_gemm", ("gemm", "Gemm", "xmma", "cutlass", "sm90")),
              ("host_to_device", ("HtoD",)),
              ("device_to_host", ("DtoH",)))


def profile_step(torch, step_once):
    busy_us, wall_us, device, prof = profile_call(torch, step_once)
    by_kernel = _by_name(device)
    cats = {name: 0.0 for name, _ in CATEGORIES}
    cats["other"] = 0.0
    other = {}
    for kname, us in by_kernel.items():
        for cat, keys in CATEGORIES:
            if any(k in kname for k in keys):
                cats[cat] += us / 1e3
                break
        else:
            cats["other"] += us / 1e3
            other[kname] = us
    measured = bool(device)
    emit(phase="train_profile", wall_ms=wall_us / 1e3,
         device_events=len(device),
         device_busy_ms=busy_us / 1e3 if measured else None,
         device_idle_share=1 - busy_us / wall_us if measured else None,
         device_ms_by_category=cats,
         device_ms_by_kernel=[[n[:80], us / 1e3] for n, us in sorted(
             by_kernel.items(), key=lambda kv: -kv[1])[:12]],
         other_top=[[n[:80], us / 1e3] for n, us in sorted(
             other.items(), key=lambda kv: -kv[1])[:6]],
         host_self_ms_by_op=_host_ops(prof, top=10))


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
    from distributed_embeddings_tpu_torch.ops import (cuda_lookup, cuda_sparse,
                                                      kernel_build,
                                                      sparse_update)
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

    # ---- 3. kernels against their plain versions
    worst = kernel_cases(torch, cuda_lookup)
    sparse_worst = sparse_kernel_cases(torch, cuda_sparse, sparse_update)

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

    # the serving path: counts to 0, drive, read
    set_counts(cuda_lookup, cuda_sparse)
    outs = [engine.predict(req) for req in requests]
    batcher = MicroBatcher(engine)
    handles = [batcher.submit(req) for req in spans]
    flushed = batcher.flush()
    torch.cuda.synchronize()
    serve_counts = read_counts(cuda_lookup, cuda_sparse)
    launches = serve_counts["lookup_combine"]
    forwards = len(requests) + batcher.batches
    emit(phase="main_path", path="serve", forwards=forwards,
         launches=serve_counts, launches_per_forward=launches / forwards)
    check(launches == 4 * forwards,
          f"{launches} kernel launches over {forwards} forwards, want 4 each")
    check(sum(serve_counts.values()) == launches,
          f"a sparse kernel ran while serving: {serve_counts}")

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
    del cpu_engine

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
    with Capture(cuda_lookup, "lookup_combine") as cap:
        engine.predict(requests[-1])
    captured = [args + (None,) * (3 - len(args)) for args in cap.calls]
    check(len(captured) == 4, f"{len(captured)} groups captured, want 4")
    rate = hbm_rate(name)
    tiny_worst, totals = tiny_bucket_kernels(torch, cuda_lookup, captured,
                                             rate)
    emit(phase="tiny_kernel_total", hbm_bytes_per_s=rate, **totals)

    lookup_row = dict(launches={"serve": launches}, ms=totals["ms"],
                      plain_ms=totals["plain_ms"],
                      bound_ms=totals["bound_ms"],
                      bytes_ms=totals["bytes_ms"], ops_ms=totals["ops_ms"],
                      library_ms=totals["library_ms"],
                      max_abs_err=max(worst, tiny_worst))

    # ---- 5. training at full width: the same model, adagrad
    from distributed_embeddings_tpu_torch.training import (
        adagrad as dense_adagrad, make_sparse_train_step)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batches = list(InputGenerator(tiny, BATCH, alpha=1.05,
                                  num_batches=TRAIN_STEPS, seed=0))
    init, step = make_sparse_train_step(model, "adagrad", lr=TRAIN_LR)
    state = init(model)
    torch.cuda.synchronize()
    emit(phase="train_setup", seconds=time.perf_counter() - t0,
         accumulator_bytes=sum(a[0].numel() * 4
                               for a in state["emb"]["tp"]))
    # a sample of rows per bucket, recorded before any step
    sample = [torch.randint(0, t.shape[0], (UNTOUCHED_SAMPLE,),
                            generator=torch.Generator().manual_seed(b))
              for b, t in enumerate(model.embedding.tp)]
    sampled = [t.detach().index_select(0, i.cuda()).cpu()
               for t, i in zip(model.embedding.tp, sample)]

    # the training path: counts to 0, drive, read; each step is held
    # against the CPU trainer (same weights, plain versions) from the
    # card's state before it
    t0 = time.perf_counter()
    _, cpu_step = make_sparse_train_step(cpu_model, "adagrad", lr=TRAIN_LR)
    set_counts(cuda_lookup, cuda_sparse)
    state, held = train_against_cpu(torch, cuda_sparse, "adagrad", "change",
                                    step, model, state, cpu_step, cpu_model,
                                    batches)
    torch.cuda.synchronize()
    train_counts = read_counts(cuda_lookup, cuda_sparse)
    del cpu_model
    losses = held["losses"]
    emit(phase="main_path", path="train_adagrad", steps=TRAIN_STEPS,
         launches=train_counts, losses=losses)
    want_counts = {"lookup_combine": 4, "segment_sum_sorted": 2,
                   "adagrad_rows": 2, "sgd_rows": 0, "adam_rows": 0}
    check(train_counts == {k: v * TRAIN_STEPS
                           for k, v in want_counts.items()},
          f"training launches {train_counts}, want {want_counts} per step")
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    touched = held["touched"]
    untouched = 0
    for b, (t, idx, old) in enumerate(zip(model.embedding.tp, sample,
                                          sampled)):
        keep = ~torch.isin(idx, touched[b])
        now = t.detach().index_select(0, idx.cuda()).cpu()
        acc = state["emb"]["tp"][b][0].index_select(0, idx.cuda()).cpu()
        check(torch.equal(now[keep], old[keep])
              and bool((acc[keep] == torch.tensor(0.1)).all()),
              f"bucket {b}: an untouched row changed")
        untouched += int(keep.sum())
    change = held["changes"]
    emit(phase="train_check", seconds=time.perf_counter() - t0,
         losses=losses, cpu_losses=held["cpu_losses"],
         loss_rel_err=max(abs(a - b) / abs(b) for a, b in zip(
             losses, held["cpu_losses"])),
         max_abs_err=held["max_abs_err"],
         touched_rows=[int(t.numel()) for t in touched],
         table_elements_held=int(change.numel()),
         table_change_median=change.median().item(),
         table_change_max=change.max().item(),
         table_changes_past_rounding=held["moved"],
         untouched_rows_checked=untouched, ok=True)
    del change, held

    # step time, synchronized
    times = []
    for i in range(12):
        num, cats, labels = batches[i % TRAIN_STEPS]
        t0 = time.perf_counter()
        _, state, loss = step(model, state, num, cats, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times[2:])
    emit(phase="train_step_time", batch=BATCH, median_ms=med * 1e3,
         min_ms=min(times[2:]) * 1e3, max_ms=max(times[2:]) * 1e3,
         samples_per_s=BATCH / med, final_loss=float(loss))
    emit(phase="train_memory",
         max_memory_allocated=torch.cuda.max_memory_allocated())
    num, cats, labels = batches[0]
    holder = {"state": state}

    def step_once():
        holder["state"] = step(model, holder["state"], num, cats,
                               labels)[1]
    profile_step(torch, step_once)
    # the dense optimizer alone, at the MLP's shapes (timed apart: its
    # elementwise kernels carry no name of their own in the profile)
    params = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    grads = {n: torch.randn_like(p) for n, p in params.items()}
    dense = dense_adagrad(TRAIN_LR)
    dense_state = dense.init(params)
    emit(phase="dense_optimizer", params=sum(p.numel()
                                             for p in params.values()),
         device_ms=device_ms(lambda: dense.update(params, grads,
                                                  dense_state), reps=5))

    # the new kernels at the shapes one step gives them
    with Capture(cuda_sparse, "segment_sum_sorted") as seg_cap, \
            Capture(cuda_sparse, "adagrad_rows") as row_cap:
        step_once()
    torch.cuda.synchronize()
    seg_totals, seg_err = time_segment_calls(torch, cuda_sparse,
                                             seg_cap.calls, rate)
    ada_totals, ada_err = time_row_calls(torch, cuda_sparse, "adagrad",
                                         row_cap.calls, rate)
    del state, holder, seg_cap, row_cap
    engine = None
    del model
    torch.cuda.empty_cache()

    # ---- 6. sgd and adam on Tiny cut to CUT_ROWS rows per table
    cut = tiny._replace(embedding_configs=[
        e._replace(num_rows=min(e.num_rows, CUT_ROWS))
        for e in tiny.embedding_configs])
    cut_batches = list(InputGenerator(cut, BATCH, alpha=1.05,
                                      num_batches=TRAIN_STEPS + 1, seed=0))
    cut_model = SyntheticModel(cut, device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(0))
    initial = {k: v.cpu() for k, v in cut_model.state_dict().items()}
    rows = {"adagrad_rows": (ada_totals, ada_err)}
    cut_counts = {}
    for kind in ("sgd", "adam"):
        cut_model.load_state_dict(initial)
        cpu_cut = SyntheticModel(cut, device="cpu")
        init, step = make_sparse_train_step(cut_model, kind, lr=TRAIN_LR)
        _, cpu_step = make_sparse_train_step(cpu_cut, kind, lr=TRAIN_LR)
        set_counts(cuda_lookup, cuda_sparse)
        state, held = train_against_cpu(
            torch, cuda_sparse, kind, "value", step, cut_model,
            init(cut_model), cpu_step, cpu_cut, cut_batches[:TRAIN_STEPS])
        torch.cuda.synchronize()
        counts = read_counts(cuda_lookup, cuda_sparse)
        cut_counts[kind] = counts
        want = {"lookup_combine": 4, "segment_sum_sorted": 2,
                "sgd_rows": 0, "adagrad_rows": 0, "adam_rows": 0,
                f"{kind}_rows": 2}
        check(counts == {k: v * TRAIN_STEPS for k, v in want.items()},
              f"{kind} launches {counts}, want {want} per step")
        emit(phase="main_path", path=f"train_{kind}_cut", steps=TRAIN_STEPS,
             launches=counts, losses=held["losses"],
             cpu_losses=held["cpu_losses"], max_abs_err=held["max_abs_err"],
             table_change_median=held["changes"].median().item(),
             table_change_max=held["changes"].max().item(),
             elements_with_gradient=held["with_gradient"],
             ill_conditioned_elements=held["ill"], ok=True)
        with Capture(cuda_sparse, f"{kind}_rows") as cap:
            num, cats, labels = cut_batches[TRAIN_STEPS]
            step(cut_model, state, num, cats, labels)
        torch.cuda.synchronize()
        rows[f"{kind}_rows"] = time_row_calls(torch, cuda_sparse, kind,
                                              cap.calls, rate)
        del cpu_cut, state, held, cap

    # ---- 7. result lines
    def entry(kname, source, by_path, tot, err):
        return {"name": kname, "route": "cuda",
                "source": f"distributed_embeddings_tpu_torch/csrc/{source}",
                "replaces": ", ".join(TPU_SITES[kname]) or None,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"],
                "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                             else "operations"),
                "library_ms": tot["library_ms"]}

    paths = {"serve": serve_counts, "train_adagrad": train_counts,
             "train_sgd_cut": cut_counts["sgd"],
             "train_adam_cut": cut_counts["adam"]}

    def by_path(kname):
        return {p: c[kname] for p, c in paths.items() if c[kname]}

    kernels = [entry("lookup_combine", "lookup_combine.cu",
                     by_path("lookup_combine"), lookup_row,
                     lookup_row["max_abs_err"]),
               entry("segment_sum_sorted", "sparse_apply.cu",
                     by_path("segment_sum_sorted"), seg_totals,
                     max(seg_err, sparse_worst["segment_sum_sorted"]))]
    for kname in ("sgd_rows", "adagrad_rows", "adam_rows"):
        tot, err = rows[kname]
        kernels.append(entry(kname, "sparse_apply.cu", by_path(kname), tot,
                             max(err, sparse_worst[kname])))
    print(json.dumps({"kernels": kernels}), flush=True)
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
