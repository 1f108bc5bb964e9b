#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one H100

Phases, each printing JSON lines before the last line:
  1. device: the card's name and power limit; TF32 off for matmuls and
     convolutions, so float32 means float32.
  2a. ladder: the Hopper feature ladder
     (`distributed_embeddings_tpu_torch.tools.cuda_feature_probe`, the
     counterpart of tools/tpu_mosaic_probe.py), before the production
     build, so a build fault there arrives with the feature matrix
     printed. The toolkit's release, then nine rungs, each built by its
     own nvcc (all at once) and run even after a failure: vmem (static
     shared memory, the sm_90a target), anyspace (a TMA tensor map as a
     kernel parameter, 128 KB of shared memory), dma (a bulk copy on an
     mbarrier), dyn_dma (cp.async at a runtime row), prefetch (a TMA load
     at a runtime coordinate), loop_dma (8 TMA loads in flight on 8
     mbarriers), blockspec_gather (index-driven tiles, a carried
     accumulator, in place), rmw_scatter (`sgd_rows` at lr -1) and
     tiled_kernels (the stream kernels and `gather_sorted`). Every kernel
     bit-equal to its plain version on the JAX rung's inputs and on
     distinct-row inputs (t[r, c] = r * 128 + c). One line per rung
     (registers, shared memory and spills from the compiler's log); then
     the run fails if any rung failed. Launches: 2 per rung kernel, 1 each
     of sgd_rows, gather_sorted and the three stream kernels. Then each
     rung kernel timed at the JAX rung's inputs beside its plain version,
     one library call and its bound.
  2. build: nvcc compiles every kernel of the paths from ``csrc/`` (one
     nvcc per source, all at once): lookup_combine.cu, sparse_apply.cu,
     sorted_stream.cu (the last two share row_rules.cuh).
  3. kernel: `lookup_combine` against its plain PyTorch version at the
     zoo's widths (8..256), hotness 1/10/30, sum/mean, weighted (with
     zero-weight slots) and unweighted, int32 and int64 ids, some of them
     out of range or negative. Bit-equal at hotness 1 unweighted, rtol 1e-5
     / atol 1e-6 otherwise (the K-term sum order differs). Tables are drawn
     like the model's (uniform +-0.05).
     sparse_kernel: `segment_sum_sorted` (through `dedup_sum`) and the
     three row kernels against their plain versions at widths 8..256, on
     streams with duplicates (a hot row about 4,000 rows long and a warm
     one of 3T + 1 rows, T the segment walk's threshold), negative ids,
     ids >= V and the dedup filler tail, three accumulating steps each. The segment sum bit-equal to its
     plain version on a CPU copy (both add in sorted order) and within
     atol 1e-6 + rtol 1e-5 of the segment's sum of magnitudes of the card's
     `index_add_` (atomics, another order each run); the row
     kernels bit-equal to their plain versions on the card (else the
     largest ulp difference is printed and rtol 1e-6 holds).
     sorted_kernel (3c): `gather_sorted`, weighted and not, int32 and
     int64 keys, at widths 6 and 8..256 with keys < 0 and >= V, in its
     sorted form and in its perm form (each row stored at its place in
     a random stream; also bit-equal to the sorted form's rows
     unpermuted), and `sgd_stream` / `adagrad_stream` /
     `adam_stream` over 3 accumulating steps on duplicate-heavy streams
     with invalid ids, each bit-equal to its plain version; both sorted
     lookups' forward and backward against their plain versions.
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
     Main path: 3 steps with launches 4 / 1 / 1 per step (lookup_combine /
     segment_sum_sorted / adagrad_rows: bucket 0, 60,160 x 8, takes the
     dense strategy under "auto", whose touched rows show in its
     `_dense_update` call), each held against a CPU trainer
     (the same weights, plain versions) started from the card's state,
     whose step takes the card's ReLU masks (`forced_relu`; a flip past
     rounding fails): losses rtol 1e-5; the change of every touched table and accumulator
     element within rtol 1e-4 of it plus one ulp, widened by the step's
     conditioning (`gradient_scale`) and, on a row the dense strategy
     summed from n contributions, by (n - 1) 2^-24 (`sum_eps`: the card's
     atomics add them in another order than the CPU), the MLPs at rtol 1e-4 /
     atol 1e-6; a sample of untouched rows bit-unchanged. Then the median
     of 10 synchronized steps after 2 warm ones, samples/s, peak memory,
     one step under torch.profiler, and the new kernels at the shapes one
     step gives them (the segment sum bit-equal to its plain version on
     CPU copies), timed like phase 4's, with U (unique rows), the
     longest segment per bucket and ``chain_ms``: the longest segment
     times 4 cycles (one dependent add a row, the chain its sorted-order
     sum forces) at the SM clock nvidia-smi reads while the kernel runs,
     printed beside the bound.
     5b. train_fused: the same model from its initial weights through
     ``lookup_path="fused"`` + ``strategy="pallas"``, adagrad: 3 steps
     held like phase 5's (the change bar widened by `gradient_scale`'s
     conditioning), launches 4 / 2 / 2 / 0 per step (gather_sorted /
     segment_sum_sorted / adagrad_rows / lookup_combine), 6 sorts per
     step under the profiler; step time and profile (with the device
     time of the step's `index_select` calls by caller); `gather_sorted`
     per group in the perm form the step calls, beside its sorted form
     on the same keys and `lookup_combine`; the whole fused lookup
     beside its old composition (weights permuted, sorted gather,
     `index_select` by the inverse permutation, hotness sum), bit-equal
     and timed in the same run.
  6. sgd and adam: Tiny with every table cut to at most 100,000 rows
     (widths, hotness, sharing kept), 3 steps each held like phase 5's
     but by value (rtol 1e-4 / atol 1e-6); adam by 1e-2 * lr where the
     step's gradient is a sum that cancels. `sgd_rows` launches once per
     bucket per step (sgd's "auto" is the deduplicated-row route),
     `adam_rows` once (bucket 0 dense), each timed at the shapes those
     steps give them.
     6c. dense_path: the same cut Tiny with ``strategy="dense"`` against
     ``"sort"``, adagrad and adam, each of 3 steps from the same state,
     by value (launches 4 lookup_combine a step, no segment sum or row
     kernel); then full criteo (tiled lookup) through ``fit(sparse=False,
     "sgd")`` against ``fit(sparse=True, "sgd")`` from one state, 3
     steps: launches 1 / 1 (gather_sorted / sgd_stream, the lookup's
     backward), the touched rows within rtol 1e-5, every other row
     bit-identical, the MLPs by value.
     6b. train_tiled: full-size criteo (26 tables x 100,000 x 128) through
     ``lookup_path="tiled"`` + ``strategy="tiled"``: adagrad, sgd and adam
     (adam on the MLP too), 3 held steps each (adagrad and sgd by change,
     adam by value with phase 6's rule); launches 1 / 1 per step
     (gather_sorted / <opt>_stream); 1 sort per step, 2 with
     ``fold_sort=False`` and the same step bit for bit; step times and a
     profile (`index_select` by caller, as 5b); `gather_sorted` and the
     stream kernels at the step's shapes, with N, U, the longest segment
     and ``chain_ms``.
  8. world (after 6b): the port at world size > 1. Tiny (full width,
     adagrad, gather-combine and deduplicated rows) on 2 ranks, then criteo
     (full width, ``lookup_path="tiled"`` + ``strategy="tiled"``, adagrad)
     on 4, each rank a spawned process: on ``cuda:0`` over gloo (passed
     explicitly) when the machine has fewer cards than ranks, else rank r
     on ``cuda:r`` over NCCL; the backend and the device count printed
     (``"nccl": "not run: 1 card"``). Each rank first probes the exchange
     (an id and a float all_to_all of CUDA tensors), builds the config
     with every table drawn from a seed by its index and the MLP from a
     seed (`seed_weights`; no weight file), saves its forward of its
     slice of batch 0, runs 3 adagrad steps over its slices of the global
     batches (launches counted: per step one gather-combine or sorted
     gather per exchange group and one segment sum and row update, or one
     stream update, per bucket, the numbers from the rank's plan), then 10
     timed steps after 2 warm ones and one profiled step (device time by
     kernel and category, gloo's pinned copies, the exchange's ranges
     from `ops.wire`, 3 a group or the phase fails). The card's idle
     share merges every rank's device intervals (`card_profile`): the
     ranks share it. This process then runs
     the world-1 trainer over the same global batches, each step from rank
     0's MLP and dense optimizer state before it (as phase 5's CPU trainer
     starts from the card's; the tables train apart over all 3): each
     rank's
     forward bit-identical to its slice of world 1's (else rtol 1e-5,
     printed), losses at rtol 1e-5, every touched row of each rank's
     tables and accumulators by change (rtol 1e-4 plus one ulp a step,
     the bar widened by the largest conditioning `gradient_scale` gives
     the element over the steps, as in 5b: after the first step the two
     worlds' MLPs differ in their last digits), the MLPs by value (rtol
     1e-4 / atol 1e-6) and bit-equal across ranks. Before any step each
     rank runs `evaluate` over the global batches (its slices, the
     histograms summed over the ranks): its AUC equals world 1's to the
     bit. Tiny's bucket 0 is dense at W = 2 too (launches a rank step 4 /
     1 / 1, from the rank's plan). A rank that fails fails the phase; the ranks are joined with a
     timeout.
  9. (after 6c, before 8) DLRM at the example's widths (width 128, bottom
     512-256-128, top 1024-1024-512-256-1, 13 numerical features, batch
     65,536, ``lookup_path="pallas"``: one-hot gathers through
     lookup_combine). dlrm_against_cpu: Criteo sizes x 0.02 (1.92 GB), 3
     sparse sgd steps held against the CPU trainer like phase 5's (its
     two MLPs' ReLU masks forced; the row sums' conditioning from the
     CPU step's contributions, `contribution_cond`), launches 1 / 1 / 1.
     dlrm_fit: Criteo sizes x 0.4 (38.5 GB; the full 96.1 GB do not fit
     one card); a seeded ClickGenerator stream written as train/ and
     test/ in the split-binary layout to a temporary directory (removed
     after), read by `RawBinaryDataset` through ``fit(raw_batches,
     preprocess=, pipelined=True, eval_data=, eval_every=6,
     eval_steps=4)``, sparse sgd at the example's schedule, 12 steps;
     then the same from the same weights with ``pipelined=False``:
     losses, eval AUCs, tables (`table_digest`) and MLPs bit-identical.
     Printed: launches (1 / 1 / 1 a step, 1 lookup a eval forward), step
     times and samples/s, peak memory, ingest stage means, one profiled
     step each (`StepWindow`: idle share, HtoD copies pageable / pinned),
     the on-card AUC against `auc_exact` (1e-3) and a CPU StreamingAUC.
     convergence: `tools.convergence_demo.run` at
     docs/convergence_r05.json's settings, its curve beside r05's; the
     last AUC must pass 0.70.
  7. the kernels line (each kernel's launches by path, the world paths'
     summed over the ranks), the card's line, and the last line
     ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or when the port
is not beside this script.
"""

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ["lookup_combine", "sparse_apply", "sorted_stream"]
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
# how far two float32 sums of the same terms, each a digit or two off
# between the trainers, may differ, relative to the sum of the terms'
# magnitudes: about sqrt(n) * 2**-24 for n terms, 1.5e-5 at the 66,607
# contributions of Tiny's hottest row
SUM_EPS = 2e-5
TRAIN_LR = 0.01
TRAIN_STEPS = 3
CUT_ROWS = 100_000
UNTOUCHED_SAMPLE = 4096
# steps of the sorted-stream paths held against a CPU trainer
FUSED_HELD_STEPS = 3
TILED_HELD_STEPS = 3
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
    "gather_sorted": ["distributed_embeddings_tpu/ops/pallas_tiled.py:576"],
    "sgd_stream": ["distributed_embeddings_tpu/ops/pallas_tiled.py:340 (via tiled_sgd :382)"],
    "adagrad_stream": ["distributed_embeddings_tpu/ops/pallas_tiled.py:340 (via tiled_adagrad :398)"],
    "adam_stream": ["distributed_embeddings_tpu/ops/pallas_tiled.py:340 (via tiled_adam :470)"],
    "probe_vmem": ["tools/tpu_mosaic_probe.py:42"],
    "probe_anyspace": ["tools/tpu_mosaic_probe.py:53"],
    "probe_dma": ["tools/tpu_mosaic_probe.py:70"],
    "probe_dyn_dma": ["tools/tpu_mosaic_probe.py:90"],
    "probe_prefetch": ["tools/tpu_mosaic_probe.py:119"],
    "probe_loop_dma": ["tools/tpu_mosaic_probe.py:148"],
    "probe_blockspec_gather": ["tools/tpu_mosaic_probe.py:222"],
}
# the kernels of every path, by the module that counts their launches
ALL_KERNELS = ("lookup_combine", "segment_sum_sorted", "sgd_rows",
               "adagrad_rows", "adam_rows", "gather_sorted", "sgd_stream",
               "adagrad_stream", "adam_stream", "probe_vmem", "probe_anyspace",
               "probe_dma", "probe_dyn_dma", "probe_prefetch",
               "probe_loop_dma", "probe_blockspec_gather")
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


T_START = time.perf_counter()


def emit(**fields):
    fields["elapsed_s"] = round(time.perf_counter() - T_START, 1)
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
    sits between the kernels (the feature ladder's timer)."""
    from distributed_embeddings_tpu_torch.tools.cuda_feature_probe import (
        graph_us)
    return graph_us(fn, reps, replays) / 1e3


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


def busy_union(intervals):
    """The length of the union of (start, end) intervals."""
    busy, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start >= reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


def profile_call(torch, fn):
    """One synchronized `fn()` under torch.profiler (after one warm call):
    the device's busy time (the union of its kernel and copy intervals),
    the wall time, the device events (without the device side of the
    host's annotated ranges: `index_select_ranges`', the exchange's,
    gloo's and NCCL's), the profiler, and the call's window (start, end)
    in µs of the Unix clock, the clock of the profiler's trace. The
    profiler's own host cost inflates the wall time, so an idle share from
    it is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns() / 1e3
        fn()
        torch.cuda.synchronize()
        t1 = time.time_ns() / 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(ANNOTATED_RANGES)]
    busy_us = busy_union((e.time_range.start, e.time_range.end)
                         for e in device)
    return busy_us, t1 - t0, device, prof, (t0, t1)


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
    busy_us, wall_us, device, prof, _ = profile_call(
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


def tiny_bucket_kernels(torch, cuda_lookup, captured, rate,
                        phase="tiny_kernel"):
    """Phase 4b: the kernel at the real buckets and group shapes captured
    from one 65536-row forward: check, time, bound, yardstick (one
    `phase` line a group)."""
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
        check(ok, f"kernel disagrees at {phase} group {g}: max abs err "
                  f"{err}")
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
        emit(phase=phase, group=g, table=list(table.shape),
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
    """Within the block, records the positional (``calls``) and keyword
    (``kwargs``) arguments of every call of ``module.name`` (which still
    runs)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls, self.kwargs = module, name, [], []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def record(*args, **kwargs):
            self.calls.append(args)
            self.kwargs.append(kwargs)
            return self.real(*args, **kwargs)
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
    """Ids with a hot row (about n / 5 rows), a warm row of 3T + 1 rows
    spread over the stream (T: the segment walk's threshold), negative ids
    and ids >= V; contribution rows."""
    from distributed_embeddings_tpu_torch.ops import cuda_sparse
    ids = torch.randint(0, vocab, (n,), device="cuda", generator=gen)
    hot = torch.rand((n,), device="cuda", generator=gen) < 0.2
    ids[hot] = 7
    t = cuda_sparse.long_rows()
    ids[torch.arange(2, n, n // (3 * t + 1), device="cuda")[:3 * t + 1]] = 11
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


def set_counts(cuda_lookup, *counted):
    """Every launch count to 0: `cuda_lookup`'s integer and the dicts of
    the `counted` modules."""
    cuda_lookup.launches = 0
    for module in counted:
        for key in module.launches:
            module.launches[key] = 0


def read_counts(cuda_lookup, *counted) -> dict:
    out = {"lookup_combine": cuda_lookup.launches}
    for module in counted:
        out.update(module.launches)
    return out


def per_step(launched: dict, steps: int) -> dict:
    """The launch counts `steps` steps give when each step launches the
    kernels of `launched` so often and no other kernel."""
    return {k: launched.get(k, 0) * steps for k in ALL_KERNELS}


def dense_names(model):
    return [n for n, p in model.named_parameters() if p.requires_grad]


def ulp(torch, x):
    """The float32 spacing at |x|."""
    x = x.abs()
    return torch.nextafter(x, torch.full_like(x, math.inf)) - x


def hold(torch, what, got, want, before, steps, mode, cond=None, lr=None,
         eps=SUM_EPS):
    """The card's trainer (`got`) against the CPU trainer (`want`) after
    `steps` steps from `before`, on the same elements (CPU tensors).
    `cond` (optional): per element t/|g| of the step's gradient g and the
    sum t of its terms' magnitudes (`training.gradient_scale`). The two
    trainers' terms differ in their last digits (cuBLAS against the CPU's
    BLAS), so the float32 sums differ by up to about SUM_EPS * t, and by
    SUM_EPS * t/|g| relative to g; above 1/ILL_SCALE the gradient is a
    sum that cancels, "ill".
    mode "change": |change(got) - change(want)| within rtol 1e-4 of the
    change plus `steps` ulps of the values (each step rounds once on each
    side), plus, with `cond`, 2 * SUM_EPS * t/|g| of the change (a change
    of sgd or adagrad carries its gradient's relative error, the
    accumulator's square twice; `eps`, SUM_EPS by default, may be a tensor
    broadcast over the elements: `sum_eps` widens it on rows that a dense
    aggregation summed in another order); sgd and adagrad at batch 65,536
    move
    most table elements by far less than TRAIN_TOL's atol, where a value
    check would not see a row left out. Sums that cancel exactly (g == 0
    from terms, t/|g| infinite) are not held. mode "value": TRAIN_TOL
    (adam moves each element by about lr per step), but, with `cond` and
    adam's `lr`, 1e-2 * lr at ill elements: adam's step does not scale
    with the gradient, so its low digits move such an element by a share
    of lr. Returns (max |got - want| over the held elements,
    |change(want)|, how many changes exceed the rounding allowance)."""
    got64, want64 = got.double(), want.double()
    change = (want64 - before.double()).abs()
    diff = (got64 - want64).abs()
    rounding = steps * ulp(torch, torch.maximum(
        torch.maximum(got.abs(), want.abs()), before.abs())).double()
    if mode == "change":
        bar = TRAIN_TOL["rtol"] * change + rounding
        if cond is not None:
            cond64 = cond.double()
            eps64 = (eps.double() if torch.is_tensor(eps)
                     else torch.tensor(eps, dtype=torch.float64))
            bar = torch.where(torch.isinf(cond64), math.inf,
                              bar + 2 * eps64 * cond64 * change)
    else:
        bar = TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * want64.abs()
        if cond is not None and lr is not None:
            bar = torch.where(cond > 1 / ILL_SCALE,
                              torch.full_like(bar, 1e-2 * lr), bar)
    bad = diff > bar
    if bool(bad.any()):
        i = int((diff - bar).flatten().argmax())
        cond_i = None if cond is None else cond.flatten()[i].item()
        raise SmokeFailure(
            f"{what}: {int(bad.sum())} of {diff.numel()} elements disagree "
            f"with the reference trainer; worst {diff.flatten()[i].item()} "
            f"against a change of {change.flatten()[i].item()} "
            f"(t/|g| {cond_i})")
    held = torch.isfinite(bar)
    err = diff[held].max().item() if bool(held.any()) else 0.0
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
                  mode, scale=None, lr=None, eps=None, table_cond=None):
    """Every trained array of the card's trainer against the CPU
    trainer's (`trained_arrays` of each, and of the card's before the
    steps), by `hold`: the touched table and state rows, which the kernels
    update, in `mode`; the MLPs by value (their gradients sum all 65,536
    rows of a batch, and where such a sum cancels, its change carries the
    low digits that cuBLAS's summation order and the CPU's set). `scale`:
    `gradient_scale` of the step, whose conditioning (t/|g|) `hold` turns
    into the wider bars of its docstring; adam's moments, held by value,
    never get it. `lr`: adam's, for its ill-element bar (None for sgd and
    adagrad). `eps`: per bucket, `hold`'s sum eps at the touched rows
    (None: SUM_EPS). `table_cond`: per bucket, t/|g| at the touched rows
    for a model without `gradient_scale` (DLRM: `contribution_cond`).
    Returns (max abs error, |change| of the touched table elements, how
    many of them moved past the rounding allowance)."""
    worst, table_change, moved = 0.0, [], 0

    def cond(name, rows=None):
        """t/|g| per element (0 without terms, infinite where terms cancel
        exactly), or None where the scale has none."""
        if scale is None or name not in scale:
            return None
        g, t = scale[name]
        if rows is not None:
            g, t = g.index_select(0, rows), t.index_select(0, rows)
        return torch.where(t > 0, t / g.abs(), torch.zeros_like(t))
    for name, got in after[0].items():
        err, _, _ = hold(torch, f"{label}: {name}", got, cpu_after[0][name],
                         before[0][name], steps, "value", cond(name), lr)
        worst = max(worst, err)
    for b, (got_b, want_b, before_b) in enumerate(zip(after[1], cpu_after[1],
                                                      before[1])):
        t_cond = (table_cond[b] if table_cond is not None
                  else cond(f"embedding.tp.{b}", touched[b]))
        eps_b = SUM_EPS if eps is None else eps[b]
        for i, (got, want, old) in enumerate(zip(got_b, want_b, before_b)):
            what = f"{label}: bucket {b} " + ("table" if i == 0
                                                else f"state {i - 1}")
            if i == 0:
                err, change, n = hold(torch, what, got, want, old, steps,
                                      mode, t_cond, lr, eps_b)
                worst = max(worst, err)
                table_change.append(change.flatten())
                moved += n
            else:
                # by change (adagrad's accumulator) with the table's
                # conditioning; by value (adam's moments) without
                hold(torch, what, got, want, old, steps, mode,
                     t_cond if mode == "change" else None, eps=eps_b)
    return worst, torch.cat(table_change), moved


def _dense_rows(args):
    """The table and the stream's ids of a `sparse_update._dense_update`
    call (kind, table, state, grad, lr): the dense route's touched rows,
    each id once per contribution."""
    return args[1], args[3].ids, True


def rows_capture(cuda_sparse, kind):
    """Where a step's touched rows show on the deduplicated-row route (the
    `<kind>_rows` call's table and rep) and on the dense route, which a
    bucket of at most `DENSE_ELEMS_MAX` elements takes under "auto" for
    adagrad and adam (`_dense_rows`)."""
    from distributed_embeddings_tpu_torch.ops import sparse_update
    i = {"sgd": 1, "adagrad": 2, "adam": 3}[kind]
    return [(cuda_sparse, f"{kind}_rows",
             lambda args: (args[0], args[i], False)),
            (sparse_update, "_dense_update", _dense_rows)]


def stream_capture(cuda_tiled, kind):
    """Where they show on the raw-stream route: the `<kind>_stream`
    call's table and sorted keys."""
    i = {"sgd": 2, "adagrad": 3, "adam": 4}[kind]
    return [(cuda_tiled, f"{kind}_stream",
             lambda args: (args[0], args[i], False))]


def sum_eps(torch, model, counts, touched):
    """Per bucket, `hold`'s sum eps at the touched rows, [rows, 1]: SUM_EPS,
    plus (n - 1) * 2^-24 on a row a dense aggregation summed from n
    contributions (the most over the steps, `run_trainer`'s counts). The
    card's ``index_add_`` adds them in its atomics' order, the CPU in the
    stream's: two orders of an n-term float32 sum differ by at most
    2 (n - 1) 2^-24 times the sum of the terms' magnitudes."""
    out = []
    for t, idx in zip(model.embedding.tp, touched):
        eps = torch.full((idx.numel(), 1), SUM_EPS, dtype=torch.float64)
        parts = counts.get(t.data_ptr(), [])
        if parts:
            n = torch.stack(parts).amax(0).index_select(0, idx).double()
            eps += ((n - 1).clamp_min(0) * 2.0 ** -24)[:, None]
        out.append(eps)
    return out


def contribution_cond(torch, model, calls, touched):
    """Per bucket, t/|g| at the touched rows from the CPU step's
    `dedup_sum` calls (`calls`: (positional, keyword) arguments of each:
    ids, contribs, sentinel): g the row's sum of contributions, t the sum of their
    magnitudes (0 without terms, infinite where they cancel exactly). The
    conditioning of the row sums alone, for a model without
    `gradient_scale` (DLRM): each contribution row is one sample's
    gradient, which the two trainers compute to a few ulps."""
    from distributed_embeddings_tpu_torch.ops.sparse_update import dedup_sum
    out = [torch.zeros((idx.numel(), 1), dtype=torch.float64)
           for idx in touched]
    for args, kwargs in calls:
        ids, contribs = args[:2]
        sentinel = kwargs["sentinel"] if "sentinel" in kwargs else args[2]
        b = [t.shape[0] for t in model.embedding.tp].index(sentinel)
        rep, g = dedup_sum(ids, contribs, sentinel)
        _, t = dedup_sum(ids, contribs.abs(), sentinel)
        valid = rep < sentinel
        rep, g, t = rep[valid].long(), g[valid].double(), t[valid].double()
        at = torch.searchsorted(rep, touched[b])
        check(bool((rep.index_select(0, at) == touched[b]).all()),
              "a touched row has no dedup segment on the CPU")
        g, t = g.index_select(0, at), t.index_select(0, at)
        out[b] = torch.where(t > 0, t / g.abs(), torch.zeros_like(t))
    return out


def train_against_cpu(torch, capture, kind, mode, step, model, state,
                      cpu_step, cpu_model, batches, scaled=None,
                      contrib=False):
    """Drive the card's trainer over `batches`, each step held against a
    CPU trainer started from the card's state before it (the model runs
    chaotically at lr 0.01: over several steps the two trainers' rounding
    differences grow until they move well-conditioned gradients too). The
    card's step runs first and names the rows the step touches (from the
    update kernel's calls, `capture`: `rows_capture` or `stream_capture`)
    and the ReLU masks of the MLP's hidden layers, which the CPU step then
    takes (`forced_relu`). The tables and their state are held in `mode`
    (`hold`), with `gradient_scale`'s conditioning on the CPU for adam and
    where `scaled` asks for it (True: every bucket; "dense": only the
    buckets the dense strategy updated, whose row sums the card's atomics
    add in their own order, the others keeping the plain bar), or, with
    `contrib`, the row sums' conditioning alone (`contribution_cond`).
    Returns the card's state and a dict of what was held."""
    from distributed_embeddings_tpu_torch.ops import sparse_update
    from distributed_embeddings_tpu_torch.training import gradient_scale
    out = dict(losses=[], cpu_losses=[], max_abs_err=0.0, changes=[],
               moved=0, touched=[], ill=0, with_gradient=0, relu_flips=[])
    for batch in batches:
        cpu_model.load_state_dict(model.state_dict())
        cpu_state = to_cpu(torch, state)
        (state, loss, touched, counts), masks = relu_masks(
            model, lambda: run_trainer(step, model, state, [batch], capture))
        touched = touched_rows(torch, model, touched)
        eps = sum_eps(torch, model, counts, touched)
        before = trained_arrays(torch, cpu_model, cpu_state, touched)
        with forced_relu(torch, cpu_model, masks) as flips:
            scale = (gradient_scale(cpu_model, *batch)
                     if (kind == "adam" if scaled is None else scaled)
                     else None)
            sums = Capture(sparse_update, "dedup_sum") if contrib else None
            with sums or contextlib.nullcontext():
                cpu_state, cpu_loss, _, _ = run_trainer(
                    cpu_step, cpu_model, cpu_state, [batch])
        table_cond = (contribution_cond(torch, cpu_model,
                                        zip(sums.calls, sums.kwargs),
                                        touched) if contrib else None)
        del sums, masks
        if scale is not None and scaled == "dense":
            scale = {k: v for k, v in scale.items()
                     if not k.startswith("embedding.tp.")
                     or model.embedding.tp[int(k.rsplit(".", 1)[1])]
                     .data_ptr() in counts}
        cpu_after = trained_arrays(torch, cpu_model, cpu_state, touched)
        del cpu_state
        err, change, moved = hold_trainers(
            torch, kind, trained_arrays(torch, model, state, touched),
            cpu_after, before, touched, 1, mode, scale,
            TRAIN_LR if kind == "adam" else None, eps, table_cond)
        out["relu_flips"].append(flips[-1])
        emit(phase="held_step", kind=kind, loss=loss[0], cpu_loss=cpu_loss[0],
             relu_flips=flips[-1])
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


def relu_groups(model):
    """The model's MLPs as (layers, how many of them a ReLU follows), in
    forward order: `SyntheticModel`'s `mlp` (all but its last layer);
    DLRM's `bottom_mlp` (every layer) and `top_mlp` (all but its last)."""
    if hasattr(model, "mlp"):
        return [(list(model.mlp), len(model.mlp) - 1)]
    return [(list(model.bottom_mlp), len(model.bottom_mlp)),
            (list(model.top_mlp), len(model.top_mlp) - 1)]


@contextlib.contextmanager
def forced_relu(torch, cpu_model, masks):
    """Within the block, every forward of the CPU model's MLPs takes the
    card's ReLU masks (`masks`: `relu_masks` of the card's step, one per
    layer a ReLU follows, `relu_groups`' order). A unit whose
    pre-activation z lies within rounding of 0 may take the other side on
    cuBLAS and on the CPU, and would change every gradient of its batch
    row; where the CPU's z takes the other side, it becomes |z| or -|z|,
    keeping z's gradient (z plus a detached correction, exactly z where
    nothing flips). A flip is a rounding difference only where |z| is
    within SUM_EPS of the sum t of its terms' magnitudes (the forward by
    absolute values from its MLP's input, under the card's masks): a flip
    past that fails the phase. Yields a list that gets each forward's
    count of flipped units."""
    groups = relu_groups(cpu_model)
    want = sum(n for _, n in groups)
    check(len(masks) == want,
          f"{len(masks)} ReLU masks from the card's step, want one per "
          f"layer a ReLU follows ({want})")
    flips, first_input = [], {}

    def hook(g, layers, base, i):
        def fn(mod, inp, z):
            if i == 0:
                first_input[g] = inp[0].detach()
                if g == 0:
                    flips.append(0)
            flip = (z > 0) != masks[base + i]
            if not bool(flip.any()):
                return None
            flips[-1] += int(flip.sum())
            rows = flip.any(dim=1).nonzero().flatten()
            t = first_input[g][rows].abs()
            for j in range(i + 1):
                t = t @ layers[j].w.detach().abs() + layers[j].b.detach().abs()
                if j < i:
                    t = t * masks[base + j][rows]
            zr = z.detach()[rows]
            past = flip[rows] & (zr.abs() > SUM_EPS * t)
            check(not bool(past.any()),
                  f"MLP {g} layer {i}: {int(past.sum())} ReLU units take the "
                  "other side on the card and on the CPU with |z| past "
                  f"{SUM_EPS} of its terms' magnitudes")
            target = torch.where(masks[base + i][rows],
                                 zr.abs().clamp_min(torch.finfo(z.dtype).tiny),
                                 -zr.abs())
            fix = torch.zeros_like(z)
            fix[rows] = torch.where(flip[rows], target - zr,
                                    torch.zeros_like(zr))
            return z + fix
        return fn
    hooks, base = [], 0
    for g, (layers, n) in enumerate(groups):
        hooks += [layer.register_forward_hook(hook(g, layers, base, i))
                  for i, layer in enumerate(layers[:n])]
        base += n
    try:
        yield flips
    finally:
        for h in hooks:
            h.remove()


def relu_masks(model, fn):
    """(fn(), the ReLU masks (z > 0, on the CPU) of the model's layers a
    ReLU follows (`relu_groups`) in every forward fn ran)."""
    masks = []
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out: masks.append((out > 0).cpu()))
        for layers, n in relu_groups(model) for layer in layers[:n]]
    try:
        result = fn()
    finally:
        for hook in hooks:
            hook.remove()
    return result, masks


def to_cpu(torch, tree):
    """A copy of an optimizer state on the CPU (ints kept)."""
    if isinstance(tree, dict):
        return {k: to_cpu(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(torch, v) for v in tree)
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def clone_tree(torch, tree):
    """A copy of an optimizer state on its device (ints kept)."""
    if isinstance(tree, dict):
        return {k: clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(torch, v) for v in tree)
    return tree.detach().clone() if torch.is_tensor(tree) else tree


def tree_tensors(torch, tree) -> list:
    """The tensors of a state tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_tensors(torch, tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(torch, v)]
    return [tree] if torch.is_tensor(tree) else []


def run_trainer(step, model, state, batches, capture=()):
    """Steps over `batches`; returns (state, losses, touched rows per table
    data pointer, dense counts per table data pointer): the rows recorded
    from the update kernels' calls (`capture`: (module, name, args ->
    (table, row keys, dense)) triples), and, for a dense route's call,
    each row's contribution count (a table-length tensor per call)."""
    losses = []
    touched: dict = {}
    counts: dict = {}
    caps = [Capture(module, name) for module, name, _ in capture]
    for cap in caps:
        cap.__enter__()
    try:
        for num, cats, labels in batches:
            _, state, loss = step(model, state, num, cats, labels)
            losses.append(float(loss))
    finally:
        for cap in caps:
            cap.__exit__()
    for cap, (_, _, rows_of) in zip(caps, capture):
        for args in cap.calls:
            table, keys, dense = rows_of(args)
            valid = keys[(keys >= 0) & (keys < table.shape[0])].long()
            touched.setdefault(table.data_ptr(), []).append(valid.cpu())
            if dense:
                counts.setdefault(table.data_ptr(), []).append(
                    valid.bincount(minlength=table.shape[0]).cpu())
    return state, losses, touched, counts


def touched_rows(torch, model, touched_by_ptr):
    """Per bucket of `model` (whose trainer `run_trainer` captured), the
    sorted unique rows its update kernels touched (CPU tensors)."""
    out = []
    for t in model.embedding.tp:
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


def time_row_calls(torch, cuda_sparse, kind, calls, rate, path=None):
    """The row kernel at the shapes of one step (one call per bucket):
    a check against its plain version on compact copies of the touched
    rows, then kernel / plain / library time and the bound (the timing
    runs update the tables). `path` names the step in the lines. Returns
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
        emit(phase=f"{kind}_rows_kernel", path=path, bucket=b,
             table=[vocab, width],
             slots=int(rep.numel()), unique_rows=u, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ok=True)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", max(bytes_ms, ops_ms)),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            totals[key] += val
    return totals, worst


def time_segment_calls(torch, cuda_sparse, calls, rate, path=None):
    """`segment_sum_sorted` at the shapes of one step (one call per
    bucket): the kernel bit-equal to its plain version on CPU copies of
    the same inputs, U, the longest segment, kernel / plain / `index_add_`
    time, the bound and `chain_ms` (the longest segment's chain of adds
    at the SM clock read while the kernel runs). `path` names the step
    in the lines. Returns (totals, worst abs error)."""
    from distributed_embeddings_tpu_torch.tools import segment_tail
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                  ops_ms=0.0, library_ms=0.0, chain_ms=0.0)
    worst = 0.0
    for b, (contribs, perm, starts) in enumerate(calls):
        n, width = contribs.shape
        got = cuda_sparse.segment_sum_sorted(contribs, perm, starts).cpu()
        want = cuda_sparse.segment_sum_sorted_plain(
            contribs.cpu(), perm.cpu(), starts.cpu())
        err = hold_segment_sum(torch, got, want)
        worst = max(worst, err)
        del got, want
        unique, longest = segment_tail.segment_stats(starts)
        seg = cuda_sparse._segment_ids(starts, n)
        seg_of_row = torch.empty_like(seg)
        seg_of_row[perm] = seg
        out = torch.zeros((n, width), device="cuda")
        ms = device_ms(lambda: cuda_sparse.segment_sum_sorted(
            contribs, perm, starts), reps=3)
        mhz = segment_tail.sm_clock_mhz(
            lambda: cuda_sparse.segment_sum_sorted(contribs, perm, starts))
        chain = segment_tail.chain_ms(longest, mhz)
        plain_ms = device_ms(lambda: cuda_sparse.segment_sum_sorted_plain(
            contribs, perm, starts), reps=3)
        library_ms = device_ms(
            lambda: out.index_add_(0, seg_of_row, contribs), reps=3)
        n_bytes = (contribs.numel() * 4 + perm.numel() * 8
                   + starts.numel() * 8 + n * width * 4)
        bytes_ms = n_bytes / rate * 1e3
        ops_ms = n * width / F32_FLOP_PER_S * 1e3
        emit(phase="segment_sum_kernel", path=path, bucket=b, rows=n,
             width=width,
             unique_rows=unique, longest_segment=longest, max_abs_err=err,
             ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
             bound_ms=max(bytes_ms, ops_ms), chain_ms=chain,
             sm_clock_mhz=mhz, bytes=n_bytes)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("chain_ms", chain or 0.0),
                         ("bound_ms", max(bytes_ms, ops_ms)),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            totals[key] += val
    return totals, worst


# device-time categories of a training step, by kernel name
CATEGORIES = (("lookup", ("lookup_combine",)),
              ("gather_sorted", ("gather_sorted",)),
              ("segment_sum", ("segment_sum_sorted",)),
              ("row_update", ("_rows_kernel",)),
              ("stream_update", ("_stream_kernel",)),
              ("sort", ("sort", "Sort", "radix", "Radix")),
              ("mlp_gemm", ("gemm", "Gemm", "xmma", "cutlass", "sm90")),
              ("host_to_device", ("HtoD",)),
              ("device_to_host", ("DtoH",)))


# the name prefix of `index_select_ranges`' profiler ranges
SELECT_RANGE = "index_select@"
# `ops.wire.EXCHANGE_RANGE`, the range of every exchange collective
# (phase 8; the top level imports no part of the package)
EXCHANGE_RANGE = "exchange:all_to_all"
# host ranges whose device-side spans are annotations, not device work
ANNOTATED_RANGES = (SELECT_RANGE, EXCHANGE_RANGE, "gloo:", "nccl:")


def by_category(by_kernel):
    """(device ms by CATEGORIES, the rest under "other"; the µs of each
    kernel in no category)."""
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
    return cats, other


PACKAGE = "distributed_embeddings_tpu_torch" + os.sep


@contextlib.contextmanager
def index_select_ranges(torch):
    """Within the block, every ``index_select`` call (the tensor method or
    ``torch.index_select``) runs inside a `record_function` range named
    for its caller: "index_select@<path>:<line> <function> [rows|vector]",
    the innermost frame of the port on the Python stack (path under the
    package) and the rank of the tensor it selects from (1-D: vector)."""
    from torch.profiler import record_function
    real = {"method": torch.Tensor.index_select,
            "function": torch.index_select}

    def caller():
        frame = sys._getframe(2)
        while frame is not None:
            path = frame.f_code.co_filename
            at = path.find(PACKAGE)
            if at >= 0:
                return (f"{path[at + len(PACKAGE):]}:{frame.f_lineno} "
                        f"{frame.f_code.co_name}")
            frame = frame.f_back
        return "outside the package"

    def ranged(fn):
        def select(x, *args, **kwargs):
            kind = "vector" if x.dim() == 1 else "rows"
            with record_function(f"{SELECT_RANGE}{caller()} [{kind}]"):
                return fn(x, *args, **kwargs)
        return select
    torch.Tensor.index_select = ranged(real["method"])
    torch.index_select = ranged(real["function"])
    try:
        yield
    finally:
        torch.Tensor.index_select = real["method"]
        torch.index_select = real["function"]


def index_select_split(prof) -> dict:
    """Device ms and calls of a run's ``index_select`` calls by caller,
    from the host side of `index_select_ranges`' ranges; the profile must
    have run inside them."""
    from torch.autograd import DeviceType
    split: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.name.startswith(
                SELECT_RANGE):
            continue
        key = e.name[len(SELECT_RANGE):]
        ms, calls = split.get(key, (0.0, 0))
        split[key] = (ms + e.device_time_total / 1e3, calls + 1)
    return {k: {"device_ms": ms, "calls": n}
            for k, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0])}


def profile_step(torch, step_once, label):
    """One step under torch.profiler (`profile_call`): device busy time,
    idle share, device time by category and kernel, host time by
    operator, the sorts it ran, and the device time of its
    ``index_select`` calls by caller (`index_select_ranges`,
    `index_select_split`). Returns the sort count."""
    with index_select_ranges(torch):
        busy_us, wall_us, device, prof, _ = profile_call(torch, step_once)
    sorts = top_level_sorts(prof)
    by_kernel = _by_name(device)
    cats, other = by_category(by_kernel)
    measured = bool(device)
    emit(phase="train_profile", path=label, wall_ms=wall_us / 1e3,
         device_events=len(device), sorts=sorts,
         device_busy_ms=busy_us / 1e3 if measured else None,
         device_idle_share=1 - busy_us / wall_us if measured else None,
         device_ms_by_category=cats,
         device_ms_by_kernel=[[n[:80], us / 1e3] for n, us in sorted(
             by_kernel.items(), key=lambda kv: -kv[1])[:12]],
         other_top=[[n[:80], us / 1e3] for n, us in sorted(
             other.items(), key=lambda kv: -kv[1])[:6]],
         index_select_by_caller=index_select_split(prof),
         host_self_ms_by_op=_host_ops(prof, top=10))
    return sorts


def hold_bit_equal(torch, name, got, want):
    """The bar for a sorted-stream kernel against its plain version: bit
    for bit (the largest ulp difference is printed on a failure). Returns
    the max absolute error."""
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        emit(phase="not_bit_equal", kernel=name, max_abs_err=err,
             max_ulp=max_ulp(torch, got, want))
        raise SmokeFailure(f"{name} differs from its plain version: {err}")
    return err


def gather_cases(torch, cuda_tiled, gen, vocab, n, width):
    """`gather_sorted` in both forms, weighted and not, int32 and int64
    keys, on the sort of a random stream with keys < 0 and >= V: the
    sorted form, and the perm form (rows at their places in the stream,
    weights in stream order) also against the sorted form's rows
    unpermuted. Returns the max absolute error."""
    table = torch.empty((vocab, width), device="cuda").uniform_(
        -0.05, 0.05, generator=gen)
    sid, perm = torch.sort(torch.randint(-3, vocab + 5, (n,), device="cuda",
                                         generator=gen), stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device="cuda")
    w = torch.rand((n,), device="cuda", generator=gen)
    worst = 0.0
    for key_dtype in (torch.int32, torch.int64):
        keys = sid.to(key_dtype)
        for weights in (None, w):
            got = cuda_tiled.gather_sorted(table, keys, weights)
            want = cuda_tiled.gather_sorted_plain(table, keys, weights)
            got_p = cuda_tiled.gather_sorted(table, keys, weights, perm=perm)
            want_p = cuda_tiled.gather_sorted_plain(table, keys, weights,
                                                    perm=perm)
            w_sorted = None if weights is None else weights[perm]
            old = cuda_tiled.gather_sorted(table, keys, w_sorted)[inv]
            torch.cuda.synchronize()
            worst = max(worst,
                        hold_bit_equal(torch, "gather_sorted", got, want),
                        hold_bit_equal(torch, "gather_sorted", got_p, want_p),
                        hold_bit_equal(torch, "gather_sorted", got_p, old))
    return worst


def sorted_kernel_cases(torch, cuda_tiled, embedding_ops, sparse_update):
    """Phase 3c: `gather_sorted` (`gather_cases`, at width 6 and at
    widths 8..256) and the three stream kernels (three accumulating steps
    on duplicate-heavy streams with ids out of range) bit-equal to their
    plain versions on the card at widths 8..256; both sorted lookups'
    forward and backward against the same calls on CPU copies. Returns
    the max absolute error per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    vocab, n = 5000, 20000
    worst = dict.fromkeys(["gather_sorted", "sgd_stream", "adagrad_stream",
                           "adam_stream", "lookups"], 0.0)
    errs = {"gather_sorted": gather_cases(torch, cuda_tiled, gen, vocab, n,
                                          6)}
    worst["gather_sorted"] = errs["gather_sorted"]
    emit(phase="sorted_kernel", width=6, ok=True, max_abs_err=errs)
    for width in SPARSE_WIDTHS:
        errs = {"gather_sorted": gather_cases(torch, cuda_tiled, gen, vocab,
                                              n, width)}
        for kind, n_state in (("sgd", 0), ("adagrad", 1), ("adam", 2)):
            table = torch.empty((vocab, width), device="cuda").uniform_(
                -0.05, 0.05, generator=gen)
            states = [torch.full_like(table, 0.1 if kind == "adagrad"
                                      else 0.0) for _ in range(n_state)]
            ref = [t.clone() for t in [table] + states]
            kernel = getattr(cuda_tiled, f"{kind}_stream")
            plain = getattr(cuda_tiled, f"{kind}_stream_plain")
            for step in range(1, 4):
                ids, contribs = _sparse_stream(torch, gen, vocab, n, width)
                gs = embedding_ops.canonical_id_sort(ids, vocab)
                starts, _ = embedding_ops.segment_bounds(gs.seg_start)
                args = (contribs, gs.sid, gs.perm, starts, TRAIN_LR)
                if kind == "adagrad":
                    args += (1e-7,)
                elif kind == "adam":
                    c1, c2 = sparse_update.bias_corrections(step, 0.9, 0.999)
                    args += (0.9, 0.999, 1e-8, c1, c2)
                kernel(table, *states, *args)
                plain(*ref, *args)
            torch.cuda.synchronize()
            errs[f"{kind}_stream"] = max(
                hold_bit_equal(torch, f"{kind}_stream", got, want)
                for got, want in zip([table] + states, ref))
        errs["lookups"] = lookup_backward_case(torch, cuda_tiled, gen, width)
        for key in worst:
            worst[key] = max(worst[key], errs[key])
        emit(phase="sorted_kernel", width=width, ok=True, max_abs_err=errs)
    return worst


def lookup_backward_case(torch, cuda_tiled, gen, width):
    """Both sorted lookups, sum and mean, weighted, at hotness 10 with ids
    out of range: forward, d/d table and d/d weights on the card against
    the same calls on CPU copies (plain versions). The table gradient of
    a sum bit for bit (`sgd_stream` at lr -1 adds in sorted order on
    both), the rest at KERNEL_TOL (hotness sums, einsums and the mean's
    weight sums run in each library's own order). Returns the max abs
    error."""
    vocab, batch, hot = 5000, 2048, 10
    table = torch.empty((vocab, width), device="cuda").uniform_(
        -0.05, 0.05, generator=gen)
    ids = torch.randint(-2, vocab + 2, (batch, hot), device="cuda",
                        generator=gen).int()
    weights = torch.rand((batch, hot), device="cuda", generator=gen)
    cot = torch.randn((batch, width), device="cuda", generator=gen)
    worst = 0.0
    for fn in (cuda_tiled.tiled_embedding_lookup,
               cuda_tiled.fused_lookup_combine):
        for combiner in ("sum", "mean"):
            outs = []
            for dev in ("cuda", "cpu"):
                t = table.to(dev).requires_grad_()
                w = weights.to(dev).requires_grad_()
                out = fn(t, ids.to(dev), w, combiner)
                dt, dw = torch.autograd.grad((out * cot.to(dev)).sum(),
                                             [t, w])
                outs.append([x.detach().cpu() for x in (out, dt, dw)])
            torch.cuda.synchronize()
            what = f"{fn.__name__} {combiner} w{width}"
            for name, got, want in zip(("forward", "dtable", "dweights"),
                                       *outs):
                err = (got - want).abs().max().item()
                if name == "dtable" and combiner == "sum":
                    check(torch.equal(got, want), f"{what} {name}: {err}")
                check(torch.allclose(got, want, **KERNEL_TOL),
                      f"{what} {name}: {err}")
                worst = max(worst, err)
    return worst


def top_level_sorts(prof) -> int:
    """Sorts in a profiled run: ``aten::sort`` events not inside another."""
    return sum(1 for e in prof.events() if e.name == "aten::sort"
               and (e.cpu_parent is None
                    or e.cpu_parent.name != "aten::sort"))


def profiled_sorts(torch, fn):
    """(fn(), the sorts it ran), under torch.profiler's CPU activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, top_level_sorts(prof)


def gather_bound(table, keys, weights, perm, rate, u):
    """(bytes_ms, ops_ms) of `gather_sorted`: the U distinct rows read,
    keys (and weights, and perm) read and the output written once; one
    multiply per element when weighted."""
    n, width = keys.numel(), table.shape[1]
    n_bytes = (u * width * 4 + n * keys.element_size()
               + (0 if weights is None else n * 4)
               + (0 if perm is None else n * 8) + n * width * 4)
    ops = 0 if weights is None else n * width
    return n_bytes / rate * 1e3, ops / F32_FLOP_PER_S * 1e3


def time_gather_calls(torch, cuda_tiled, calls, kwargs, rate, label):
    """`gather_sorted` at the shapes and in the form one step gives it
    (`calls` / `kwargs` of its captured calls: the perm form on both
    paths): bit-equal to its plain version, then kernel / plain / library
    time and the bound. The library call computes the same rows in
    stream order: `index_select` of the stream's ids unweighted,
    `F.embedding_bag` of them with bags of one and per-sample weights
    weighted. Beside them, ``sorted_store_ms``: the sorted form (rows in
    sorted order, the weights permuted beforehand, untimed) on the same
    keys, the kernel as the path called it before it stored rows at their
    places in the stream. Returns totals."""
    import torch.nn.functional as F
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                  ops_ms=0.0, library_ms=0.0, sorted_store_ms=0.0,
                  max_abs_err=0.0)
    for g, (args, kw) in enumerate(zip(calls, kwargs)):
        table, keys, weights = args + (None,) * (3 - len(args))
        perm = kw.get("perm")
        check(perm is not None, f"{label} call {g}: the path's gather "
                                "took no perm")
        got = cuda_tiled.gather_sorted(table, keys, weights, perm=perm)
        want = cuda_tiled.gather_sorted_plain(table, keys, weights,
                                              perm=perm)
        torch.cuda.synchronize()
        err = hold_bit_equal(torch, "gather_sorted", got, want)
        del got, want
        valid = bool(((keys >= 0) & (keys < table.shape[0])).all())
        check(valid, "a key of the path's gather lies outside the table")
        u = int(torch.unique_consecutive(keys).numel())
        ms = device_ms(lambda: cuda_tiled.gather_sorted(
            table, keys, weights, perm=perm), reps=20)
        plain_ms = device_ms(lambda: cuda_tiled.gather_sorted_plain(
            table, keys, weights, perm=perm), reps=5)
        w_sorted = None if weights is None else weights[perm]
        sorted_store_ms = device_ms(lambda: cuda_tiled.gather_sorted(
            table, keys, w_sorted), reps=20)
        stream_ids = torch.empty_like(keys)
        stream_ids[perm] = keys
        if weights is None:
            library_ms = device_ms(
                lambda: torch.index_select(table, 0, stream_ids), reps=20)
        else:
            offsets = torch.arange(keys.numel(), device="cuda",
                                   dtype=keys.dtype)
            library_ms = device_ms(lambda: F.embedding_bag(
                stream_ids, table, offsets, mode="sum",
                per_sample_weights=weights), reps=20)
        del w_sorted, stream_ids
        bytes_ms, ops_ms = gather_bound(table, keys, weights, perm, rate, u)
        emit(phase="gather_sorted_kernel", path=label, call=g,
             table=list(table.shape), rows=keys.numel(),
             weighted=weights is not None, unique_rows=u, max_abs_err=err,
             ms=ms, sorted_store_ms=sorted_store_ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
             bytes_ms=bytes_ms, ok=True)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms),
                         ("sorted_store_ms", sorted_store_ms),
                         ("bound_ms", max(bytes_ms, ops_ms)),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            totals[key] += val
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    return totals


def old_fused_composition(cuda_tiled, table, ids, weights, combiner,
                          presorted, inv):
    """The fused lookup's forward as it was composed before
    `gather_sorted` stored rows at their places in the stream: the same
    prologue, then the weights permuted into sorted order, the sorted
    gather, the unpermute by `inv`, the hotness sum."""
    b, k = ids.shape
    _, weights, (keys, perm) = cuda_tiled._combine_prologue(
        table, ids, weights, combiner, presorted)
    w_sorted = weights.reshape(-1).index_select(0, perm)
    rows = cuda_tiled.gather_sorted(table, keys, w_sorted)
    return rows.index_select(0, inv).reshape(b, k, -1).sum(dim=1)


def fused_against_lookup_combine(torch, cuda_tiled, cuda_lookup, calls,
                                 kwargs):
    """Per Tiny group of one fused step: the whole fused lookup with the
    step's folded sort (its sid and perm), the same without it (its own
    sort), the gather alone, `lookup_combine` on the same ids and
    weights, and the old composition (`old_fused_composition`, given the
    inverse permutation), held bit-equal to the new lookup: the before
    and after of the redesign, in one run. Beside them, the old
    composition's two `index_select` passes alone (the weight permutation
    and the unpermute) and the inverse permutation's own scatter, which
    the old forward's sort made; then the totals over the groups."""
    totals = dict(fused_folded_ms=0.0, old_composition_ms=0.0,
                  weight_permute_ms=0.0, unpermute_ms=0.0, inverse_ms=0.0)
    for g, (args, kw) in enumerate(zip(calls, kwargs)):
        table, ids, weights, combiner = args
        presorted = kw.get("presorted")
        check(presorted is not None and len(presorted) == 2,
              f"group {g} carried no folded (sid, perm)")
        want = cuda_lookup.lookup_combine(table, ids, weights)
        got = cuda_tiled.fused_lookup_combine(table, ids, weights, combiner,
                                              presorted=presorted)
        sid, perm = presorted
        keys = sid.clamp(max=table.shape[0] - 1)
        w_flat = weights.reshape(-1).contiguous()
        inv = torch.empty_like(perm)
        inverse = lambda: inv.index_put_(
            (perm,), torch.arange(perm.numel(), device="cuda"))
        inverse()
        old = old_fused_composition(cuda_tiled, table, ids, weights,
                                    combiner, presorted, inv)
        rows = cuda_tiled.gather_sorted(table, keys, w_flat[perm])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, **KERNEL_TOL),
              f"group {g}: fused lookup against lookup_combine: {err}")
        hold_bit_equal(torch, "fused lookup against its old composition",
                       got, old)
        del got, want, old
        times = dict(
            fused_folded_ms=device_ms(lambda: cuda_tiled.fused_lookup_combine(
                table, ids, weights, combiner, presorted=presorted), reps=10),
            old_composition_ms=device_ms(lambda: old_fused_composition(
                cuda_tiled, table, ids, weights, combiner, presorted, inv),
                reps=10),
            weight_permute_ms=device_ms(
                lambda: w_flat.index_select(0, perm), reps=10),
            unpermute_ms=device_ms(lambda: rows.index_select(0, inv),
                                   reps=10),
            inverse_ms=device_ms(inverse, reps=10))
        del rows
        for key, val in times.items():
            totals[key] += val
        emit(phase="fused_vs_lookup_combine", group=g,
             table=list(table.shape), ids=list(ids.shape),
             max_abs_err=err, old_bit_equal=True, **times,
             fused_unfolded_ms=device_ms(
                 lambda: cuda_tiled.fused_lookup_combine(table, ids, weights,
                                                         combiner), reps=10),
             gather_sorted_ms=device_ms(lambda: cuda_tiled.gather_sorted(
                 table, keys, w_flat, perm=perm), reps=10),
             lookup_combine_ms=device_ms(lambda: cuda_lookup.lookup_combine(
                 table, ids, weights), reps=10))
    emit(phase="fused_vs_old_total", groups=len(calls), **totals)


def stream_bound(kind, keys, width, u, rate):
    """(bytes_ms, ops_ms) of a stream kernel: contributions, keys, perm
    and starts read once; the U valid rows of the table and its state
    read and written once; one add per contribution element and about
    2/5/12 flops per row element (sgd/adagrad/adam)."""
    n = keys.numel()
    n_state = {"sgd": 0, "adagrad": 1, "adam": 2}[kind]
    n_bytes = (n * width * 4 + n * keys.element_size() + n * 8
               + (n + 1) * 8 + 8 * width * u * (1 + n_state))
    flops = (n * width
             + {"sgd": 2, "adagrad": 5, "adam": 12}[kind] * u * width)
    return n_bytes / rate * 1e3, flops / F32_FLOP_PER_S * 1e3


def time_stream_calls(torch, cuda_tiled, kind, calls, rate):
    """The stream kernel at the shapes of one step: bit-equal to its
    plain version on copies of the arrays, N, U and the longest segment,
    kernel / plain / library time (`index_add_` of the contributions
    scaled by -lr for sgd; none for adagrad and adam), the bound and
    `chain_ms`, as `time_segment_calls`. Returns totals."""
    from distributed_embeddings_tpu_torch.tools import segment_tail
    n_arrays = {"sgd": 1, "adagrad": 2, "adam": 3}[kind]
    kernel = getattr(cuda_tiled, f"{kind}_stream")
    plain = getattr(cuda_tiled, f"{kind}_stream_plain")
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                  ops_ms=0.0, library_ms=0.0 if kind == "sgd" else None,
                  max_abs_err=0.0, chain_ms=0.0)
    for c, args in enumerate(calls):
        arrays, rest = args[:n_arrays], args[n_arrays:]
        contribs, keys, perm, starts = rest[:4]
        vocab, width = arrays[0].shape
        got = [a.clone() for a in arrays]
        want = [a.clone() for a in arrays]
        kernel(*got, *rest)
        plain(*want, *rest)
        torch.cuda.synchronize()
        err = max(hold_bit_equal(torch, f"{kind}_stream", a, b)
                  for a, b in zip(got, want))
        del want
        u, longest = segment_tail.segment_stats(starts)
        ms = device_ms(lambda: kernel(*got, *rest), reps=3)
        mhz = segment_tail.sm_clock_mhz(lambda: kernel(*got, *rest))
        chain = segment_tail.chain_ms(longest, mhz)
        plain_ms = eager_ms(lambda: plain(*got, *rest), reps=3)
        library_ms = None
        if kind == "sgd":
            ids = torch.empty_like(keys)
            ids[perm] = keys
            library_ms = device_ms(lambda: got[0].index_add_(
                0, ids, contribs, alpha=-rest[4]), reps=3)
            totals["library_ms"] += library_ms
        del got
        bytes_ms, ops_ms = stream_bound(kind, keys, width, u, rate)
        emit(phase=f"{kind}_stream_kernel", call=c, table=[vocab, width],
             rows=keys.numel(), unique_rows=u, longest_segment=longest,
             max_abs_err=err, ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
             chain_ms=chain, sm_clock_mhz=mhz, bytes_ms=bytes_ms,
             ops_ms=ops_ms, ok=True)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("chain_ms", chain or 0.0),
                         ("bound_ms", max(bytes_ms, ops_ms)),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            totals[key] += val
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    return totals


def step_time(torch, step, model, state, batches, label):
    """Median of 10 synchronized steps after 2 warm ones, samples/s and
    peak memory since the last reset. Returns the state."""
    times = []
    for i in range(12):
        num, cats, labels = batches[i % len(batches)]
        t0 = time.perf_counter()
        _, state, loss = step(model, state, num, cats, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times[2:])
    emit(phase="train_step_time", path=label, batch=BATCH,
         median_ms=med * 1e3, min_ms=min(times[2:]) * 1e3,
         max_ms=max(times[2:]) * 1e3, samples_per_s=BATCH / med,
         final_loss=float(loss),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return state


def ladder_work(rung, args):
    """(bytes, float32 operations) the rung's function needs on `args`
    (the JAX rung's inputs): each input byte it reads once, each output
    byte written once; gathered rows counted once each."""
    row = args[-1].shape[1] * 4
    if rung == "vmem":
        return 2 * args[0].numel() * 4, args[0].numel()
    if rung == "anyspace":              # zeros; the table is not read
        return 256 * row, 0
    if rung == "dma":                   # t[0:256] read, out written
        return 2 * 256 * row, 0
    if rung in ("dyn_dma", "prefetch", "loop_dma"):
        ids = args[0][:1] if rung == "dyn_dma" else args[0]
        unique = int(ids.unique().numel())
        out_rows = 1 if rung != "prefetch" else ids.numel()
        adds = (ids.numel() - 1) * row // 4 if rung == "loop_dma" else 0
        return ids.numel() * 4 + unique * row + out_rows * row, adds
    if rung == "blockspec_gather":      # tof, cof, the chunks, hp, the tile
        tof, cof, ids, _, _ = args
        steps, chunk = tof.numel(), ids.shape[1]
        chunks = int(cof.unique().numel())
        tile = 8 * row
        return (2 * steps * 4 + chunks * chunk * 4 + 4 + 2 * tile,
                steps * chunk + 2 * steps * 8 + tile // 4)
    raise KeyError(rung)


def ladder_library(torch, rung, args):
    """One PyTorch call computing the rung's function (a yardstick only)."""
    if rung == "anyspace":
        out = torch.empty((256, args[0].shape[1]), device=args[0].device)
        return out.zero_
    if rung == "vmem":
        return lambda: torch.mul(args[0], 2.0)
    if rung == "dma":
        out = torch.empty((256, args[0].shape[1]), device=args[0].device)
        return lambda: out.copy_(args[0][:256])
    if rung in ("dyn_dma", "prefetch"):
        ids = args[0][:1] if rung == "dyn_dma" else args[0]
        return lambda: torch.index_select(args[1], 0, ids)
    if rung == "loop_dma":
        return lambda: torch.index_select(args[1], 0, args[0]).sum(0)
    if rung == "blockspec_gather":
        # table rows of tile tof[-1] += hp once per occurrence
        tof, cof, ids, hp, table = args
        rows = []
        for t, c in zip(tof.tolist(), cof.tolist()):
            local = ids[c].long() - t * 8
            rows.append(local[(local >= 0) & (local < 8)] + tof[-1] * 8)
        rows = torch.cat(rows)
        src = hp.reshape(1, 1).expand(rows.numel(), table.shape[1])
        work = table.clone()
        return lambda: work.index_add_(0, rows, src)
    raise KeyError(rung)


def ladder_kernels(torch, probe, rate):
    """Phase 2a timing: each rung kernel at the JAX rung's inputs, device
    ms per launch (CUDA graph replays) beside its plain version (eager),
    one library call and its bound. Returns totals per kernel."""
    totals = {}
    for rung, (kernel, fn, plain, _) in probe.KERNEL_RUNGS.items():
        args = [torch.from_numpy(a).cuda() for a in probe.rung_inputs(rung)]
        n_bytes, n_ops = ladder_work(rung, args)
        ms = device_ms(lambda: fn(*args), reps=100)
        plain_ms = eager_ms(lambda: plain(*args), reps=20)
        library_ms = device_ms(ladder_library(torch, rung, args), reps=100)
        bytes_ms = n_bytes / rate * 1e3
        ops_ms = n_ops / F32_FLOP_PER_S * 1e3
        totals[kernel] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=max(bytes_ms, ops_ms),
                              bytes_ms=bytes_ms, ops_ms=ops_ms)
        emit(phase="ladder_kernel", rung=rung, kernel=kernel, bytes=n_bytes,
             operations=n_ops, **totals[kernel])
    return totals


# ---- phase 8: world size > 1
# (config, world, model kwargs, train strategy): Tiny through the
# gather-combine kernel and the deduplicated rows, criteo through the
# sorted-stream lookup and the raw-stream update
WORLD_RUNS = (("tiny", 2, {}, "auto"),
              ("criteo", 4, {"lookup_path": "tiled"}, "tiled"))
WORLD_SEED = 7
WORLD_TIMED_STEPS = 10
WORLD_JOIN_S = 600
# how far a device interval may lie outside its rank's host window (the
# profiler's conversion of the card's timestamps to the host clock)
CLOCK_SLACK_US = 1000.0


def table_rows(torch, strat, gtid, seed, device):
    """Table `gtid` of a plan's tables, whole, drawn from seed + gtid:
    uniform +-0.05, like the model's initializer."""
    cfg = strat.global_configs[gtid]
    gen = torch.Generator(device=device).manual_seed(seed + gtid)
    return torch.empty((cfg["input_dim"], cfg["output_dim"]),
                       device=device).uniform_(-0.05, 0.05, generator=gen)


def seed_weights(torch, model, seed):
    """The same weights at every world size, no weight file written: each
    table this rank holds (`table_rows`, by its index in the model) copied
    into its bucket rows; MLP parameter i from seed + 10,000 + i,
    glorot-normal kernels and N(0, 1/out) biases like `Dense`."""
    layer = model.embedding
    strat = layer.strategy
    with torch.no_grad():
        for pl_ in layer.plan.tp_placements:
            if pl_.rank != layer.rank:
                continue
            rows = table_rows(torch, strat,
                              strat.table_groups[1][pl_.table_id], seed,
                              layer.device)
            layer.tp[pl_.bucket][pl_.row_offset:pl_.row_offset
                                 + pl_.rows].copy_(
                rows[:, pl_.col_start:pl_.col_end])
        dense = [p for p in model.parameters() if p.requires_grad]
        for i, p in enumerate(dense):
            gen = torch.Generator(device=p.device).manual_seed(
                seed + 10_000 + i)
            std = (math.sqrt(2.0 / sum(p.shape)) if p.dim() == 2
                   else math.sqrt(1.0 / p.shape[0]))
            p.normal_(0.0, std, generator=gen)


def world_rank(rank, world, name, backend, init_method, out_dir, model_kw,
               strategy):
    """One rank of phase 8, in a process of its own (torch.multiprocessing,
    spawn): the gloo or NCCL exchange probed on CUDA tensors, then the
    config built at full width with `seed_weights`, its forward before any
    step saved, 3 held adagrad steps over this rank's slices of the global
    batches (launches counted), the touched rows of its tables and its MLP
    saved (and the MLP and its optimizer state before each step), then
    the step timed and profiled. Everything it measured goes
    to ``out_dir/rank<r>.pt``; a failure raises, and the parent's join
    raises it again."""
    import torch
    check("jax" not in sys.modules, f"rank {rank} imported jax")
    import torch.distributed as dist
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.ops import (cuda_lookup, cuda_sparse,
                                                      cuda_tiled,
                                                      sparse_update, wire)
    from distributed_embeddings_tpu_torch.parallel.mesh import (
        initialize_distributed)
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager, stage_dp_batch)
    from distributed_embeddings_tpu_torch.tools import cuda_feature_probe
    from distributed_embeddings_tpu_torch.training import (
        evaluate, make_sparse_train_step)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (world + 1)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    initialize_distributed(backend, init_method, world, rank)
    try:
        # the exchange on CUDA tensors first: ids and floats, block d of
        # rank r holding 100 r + 3 d + j
        ids = (torch.arange(world * 3, dtype=torch.int32, device=dev)
               .reshape(world, 3) + 100 * rank)
        got_ids = wire.wire_id_all_to_all(ids)
        got_vals = wire.wire_all_to_all(ids.float() * 0.5)
        want = torch.stack([torch.arange(3, dtype=torch.int32, device=dev)
                            + 3 * rank + 100 * s for s in range(world)])
        check(torch.equal(got_ids, want)
              and torch.equal(got_vals, want.float() * 0.5),
              f"rank {rank}: the {backend} all_to_all of CUDA tensors gave "
              f"{got_ids.tolist()} and {got_vals.tolist()}, want "
              f"{want.tolist()}")
        out = {"rank": rank, "device": str(dev), "probe_ok": True}
        cfg = SYNTHETIC_MODELS[name]
        t0 = time.perf_counter()
        global_batches = list(InputGenerator(cfg, BATCH, alpha=1.05,
                                             num_batches=TRAIN_STEPS, seed=0))
        stager = DeviceStager(dev)       # the rank's own
        batches = [stage_dp_batch(b, stager) for b in global_batches]
        model = SyntheticModel(cfg, device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(rank), **model_kw)
        seed_weights(torch, model, WORLD_SEED)
        layer = model.embedding
        out["setup_s"] = time.perf_counter() - t0
        out["table_bytes"] = sum(t.numel() * 4 for t in layer.tp)
        with torch.no_grad():
            torch.save(torch.cat(layer(batches[0][1]), dim=1).cpu(),
                       os.path.join(out_dir, f"forward{rank}.pt"))
        # the streaming AUC over the global batches before any step (each
        # rank its slice, the histograms summed over the ranks)
        out["eval_auc"] = evaluate(model, lambda s: global_batches[s],
                                   steps=TRAIN_STEPS)
        init, step = make_sparse_train_step(model, "adagrad", lr=TRAIN_LR,
                                            strategy=strategy)
        state = init(model)
        capture = (stream_capture(cuda_tiled, "adagrad")
                   if strategy == "tiled"
                   else rows_capture(cuda_sparse, "adagrad"))
        counted = (cuda_sparse, cuda_tiled, cuda_feature_probe)
        set_counts(cuda_lookup, *counted)
        losses, touched, dense_before = [], {}, []
        for batch in batches:
            dense_before.append(to_cpu(torch, (
                {n: p for n, p in model.named_parameters()
                 if p.requires_grad}, state["dense"])))
            state, loss, step_rows, _ = run_trainer(step, model, state,
                                                    [batch], capture)
            losses += loss
            for ptr, parts in step_rows.items():
                touched.setdefault(ptr, []).extend(parts)
        torch.cuda.synchronize()
        out["launches"] = read_counts(cuda_lookup, *counted)
        out["losses"] = losses
        out["dense_before"] = dense_before
        key = tuple((c.shape[1], False) for c in batches[0][1])
        groups, _ = layer._exchange_groups_for_key(key)
        out["groups"] = len(groups)
        buckets = {g.bucket for g in groups}
        out["buckets"] = len(buckets)
        # the buckets whose update takes the deduplicated-row route (the
        # rest, under "auto", the dense one)
        out["sort_buckets"] = sum(
            sparse_update._pick(strategy, *layer.tp[b].shape) != "dense"
            for b in buckets)
        rows = touched_rows(torch, model, touched)
        tables = {}
        for pl_ in layer.plan.tp_placements:
            if pl_.rank != rank:
                continue
            idx = rows[pl_.bucket]
            idx = idx[(idx >= pl_.row_offset)
                      & (idx < pl_.row_offset + pl_.rows)]
            on_dev = idx.to(dev)
            tables[layer.strategy.table_groups[1][pl_.table_id]] = (
                idx - pl_.row_offset,
                layer.tp[pl_.bucket].detach().index_select(0, on_dev).cpu(),
                state["emb"]["tp"][pl_.bucket][0].index_select(
                    0, on_dev).cpu())
        out["tables"] = tables
        out["mlp"] = {n: p.detach().cpu().clone() for n, p in
                      model.named_parameters() if p.requires_grad}
        times = []
        for i in range(2 + WORLD_TIMED_STEPS):
            num, cats, labels = batches[i % TRAIN_STEPS]
            t0 = time.perf_counter()
            _, state, loss = step(model, state, num, cats, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["step_ms"] = [t * 1e3 for t in times[2:]]
        holder = {"state": state}
        del state

        def step_once():
            holder["state"] = step(model, holder["state"], *batches[0])[1]
        check(wire.EXCHANGE_RANGE == EXCHANGE_RANGE,
              f"ops.wire names its range {wire.EXCHANGE_RANGE!r}, this "
              f"script reads {EXCHANGE_RANGE!r}")
        busy_us, wall_us, device, prof, window = profile_call(torch,
                                                              step_once)
        from torch.autograd import DeviceType
        by_kernel = _by_name(device)
        host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        ranges = [e for e in host if e.name == EXCHANGE_RANGE]
        # per group: the ids, the activations, their gradients back (the
        # synthetic inputs carry no weights, which would add one)
        check(len(ranges) == 3 * out["groups"],
              f"rank {rank}: {len(ranges)} exchange collectives in a step, "
              f"want 3 a group x {out['groups']} groups")
        collectives: dict = {}
        for e in host:
            if e.name.startswith(("gloo:", "nccl:")):
                ms, n = collectives.get(e.name, (0.0, 0))
                collectives[e.name] = (ms + e.cpu_time_total / 1e3, n + 1)
        cats, _ = by_category(by_kernel)
        origin = prof.profiler.kineto_results.trace_start_ns() / 1e3
        out["window_us"] = window
        out["device_intervals_us"] = [
            (origin + e.time_range.start, origin + e.time_range.end)
            for e in device]
        out["profile"] = dict(
            wall_ms=wall_us / 1e3,
            # this rank's own device work over its own wall time; the
            # ranks share the card, whose idle share `world_phase` reads
            # from every rank's intervals merged
            rank_device_busy_ms=busy_us / 1e3,
            rank_device_busy_share=busy_us / wall_us,
            device_ms_by_category=cats,
            # gloo stages every collective through pinned host memory and
            # the port pins none: the pinned copies are the collectives'
            # device time (the other host copies are not)
            collective_copies_ms=sum(
                us for n, us in by_kernel.items()
                if n.startswith("Memcpy") and "Pinned" in n) / 1e3,
            device_ms_by_kernel=[[n[:80], us / 1e3] for n, us in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:12]],
            exchange_calls=len(ranges),
            exchange_host_ms=sum(e.cpu_time_total for e in ranges) / 1e3,
            collective_host_ms={k: {"ms": ms, "calls": n} for k, (ms, n)
                                in collectives.items()})
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        check("jax" not in sys.modules, f"rank {rank} imported jax")
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def card_profile(ranks):
    """The card's busy time and idle share over the ranks' profiled step:
    every rank's device intervals merged (processes time-slice the card),
    over the union of the ranks' windows, both on the Unix clock of the
    profiler's traces. Device work a rank did outside its own window is
    not traced, so the idle share is an upper bound. None where a rank's
    intervals fall outside its window by more than CLOCK_SLACK_US: the
    traces' clocks then disagree with the host's."""
    start = min(r["window_us"][0] for r in ranks)
    end = max(r["window_us"][1] for r in ranks)
    aligned = all(r["window_us"][0] - CLOCK_SLACK_US <= a
                  and b <= r["window_us"][1] + CLOCK_SLACK_US
                  for r in ranks for a, b in r["device_intervals_us"])
    busy = busy_union(iv for r in ranks for iv in r["device_intervals_us"])
    return dict(window_ms=(end - start) / 1e3,
                clocks_aligned=aligned,
                card_busy_ms=busy / 1e3 if aligned else None,
                card_idle_share=1 - busy / (end - start) if aligned
                else None,
                rank_busy_ms_sum=sum(r["profile"]["rank_device_busy_ms"]
                                     for r in ranks))


def world_phase(torch, name, world, model_kw, strategy):
    """Phase 8 for one config: `world` ranks (`world_rank`) on the card(s),
    then the port's world-1 trainer in this process over the same global
    batches and weights, each step from rank 0's dense state before it;
    every rank held against it. Returns the launch counts of the ranks'
    held steps, summed over the ranks."""
    import torch.multiprocessing as torch_mp
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.ops import cuda_sparse, cuda_tiled
    from distributed_embeddings_tpu_torch.training import (
        evaluate, gradient_scale, make_sparse_train_step)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    label = f"world{world}_{name}"
    emit(phase="world_setup", path=label, config=name, world=world,
         backend=backend, device_count=cards,
         **({} if backend == "nccl" else
            {"nccl": f"not run: {cards} card" + ("s" if cards > 1 else "")}))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world")
    try:
        t0 = time.perf_counter()
        ctx = torch_mp.start_processes(
            world_rank, args=(world, name, backend, f"file://{tmp}/pg", tmp,
                              model_kw, strategy),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + WORLD_JOIN_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline,
                      f"{label}: the ranks did not finish in {WORLD_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
        ranks_s = time.perf_counter() - t0

        # the world-1 trainer on this card: the same weights and batches
        t0 = time.perf_counter()
        cfg = SYNTHETIC_MODELS[name]
        batches = list(InputGenerator(cfg, BATCH, alpha=1.05,
                                      num_batches=TRAIN_STEPS, seed=0))
        model = SyntheticModel(cfg, device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(0), **model_kw)
        seed_weights(torch, model, WORLD_SEED)
        layer = model.embedding
        with torch.no_grad():
            fwd = torch.cat(layer(batches[0][1]), dim=1)
        b_l = BATCH // world
        identical, fwd_err = True, 0.0
        for r in range(world):
            got = torch.load(os.path.join(tmp, f"forward{r}.pt")).cuda()
            want = fwd[r * b_l:(r + 1) * b_l]
            check(got.shape == want.shape,
                  f"{label}: rank {r} forward {tuple(got.shape)}, want "
                  f"{tuple(want.shape)}")
            identical = identical and torch.equal(got, want)
            fwd_err = max(fwd_err, (got - want).abs().max().item())
            check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
                  f"{label}: rank {r}'s forward disagrees with world 1 by "
                  f"{fwd_err}")
        del fwd, got, want
        emit(phase="world_forward", path=label, bit_identical=identical,
             max_abs_err=fwd_err)
        # `evaluate` on the same weights and batches: each rank's AUC (its
        # slices' histograms summed over the ranks) equals world 1's to
        # the bit: the forwards are bit-identical and the counts exact
        auc1 = evaluate(model, lambda s: batches[s], steps=TRAIN_STEPS)
        emit(phase="world_evaluate", path=label, world1_auc=auc1,
             rank_auc=[r["eval_auc"] for r in ranks])
        check(all(r["eval_auc"] == auc1 for r in ranks),
              f"{label}: the ranks' AUCs {[r['eval_auc'] for r in ranks]} "
              f"against world 1's {auc1}")
        init, step = make_sparse_train_step(model, "adagrad", lr=TRAIN_LR,
                                            strategy=strategy)
        state = init(model)
        capture = (stream_capture(cuda_tiled, "adagrad")
                   if strategy == "tiled"
                   else rows_capture(cuda_sparse, "adagrad"))
        strat = layer.strategy
        placed = {strat.table_groups[1][pl_.table_id]: pl_
                  for pl_ in layer.plan.tp_placements}
        # each step's conditioning (t/|g|, `gradient_scale`) at the rows the
        # ranks hold, the largest over the steps: the worlds' terms differ
        # in their last digits (other gemm shapes, the ranks' all-reduce),
        # which moves a gradient that is a sum that cancels by a share of
        # itself
        cond: dict = {}
        losses, touched, counts = [], {}, {}
        dense = {n: p for n, p in model.named_parameters()
                 if p.requires_grad}
        for s, batch in enumerate(batches):
            # the step starts from rank 0's MLP and dense optimizer state
            # before it, as phase 5's CPU trainer starts from the card's
            mlp_r, dense_state_r = ranks[0]["dense_before"][s]
            with torch.no_grad():
                for n, p in dense.items():
                    p.copy_(mlp_r[n])
                for n, a in state["dense"]["sum_of_squares"].items():
                    a.copy_(dense_state_r["sum_of_squares"][n])
            scale = gradient_scale(model, *batch)
            for r in ranks:
                for gtid, (idx, _, _) in r["tables"].items():
                    pl_ = placed[gtid]
                    g, t = scale[f"embedding.tp.{pl_.bucket}"]
                    at = (idx + pl_.row_offset).cuda()
                    g, t = g.index_select(0, at), t.index_select(0, at)
                    c = torch.where(t > 0, t / g.abs(),
                                    torch.zeros_like(t)).cpu()
                    cond[gtid] = (c if gtid not in cond
                                  else torch.maximum(cond[gtid], c))
            del scale, g, t
            state, loss, step_rows, step_counts = run_trainer(
                step, model, state, [batch], capture)
            losses += loss
            for ptr, parts in step_rows.items():
                touched.setdefault(ptr, []).extend(parts)
            for ptr, parts in step_counts.items():
                counts.setdefault(ptr, []).extend(parts)
        torch.cuda.synchronize()
        rows1 = touched_rows(torch, model, touched)
        # per bucket, the most contributions a row took in a step of the
        # dense route (both worlds sum them by atomics)
        most = {b: torch.stack(counts[t.data_ptr()]).amax(0)
                for b, t in enumerate(layer.tp) if t.data_ptr() in counts}

        # launches a step, from each rank's plan
        want_kernels = ({"gather_sorted": "groups",
                         "adagrad_stream": "buckets"} if strategy == "tiled"
                        else {"lookup_combine": "groups",
                              "segment_sum_sorted": "sort_buckets",
                              "adagrad_rows": "sort_buckets"})
        summed = dict.fromkeys(ALL_KERNELS, 0)
        for r in ranks:
            want_r = {k: r[v] for k, v in want_kernels.items()}
            check(r["launches"] == per_step(want_r, TRAIN_STEPS),
                  f"{label}: rank {r['rank']} launches {r['launches']}, "
                  f"want {want_r} per step")
            for k, v in r["launches"].items():
                summed[k] += v
        # losses, MLPs (the same on every rank), touched rows by change
        for r in ranks:
            check(torch.allclose(torch.tensor(r["losses"]),
                                 torch.tensor(losses), **LOSS_TOL),
                  f"{label}: rank {r['rank']} losses {r['losses']}, world "
                  f"1 {losses}")
            for n, p in r["mlp"].items():
                check(torch.equal(p, ranks[0]["mlp"][n]),
                      f"{label}: rank {r['rank']}'s {n} differs from rank "
                      "0's")
        worst = 0.0
        for n, p in dense.items():
            err, _, _ = hold(torch, f"{label}: {n}", ranks[0]["mlp"][n],
                             p.detach().cpu(), mlp_r[n], 1, "value")
            worst = max(worst, err)
        held_rows, changes, moved = 0, [], 0
        for r in ranks:
            for gtid, (idx, vals, acc) in r["tables"].items():
                pl_ = placed[gtid]
                on_dev = (idx + pl_.row_offset).cuda()
                one = rows1[pl_.bucket]
                one = one[(one >= pl_.row_offset)
                          & (one < pl_.row_offset + pl_.rows)]
                check(bool(torch.isin(one - pl_.row_offset, idx).all()),
                      f"{label}: table {gtid}: world 1 touched rows rank "
                      f"{r['rank']} did not")
                before = table_rows(torch, strat, gtid, WORLD_SEED,
                                    "cuda").index_select(0, idx.cuda()).cpu()
                eps = SUM_EPS
                if pl_.bucket in most:
                    n_row = most[pl_.bucket].index_select(
                        0, (idx + pl_.row_offset)).double()
                    eps = (SUM_EPS + (n_row - 1).clamp_min(0)
                           * 2.0 ** -24)[:, None]
                err, change, n = hold(
                    torch, f"{label}: table {gtid}", vals,
                    layer.tp[pl_.bucket].detach().index_select(
                        0, on_dev).cpu(), before, TRAIN_STEPS, "change",
                    cond[gtid], eps=eps)
                hold(torch, f"{label}: table {gtid} accumulator", acc,
                     state["emb"]["tp"][pl_.bucket][0].index_select(
                         0, on_dev).cpu(), torch.full_like(acc, 0.1),
                     TRAIN_STEPS, "change", cond[gtid], eps=eps)
                worst = max(worst, err)
                changes.append(change.flatten())
                moved += n
                held_rows += int(idx.numel())
        check(len(placed) == sum(len(r["tables"]) for r in ranks),
              f"{label}: the ranks hold {sum(len(r['tables']) for r in ranks)}"
              f" tables, the model has {len(placed)}")
        change = torch.cat(changes)
        emit(phase="main_path", path=label, backend=backend, world=world,
             steps=TRAIN_STEPS, ranks_seconds=ranks_s,
             world1_seconds=time.perf_counter() - t0,
             launches_by_rank=[r["launches"] for r in ranks],
             launches_per_step_from_plan={k: ranks[0][v] for k, v in
                                          want_kernels.items()},
             losses=ranks[0]["losses"], world1_losses=losses,
             max_abs_err=worst, touched_rows_held=held_rows,
             table_change_median=change.median().item(),
             table_change_max=change.max().item(),
             table_changes_past_rounding=moved, ok=True)
        del model, layer, state, change, changes
        torch.cuda.empty_cache()
        for r in ranks:
            med = statistics.median(r["step_ms"])
            emit(phase="world_step_time", path=label, rank=r["rank"],
                 backend=backend, device=r["device"], median_ms=med,
                 min_ms=min(r["step_ms"]), max_ms=max(r["step_ms"]),
                 samples_per_s=BATCH / (med / 1e3),
                 setup_s=r["setup_s"], table_bytes=r["table_bytes"],
                 max_memory_allocated=r["max_memory_allocated"])
            emit(phase="world_profile", path=label, rank=r["rank"],
                 backend=backend, **r["profile"])
        if backend == "gloo":
            # the ranks share one card
            emit(phase="world_card_profile", path=label, backend=backend,
                 **card_profile(ranks))
        return summed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- the eighth slice: DLRM trained and evaluated through `fit`, the
# dense path, the convergence demo
DLRM_TABLE_SCALE = 0.4        # 38.5 GB of tables; the full 96.1 GB do not fit
DLRM_CPU_SCALE = 0.02         # 1.92 GB: the CPU trainer's copy stays under 2
DLRM_SEED = 11
DLRM_FIT_STEPS = 12
DLRM_EVAL_EVERY = 6
DLRM_EVAL_STEPS = 4
DLRM_PROFILED_STEP = 2        # the window runs from its end to the next's
# the DLRM example's defaults: make_lr_schedule(24.0, 8000, 48000, 24000)
DLRM_LR = (24.0, 8000, 48000, 24000)
AUC_EXACT_TOL = 1e-3
CONVERGENCE = dict(steps=1500, batch=512, eval_every=250, eval_steps=8,
                   lr=0.08)
CONVERGENCE_AUC = 0.70        # tests/test_convergence.py's threshold


def write_split_binary(root, split, batches, sizes):
    """`batches` (ClickGenerator's) in the Criteo split-binary layout under
    root/split: label.bin (bool), numerical.bin (float16), cat_<i>.bin (the
    smallest int dtype that holds table i)."""
    import numpy as np
    from distributed_embeddings_tpu_torch.models.data import (
        get_categorical_feature_type)
    base = os.path.join(root, split)
    os.makedirs(base, exist_ok=True)
    np.concatenate([b[2] for b in batches]).astype(np.bool_).tofile(
        os.path.join(base, "label.bin"))
    np.concatenate([b[0] for b in batches]).astype(np.float16).tofile(
        os.path.join(base, "numerical.bin"))
    for i, size in enumerate(sizes):
        np.concatenate([b[1][i] for b in batches]).astype(
            get_categorical_feature_type(size)).tofile(
            os.path.join(base, f"cat_{i}.bin"))


def table_digest(torch, t):
    """An exact fingerprint of a float32 table: the wrapping int64 sum of
    its bit patterns times odd weights that differ by position (row
    chunks of 2^24 elements); any one element's change moves it."""
    rows, width = t.shape
    chunk = max(1, (1 << 24) // width)
    col = torch.arange(width, device=t.device, dtype=torch.int64) * 2 + 1
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        bits = t[r0:r1].detach().view(torch.int32).to(torch.int64)
        weight = (torch.arange(r0, r1, device=t.device,
                               dtype=torch.int64)[:, None] * (2 * width)
                  + col)
        total += (bits * weight).sum()
    return int(total)


def htod_copies(device):
    """Host-to-device copies among a profile's device events: count and ms
    of the pageable and of the pinned ones."""
    out = {"pageable": [0, 0.0], "pinned": [0, 0.0]}
    for e in device:
        if "HtoD" not in e.name:
            continue
        kind = "pageable" if "Pageable" in e.name else "pinned"
        out[kind][0] += 1
        out[kind][1] += e.time_range.elapsed_us() / 1e3
    return {k: {"count": n, "ms": ms} for k, (n, ms) in out.items()}


class StepWindow:
    """A `fit` callback: each step's end (after a synchronize) on the host
    clock, and one step under torch.profiler, from the end of step
    `profiled` to the end of the next: the card's busy time and idle share
    over that window and its host-to-device copies."""

    def __init__(self, torch, profiled):
        self.torch, self.profiled = torch, profiled
        self.ends, self.prof, self.window = [], None, None

    def on_step(self, step, model, loss):
        torch = self.torch
        torch.cuda.synchronize()
        now = time.perf_counter()
        if step == self.profiled:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.window = [time.time_ns() / 1e3]
            now = time.perf_counter()
        elif step == self.profiled + 1:
            self.window.append(time.time_ns() / 1e3)
            self.prof.stop()
            now = time.perf_counter()
        self.ends.append(now)

    def profile(self):
        from torch.autograd import DeviceType
        device = [e for e in self.prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith(ANNOTATED_RANGES)]
        wall = self.window[1] - self.window[0]
        busy = busy_union((e.time_range.start, e.time_range.end)
                          for e in device)
        by_kernel = _by_name(device)
        cats, _ = by_category(by_kernel)
        return dict(wall_ms=wall / 1e3, device_busy_ms=busy / 1e3,
                    device_idle_share=1 - busy / wall if device else None,
                    htod=htod_copies(device), device_ms_by_category=cats,
                    device_ms_by_kernel=[[n[:80], us / 1e3] for n, us in sorted(
                        by_kernel.items(), key=lambda kv: -kv[1])[:10]])

    def step_ms(self, skip):
        """Each step's time (end to end), but the first two and `skip`."""
        return [(b - a) * 1e3 for i, (a, b) in enumerate(
            zip(self.ends, self.ends[1:]), start=1)
            if i >= 2 and i not in skip]


def dlrm_step_kernels(torch, cuda_lookup, cuda_sparse, model, batch, rate):
    """The kernels of DLRM's sparse sgd step at the main path's shapes: one
    step on `batch` (after the fit's tables were fingerprinted: it and the
    timing runs move them) with its `lookup_combine`,
    `segment_sum_sorted` and `sgd_rows` calls captured, each held against
    its plain version and timed beside its bound and library call, as
    phases 4b and 5 do at Tiny's. Returns {kernel: (totals, worst abs
    error)}."""
    from distributed_embeddings_tpu_torch.models.dlrm import make_lr_schedule
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager)
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    init, step = make_sparse_train_step(model, "sgd",
                                        lr=make_lr_schedule(*DLRM_LR))
    num, cats, labels = DeviceStager(model.embedding.device)(batch)
    with Capture(cuda_lookup, "lookup_combine") as look, \
            Capture(cuda_sparse, "segment_sum_sorted") as seg, \
            Capture(cuda_sparse, "sgd_rows") as rows:
        step(model, init(model), num, list(cats), labels)
    torch.cuda.synchronize()
    check(len(look.calls) == len(seg.calls) == len(rows.calls) == 1,
          f"DLRM step: {len(look.calls)} lookups, {len(seg.calls)} segment "
          f"sums, {len(rows.calls)} sgd_rows calls captured, want 1 each")
    captured = [args + (None,) * (3 - len(args)) for args in look.calls]
    look_err, look_tot = tiny_bucket_kernels(torch, cuda_lookup, captured,
                                             rate, phase="dlrm_kernel")
    out = {"lookup_combine": (look_tot, look_err),
           "segment_sum_sorted": time_segment_calls(
               torch, cuda_sparse, seg.calls, rate, path="dlrm_fit"),
           "sgd_rows": time_row_calls(torch, cuda_sparse, "sgd", rows.calls,
                                      rate, path="dlrm_fit")}
    emit(phase="dlrm_kernels", hbm_bytes_per_s=rate,
         **{k: dict(tot, max_abs_err=err) for k, (tot, err) in out.items()})
    return out


def dlrm_fit_phase(torch, cuda_lookup, cuda_sparse, counted, rate):
    """DLRM at the example's widths (Criteo sizes x DLRM_TABLE_SCALE, width
    128, bottom 512-256-128, top 1024-1024-512-256-1, 13 numerical
    features, batch 65,536) trained by sparse sgd at the example's
    schedule through `fit` from a split-binary dataset (a seeded
    ClickGenerator stream written to a temporary directory, read by
    `RawBinaryDataset`: ``raw_batches`` + ``preprocess``) with eval
    every DLRM_EVAL_EVERY steps, pipelined, then again from the same
    weights with ``pipelined=False``: losses, eval AUCs, tables (by
    `table_digest`) and MLPs bit-identical. The on-card AUC against
    `auc_exact` and a CPU `StreamingAUC` of the same logits. Then the
    step's kernels held and timed at its shapes (`dlrm_step_kernels`, on
    the serial run's model). Returns the launch counts of the pipelined
    run and of the serial one, and `dlrm_step_kernels`' totals."""
    import numpy as np
    from distributed_embeddings_tpu_torch.models.data import (
        RawBinaryDataset)
    from distributed_embeddings_tpu_torch.models.dlrm import (
        DLRM, make_lr_schedule, scaled_table_sizes)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager)
    from distributed_embeddings_tpu_torch.training import fit
    from distributed_embeddings_tpu_torch.utils.metrics import (
        StreamingAUC, auc_exact)
    sizes = scaled_table_sizes(DLRM_TABLE_SCALE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dlrm")
    try:
        t0 = time.perf_counter()
        gen = ClickGenerator(sizes, 13, BATCH, seed=DLRM_SEED)
        write_split_binary(tmp, "train",
                           [gen.batch(s) for s in range(DLRM_FIT_STEPS)],
                           sizes)
        write_split_binary(tmp, "test", [gen.batch(1_000_000 + j)
                                         for j in range(DLRM_EVAL_STEPS)],
                           sizes)
        del gen
        emit(phase="dlrm_data", seconds=time.perf_counter() - t0,
             tables=len(sizes), rows=sum(sizes), batch=BATCH,
             train_batches=DLRM_FIT_STEPS, test_batches=DLRM_EVAL_STEPS,
             bytes=sum(os.path.getsize(os.path.join(tmp, d, f))
                       for d in ("train", "test")
                       for f in os.listdir(os.path.join(tmp, d))))

        def dataset(valid):
            return RawBinaryDataset(
                tmp, batch_size=BATCH, numerical_features=13,
                categorical_features=range(len(sizes)),
                categorical_feature_sizes=sizes, valid=valid)
        evals = DLRM_FIT_STEPS // DLRM_EVAL_EVERY
        want = {"lookup_combine": DLRM_FIT_STEPS + evals * DLRM_EVAL_STEPS,
                "segment_sum_sorted": DLRM_FIT_STEPS,
                "sgd_rows": DLRM_FIT_STEPS}
        runs, counts = {}, {}
        for pipelined in (True, False):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = DLRM(sizes, device="cuda", lookup_path="pallas",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(DLRM_SEED))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            train, test = dataset(False), dataset(True)
            window = StepWindow(torch, DLRM_PROFILED_STEP)
            set_counts(cuda_lookup, *counted)
            t0 = time.perf_counter()
            _, _, hist = fit(
                model, train.raw_batches(DLRM_FIT_STEPS), DLRM_FIT_STEPS,
                "sgd", lr=make_lr_schedule(*DLRM_LR),
                preprocess=train.preprocess, pipelined=pipelined,
                eval_data=lambda j: test[j % len(test)],
                eval_every=DLRM_EVAL_EVERY, eval_steps=DLRM_EVAL_STEPS,
                log_every=0, callbacks=[window])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            label = "dlrm_fit" if pipelined else "dlrm_fit_serial"
            counts[label] = read_counts(cuda_lookup, *counted)
            check(counts[label] == per_step(want, 1),
                  f"{label} launches {counts[label]}, want {want} "
                  f"({DLRM_FIT_STEPS} steps, {evals} evals of "
                  f"{DLRM_EVAL_STEPS} forwards)")
            check(all(map(math.isfinite, hist["loss"])),
                  f"{label}: non-finite losses {hist['loss']}")
            skip = {DLRM_PROFILED_STEP + 1} | {
                s for s in range(DLRM_FIT_STEPS) if s % DLRM_EVAL_EVERY == 0}
            step_ms = window.step_ms(skip)
            med = statistics.median(step_ms)
            emit(phase="main_path", path=label, steps=DLRM_FIT_STEPS,
                 build_s=build_s, fit_s=fit_s, launches=counts[label],
                 launches_per_step={k: counts[label][k] / DLRM_FIT_STEPS
                                    for k in want},
                 losses=hist["loss"], eval_auc=hist["eval_auc"],
                 table_bytes=sum(t.numel() * 4 for t in model.embedding.tp),
                 median_step_ms=med, samples_per_s=BATCH / (med / 1e3),
                 step_ms=step_ms,
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 ingest_stage_mean_ms={
                     k: v["mean_ms"]
                     for k, v in hist["ingest_stages"].items()},
                 profiled_step=window.profile())
            runs[pipelined] = (hist["loss"], hist["eval_auc"],
                               [table_digest(torch, t)
                                for t in model.embedding.tp],
                               {n: p.detach().clone() for n, p in
                                model.named_parameters() if p.requires_grad})
            if pipelined:
                # the on-card AUC of the trained model's logits against the
                # exact AUC and a CPU StreamingAUC of the same logits
                stage = DeviceStager("cuda")
                metric = StreamingAUC()
                state = metric.init("cuda")
                logits, labels = [], []
                with torch.no_grad():
                    for j in range(DLRM_EVAL_STEPS):
                        num, cats, lab = stage(test[j])
                        out = model(num, cats).reshape(-1)
                        metric.update(state, lab, out)
                        logits.append(out.cpu())
                        labels.append(lab.reshape(-1).cpu())
                card_auc = metric.result(state)
                logits, labels = torch.cat(logits), torch.cat(labels)
                exact = auc_exact(labels.numpy(), logits.numpy())
                cpu_metric = StreamingAUC()
                cpu_state = cpu_metric.update(cpu_metric.init("cpu"), labels,
                                              logits)
                cpu_auc = cpu_metric.result(cpu_state)
                # the histograms of the card's own sigmoid, binned on the
                # host: the counts must be the card's exactly
                probs = torch.sigmoid(logits.cuda()).cpu()
                host = StreamingAUC(from_logits=False)
                host_state = host.update(host.init("cpu"), labels, probs)
                exact_counts = (torch.equal(host_state.tp, state.tp.cpu())
                                and torch.equal(host_state.fp,
                                                state.fp.cpu()))
                emit(phase="dlrm_auc", samples=int(labels.numel()),
                     bins=metric.bins, card_auc=card_auc, exact_auc=exact,
                     cpu_streaming_auc=cpu_auc,
                     card_minus_exact=card_auc - exact,
                     card_equals_cpu=card_auc == cpu_auc,
                     bins_differing_from_cpu=int(
                         ((state.tp.cpu() != cpu_state.tp)
                          | (state.fp.cpu() != cpu_state.fp)).sum()),
                     histograms_exact=exact_counts)
                check(abs(card_auc - exact) <= AUC_EXACT_TOL,
                      f"on-card AUC {card_auc} against the exact "
                      f"{exact}")
                check(exact_counts, "the card's AUC histograms differ from "
                                    "its own probabilities binned on the host")
                check(abs(card_auc - cpu_auc) <= 1e-4,
                      f"on-card AUC {card_auc}, CPU StreamingAUC {cpu_auc}")
                check(card_auc == hist["eval_auc"][-1],
                      f"fit's last eval AUC {hist['eval_auc'][-1]} against "
                      f"the phase's {card_auc}")
            else:
                step_kernels = dlrm_step_kernels(torch, cuda_lookup,
                                                 cuda_sparse, model,
                                                 train[0], rate)
            del model, train, test
            torch.cuda.empty_cache()
        (l1, a1, d1, m1), (l2, a2, d2, m2) = runs[True], runs[False]
        same = (l1 == l2 and a1 == a2 and d1 == d2
                and all(torch.equal(m1[n], m2[n]) for n in m1))
        emit(phase="dlrm_pipelined_vs_serial", bit_identical=same,
             losses_equal=l1 == l2, eval_auc_equal=a1 == a2,
             table_digests_equal=d1 == d2)
        check(same, "the pipelined and the serial fit differ")
        return counts, step_kernels
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dlrm_against_cpu_phase(torch, cuda_lookup, cuda_sparse, counted):
    """The same DLRM at DLRM_CPU_SCALE, 3 sgd steps at batch 65,536, each
    held against a CPU trainer from the card's state (phase 5's way:
    losses, touched table rows by change, the MLPs by value; the row
    sums' conditioning from the CPU step's contributions). Returns the
    launch counts."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        DLRM, scaled_table_sizes)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    sizes = scaled_table_sizes(DLRM_CPU_SCALE)
    t0 = time.perf_counter()
    model = DLRM(sizes, device="cuda", lookup_path="pallas",
                 generator=torch.Generator(device="cuda").manual_seed(3))
    cpu_model = DLRM(sizes, device="cpu", lookup_path="pallas")
    gen = ClickGenerator(sizes, 13, BATCH, seed=DLRM_SEED + 1)
    batches = [gen.batch(s) for s in range(TRAIN_STEPS)]
    init, step = make_sparse_train_step(model, "sgd", lr=TRAIN_LR)
    _, cpu_step = make_sparse_train_step(cpu_model, "sgd", lr=TRAIN_LR)
    set_counts(cuda_lookup, *counted)
    _, held = train_against_cpu(torch, rows_capture(cuda_sparse, "sgd"),
                                "sgd", "change", step, model, init(model),
                                cpu_step, cpu_model, batches, scaled=False,
                                contrib=True)
    torch.cuda.synchronize()
    counts = read_counts(cuda_lookup, *counted)
    want = {"lookup_combine": 1, "segment_sum_sorted": 1, "sgd_rows": 1}
    check(counts == per_step(want, TRAIN_STEPS),
          f"dlrm_against_cpu launches {counts}, want {want} per step")
    emit(phase="main_path", path="dlrm_against_cpu", steps=TRAIN_STEPS,
         seconds=time.perf_counter() - t0, rows=sum(sizes),
         table_bytes=sum(t.numel() * 4 for t in model.embedding.tp),
         launches=counts, losses=held["losses"],
         cpu_losses=held["cpu_losses"], max_abs_err=held["max_abs_err"],
         touched_rows=[int(t.numel()) for t in held["touched"]],
         table_change_median=held["changes"].median().item(),
         table_change_max=held["changes"].max().item(),
         table_changes_past_rounding=held["moved"],
         relu_flips=held["relu_flips"], ok=True)
    del model, cpu_model, held
    torch.cuda.empty_cache()
    return counts


def dense_criteo_phase(torch, cuda_lookup, cuda_sparse, counted):
    """Full criteo through the tiled lookup: 3 steps of `fit(sparse=False,
    "sgd")` (the table gradients through the sorted lookup's backward)
    against 3 of `fit(sparse=True, "sgd")` from one state and the same
    batches: the rows the sparse steps touched by value (rtol 1e-5), every
    other row bit-identical, the MLPs by value. Returns the launch counts
    of the dense run."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.training import fit
    criteo = SYNTHETIC_MODELS["criteo"]
    t0 = time.perf_counter()
    batches = list(InputGenerator(criteo, BATCH, alpha=1.05,
                                  num_batches=TRAIN_STEPS, seed=5))
    model = SyntheticModel(criteo, device="cuda", lookup_path="tiled",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(5))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    with Capture(cuda_sparse, "sgd_rows") as cap:
        _, _, sparse_hist = fit(model, batches, TRAIN_STEPS, "sgd",
                                lr=TRAIN_LR, log_every=0)
        torch.cuda.synchronize()
    touched = [torch.unique(torch.cat([
        a[1][(a[1] >= 0) & (a[1] < t.shape[0])].long() for a in cap.calls
        if a[0].data_ptr() == t.data_ptr()])) for t in model.embedding.tp]
    del cap
    sparse_after = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(initial)
    set_counts(cuda_lookup, *counted)
    _, _, dense_hist = fit(model, batches, TRAIN_STEPS, "sgd", lr=TRAIN_LR,
                           sparse=False, log_every=0)
    torch.cuda.synchronize()
    counts = read_counts(cuda_lookup, *counted)
    want = {"gather_sorted": 1, "sgd_stream": 1}
    check(counts == per_step(want, TRAIN_STEPS),
          f"dense criteo launches {counts}, want {want} per step")
    check(all(not t.requires_grad for t in model.embedding.tp),
          "a table kept requires_grad after the dense step")
    dense_after = model.state_dict()
    worst, changed_rows = 0.0, 0
    for name, got in dense_after.items():
        want_t = sparse_after[name]
        if name.startswith("embedding.tp."):
            b = int(name.rsplit(".", 1)[1])
            rows = touched[b]
            moved = (got != initial[name]).any(dim=1).nonzero().flatten()
            check(bool(torch.isin(moved, rows).all()),
                  f"{name}: the dense step moved a row no sparse step "
                  "touched")
            untouched = torch.ones(got.shape[0], dtype=torch.bool,
                                   device=got.device)
            untouched[rows] = False
            check(torch.equal(got[untouched], initial[name][untouched]),
                  f"{name}: an untouched row changed")
            got, want_t = got.index_select(0, rows), want_t.index_select(
                0, rows)
            changed_rows += int(moved.numel())
            tol = dict(rtol=1e-5, atol=0.0)
        else:
            tol = TRAIN_TOL
        err = (got - want_t).abs().max().item() if got.numel() else 0.0
        check(torch.allclose(got, want_t, **tol),
              f"dense criteo: {name} differs from the sparse run by {err}")
        worst = max(worst, err)
    check(torch.allclose(torch.tensor(dense_hist["loss"]),
                         torch.tensor(sparse_hist["loss"]), **LOSS_TOL),
          f"dense criteo losses {dense_hist['loss']} against the sparse "
          f"{sparse_hist['loss']}")
    emit(phase="main_path", path="dense_criteo", steps=TRAIN_STEPS,
         seconds=time.perf_counter() - t0, launches=counts,
         losses=dense_hist["loss"], sparse_losses=sparse_hist["loss"],
         touched_rows=[int(t.numel()) for t in touched],
         rows_moved=changed_rows, max_abs_err=worst, ok=True)
    del model, initial, sparse_after, dense_after
    torch.cuda.empty_cache()
    return counts


def dense_tiny_phase(torch, cuda_lookup, cuda_sparse, counted, cut,
                     batches):
    """Tiny cut to CUT_ROWS rows per table: ``strategy="dense"`` against
    ``"sort"`` for adagrad and adam, each step of 3 from the same state,
    by value (`hold`: TRAIN_TOL, adam's ill elements by 1e-2 lr, with the
    step's `gradient_scale` on the card): the dense sums are added by
    ``index_add_``'s atomics, the sort route's in sorted order. Returns
    each dense run's launch counts."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SyntheticModel)
    from distributed_embeddings_tpu_torch.training import (
        gradient_scale, make_sparse_train_step)
    model = SyntheticModel(cut, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for kind in ("adagrad", "adam"):
        t0 = time.perf_counter()
        model.load_state_dict(initial)
        init, sort_step = make_sparse_train_step(model, kind, lr=TRAIN_LR,
                                                 strategy="sort")
        _, dense_step = make_sparse_train_step(model, kind, lr=TRAIN_LR,
                                               strategy="dense")
        state = init(model)
        counts = dict.fromkeys(ALL_KERNELS, 0)
        worst = 0.0
        for batch in batches:
            snap = ({k: v.clone() for k, v in model.state_dict().items()},
                    clone_tree(torch, state))
            scale = {k: (g.cpu(), t.cpu()) for k, (g, t) in
                     gradient_scale(model, *batch).items()}
            sort_state, _, rows, _ = run_trainer(
                sort_step, model, clone_tree(torch, snap[1]), [batch],
                rows_capture(cuda_sparse, kind))
            touched = touched_rows(torch, model, rows)
            want = trained_arrays(torch, model, sort_state, touched)
            del sort_state
            model.load_state_dict(snap[0])
            before = trained_arrays(torch, model, snap[1], touched)
            set_counts(cuda_lookup, *counted)
            state, _, rows, _ = run_trainer(
                dense_step, model, snap[1], [batch],
                rows_capture(cuda_sparse, kind))
            torch.cuda.synchronize()
            for k, v in read_counts(cuda_lookup, *counted).items():
                counts[k] += v
            check(all(torch.equal(a, b) for a, b in zip(
                touched, touched_rows(torch, model, rows))),
                  f"dense {kind}: other rows than the sort step's")
            err, _, _ = hold_trainers(
                torch, f"dense {kind}",
                trained_arrays(torch, model, state, touched), want, before,
                touched, 1, "value", scale,
                TRAIN_LR if kind == "adam" else None)
            worst = max(worst, err)
            del snap, scale, want, before
        label = f"dense_tiny_{kind}"
        want_counts = {"lookup_combine": 4}
        check(counts == per_step(want_counts, TRAIN_STEPS),
              f"{label} launches {counts}, want {want_counts} per step")
        emit(phase="main_path", path=label, steps=TRAIN_STEPS,
             seconds=time.perf_counter() - t0, launches=counts,
             max_abs_err=worst, ok=True)
        out[label] = counts
    del model, initial
    torch.cuda.empty_cache()
    return out


def convergence_phase(torch, cuda_lookup, counted):
    """The port's convergence demo at docs/convergence_r05.json's settings
    on the card; its AUC curve beside r05's; the last AUC past
    CONVERGENCE_AUC. Returns the launch counts."""
    from distributed_embeddings_tpu_torch.tools import convergence_demo
    with open(os.path.join(REPO, "docs", "convergence_r05.json")) as f:
        r05 = json.load(f)
    t0 = time.perf_counter()
    set_counts(cuda_lookup, *counted)
    result = convergence_demo.run(**CONVERGENCE, device="cuda",
                                  log_fn=lambda *_: None)
    torch.cuda.synchronize()
    counts = read_counts(cuda_lookup, *counted)
    curve = result["eval_auc"]
    emit(phase="main_path", path="convergence", seconds=time.perf_counter()
         - t0, launches=counts, eval_auc=curve, r05_eval_auc=r05["eval_auc"],
         eval_every=result["eval_every"],
         loss_first100_mean=result["loss_first100_mean"],
         loss_last100_mean=result["loss_last100_mean"],
         r05_loss_last100_mean=r05["loss_last100_mean"])
    check(len(curve) == CONVERGENCE["steps"] // CONVERGENCE["eval_every"]
          and curve[-1] > CONVERGENCE_AUC,
          f"convergence: AUC curve {curve}, the last must pass "
          f"{CONVERGENCE_AUC}")
    return counts


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
                                                      cuda_tiled,
                                                      embedding_ops,
                                                      kernel_build,
                                                      sparse_update)
    from distributed_embeddings_tpu_torch.serving.batcher import MicroBatcher
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.tools import cuda_feature_probe
    counted = (cuda_sparse, cuda_tiled, cuda_feature_probe)

    # ---- 1. device
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    rate = hbm_rate(name)

    # ---- 2a. the feature ladder: every rung printed, then held
    emit(phase="nvcc", release=kernel_build.nvcc_version())
    t0 = time.perf_counter()
    set_counts(cuda_lookup, *counted)
    matrix = cuda_feature_probe.run_ladder("cuda")
    ladder_counts = read_counts(cuda_lookup, *counted)
    for rung in matrix:
        emit(phase="ladder", **rung)
    failed = [rung["rung"] for rung in matrix if not rung["ok"]]
    check(not failed, f"feature ladder rungs failed: {failed}")
    torch.cuda.synchronize()
    want_counts = {**dict.fromkeys(cuda_feature_probe.launches, 2),
                   "sgd_rows": 1, "gather_sorted": 1, "sgd_stream": 1,
                   "adagrad_stream": 1, "adam_stream": 1}
    emit(phase="main_path", path="ladder", rungs=len(matrix),
         seconds=time.perf_counter() - t0, launches=ladder_counts)
    check(ladder_counts == per_step(want_counts, 1),
          f"ladder launches {ladder_counts}, want {want_counts}")
    ladder_rows = ladder_kernels(torch, cuda_feature_probe, rate)

    # ---- 2. build
    t0 = time.perf_counter()
    libs = kernel_build.build(KERNELS)
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p, REPO) for p in libs.values()])

    # ---- 3. kernels against their plain versions
    worst = kernel_cases(torch, cuda_lookup)
    sparse_worst = sparse_kernel_cases(torch, cuda_sparse, sparse_update)
    sorted_worst = sorted_kernel_cases(torch, cuda_tiled, embedding_ops,
                                       sparse_update)

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
    set_counts(cuda_lookup, *counted)
    outs = [engine.predict(req) for req in requests]
    batcher = MicroBatcher(engine)
    handles = [batcher.submit(req) for req in spans]
    flushed = batcher.flush()
    torch.cuda.synchronize()
    serve_counts = read_counts(cuda_lookup, *counted)
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
    # the weights before any step, on the host (not counted in the
    # device's peak): train_fused starts from them again
    initial_tiny = {k: v.detach().cpu()
                    for k, v in model.state_dict().items()}

    # the training path: counts to 0, drive, read; each step is held
    # against the CPU trainer (same weights, plain versions) from the
    # card's state before it
    t0 = time.perf_counter()
    _, cpu_step = make_sparse_train_step(cpu_model, "adagrad", lr=TRAIN_LR)
    set_counts(cuda_lookup, *counted)
    # bucket 0 (60,160 x 8) takes the dense strategy under "auto", whose
    # sums the card adds in its atomics' order: the conditioning
    # (`gradient_scale`) and `sum_eps` size its bar; bucket 1 (the
    # deduplicated-row route) keeps the plain one
    state, held = train_against_cpu(torch, rows_capture(cuda_sparse,
                                                        "adagrad"),
                                    "adagrad", "change", step, model, state,
                                    cpu_step, cpu_model, batches,
                                    scaled="dense")
    torch.cuda.synchronize()
    train_counts = read_counts(cuda_lookup, *counted)
    losses = held["losses"]
    emit(phase="main_path", path="train_adagrad", steps=TRAIN_STEPS,
         launches=train_counts, losses=losses)
    # bucket 1 alone takes the deduplicated-row route
    want_counts = {"lookup_combine": 4, "segment_sum_sorted": 1,
                   "adagrad_rows": 1}
    check(train_counts == per_step(want_counts, TRAIN_STEPS),
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
         relu_flips=held["relu_flips"],
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
    profile_step(torch, step_once, "train_adagrad")
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
    del seg_cap, row_cap

    # ---- 5b. train_fused: the same model through the fused lookup and the
    # pallas strategy (the JAX package's DET_LOOKUP_PATH=fused +
    # DET_SCATTER_IMPL=pallas); counts to 0, drive, read; each step held
    # against the CPU trainer, from phase 5's initial weights and fresh
    # accumulators, so its held steps are phase 5's through the other
    # lookup and strategy
    t0 = time.perf_counter()
    del holder
    model.load_state_dict(initial_tiny)
    del initial_tiny
    for m in (model, cpu_model):
        m.embedding.lookup_path = "fused"
    init, step = make_sparse_train_step(model, "adagrad", lr=TRAIN_LR,
                                        strategy="pallas")
    state = init(model)
    _, cpu_step = make_sparse_train_step(cpu_model, "adagrad", lr=TRAIN_LR,
                                         strategy="pallas")
    set_counts(cuda_lookup, *counted)
    state, held = train_against_cpu(
        torch, rows_capture(cuda_sparse, "adagrad"), "adagrad", "change",
        step, model, state, cpu_step, cpu_model, batches[:FUSED_HELD_STEPS],
        scaled=True)
    torch.cuda.synchronize()
    fused_counts = read_counts(cuda_lookup, *counted)
    del cpu_model
    want_counts = {"gather_sorted": 4, "segment_sum_sorted": 2,
                   "adagrad_rows": 2}
    check(fused_counts == per_step(want_counts, FUSED_HELD_STEPS),
          f"fused launches {fused_counts}, want {want_counts} per step")
    emit(phase="main_path", path="train_fused", steps=FUSED_HELD_STEPS,
         seconds=time.perf_counter() - t0, launches=fused_counts,
         losses=held["losses"], cpu_losses=held["cpu_losses"],
         max_abs_err=held["max_abs_err"],
         table_elements_held=int(held["changes"].numel()),
         table_change_median=held["changes"].median().item(),
         table_change_max=held["changes"].max().item(),
         table_changes_past_rounding=held["moved"],
         elements_with_gradient=held["with_gradient"],
         ill_conditioned_elements=held["ill"],
         relu_flips=held["relu_flips"], ok=True)
    del held
    torch.cuda.reset_peak_memory_stats()
    holder = {"state": step_time(torch, step, model, state, batches,
                                 "train_fused")}
    del state

    def fused_once():
        holder["state"] = step(model, holder["state"], num, cats,
                               labels)[1]
    sorts = profile_step(torch, fused_once, "train_fused")
    check(sorts == 6, f"train_fused ran {sorts} sorts per step, want 6 "
                      "(4 group sorts, 2 bucket dedup sorts)")
    with Capture(cuda_tiled, "gather_sorted") as g_cap, \
            Capture(cuda_tiled, "fused_lookup_combine") as f_cap:
        fused_once()
    torch.cuda.synchronize()
    gather_totals = {"train_fused": time_gather_calls(
        torch, cuda_tiled, g_cap.calls, g_cap.kwargs, rate, "train_fused")}
    fused_against_lookup_combine(torch, cuda_tiled, cuda_lookup,
                                 f_cap.calls, f_cap.kwargs)
    del g_cap, f_cap, holder
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
        set_counts(cuda_lookup, *counted)
        state, held = train_against_cpu(
            torch, rows_capture(cuda_sparse, kind), kind, "value", step,
            cut_model, init(cut_model), cpu_step, cpu_cut,
            cut_batches[:TRAIN_STEPS])
        torch.cuda.synchronize()
        counts = read_counts(cuda_lookup, *counted)
        cut_counts[kind] = counts
        # adam's bucket 0 takes the dense strategy under "auto"; sgd's
        # "auto" is the deduplicated-row route on both buckets
        rows_buckets = 2 if kind == "sgd" else 1
        want = {"lookup_combine": 4, "segment_sum_sorted": rows_buckets,
                f"{kind}_rows": rows_buckets}
        check(counts == per_step(want, TRAIN_STEPS),
              f"{kind} launches {counts}, want {want} per step")
        emit(phase="main_path", path=f"train_{kind}_cut", steps=TRAIN_STEPS,
             launches=counts, losses=held["losses"],
             cpu_losses=held["cpu_losses"], max_abs_err=held["max_abs_err"],
             table_change_median=held["changes"].median().item(),
             table_change_max=held["changes"].max().item(),
             elements_with_gradient=held["with_gradient"],
             ill_conditioned_elements=held["ill"],
             relu_flips=held["relu_flips"], ok=True)
        with Capture(cuda_sparse, f"{kind}_rows") as cap:
            num, cats, labels = cut_batches[TRAIN_STEPS]
            step(cut_model, state, num, cats, labels)
        torch.cuda.synchronize()
        rows[f"{kind}_rows"] = time_row_calls(torch, cuda_sparse, kind,
                                              cap.calls, rate)
        del cpu_cut, state, held, cap
    del cut_model
    torch.cuda.empty_cache()

    # ---- 6c. dense_path: the dense strategy against the sort route on
    # cut Tiny, then full criteo's dense step against its sparse one
    dense_counts = dense_tiny_phase(torch, cuda_lookup, cuda_sparse, counted,
                                    cut, cut_batches[:TRAIN_STEPS])
    dense_counts["dense_criteo"] = dense_criteo_phase(
        torch, cuda_lookup, cuda_sparse, counted)

    # ---- 6b. train_tiled: full-size criteo through the tiled lookup and
    # the tiled strategy (the raw-stream kernels), adagrad, then sgd and
    # adam; counts to 0, drive, read; each step held against the CPU
    # trainer
    criteo = SYNTHETIC_MODELS["criteo"]
    t0 = time.perf_counter()
    cri_batches = list(InputGenerator(criteo, BATCH, alpha=1.05,
                                      num_batches=TILED_HELD_STEPS + 1,
                                      seed=0))
    cmodel = SyntheticModel(criteo, device="cuda", lookup_path="tiled",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(0))
    cpu_c = SyntheticModel(criteo, device="cpu", lookup_path="tiled")
    c_initial = {k: v.cpu() for k, v in cmodel.state_dict().items()}
    torch.cuda.synchronize()
    emit(phase="model", config=criteo.name, seconds=time.perf_counter() - t0,
         buckets=[list(t.shape) for t in cmodel.embedding.tp],
         table_bytes=sum(t.numel() * 4 for t in cmodel.embedding.tp))
    tiled_counts, stream_totals = {}, {}
    for kind in ("adagrad", "sgd", "adam"):
        t0 = time.perf_counter()
        cmodel.load_state_dict(c_initial)
        # sgd and adagrad held by change, adam by value (dense adam on
        # the MLP, the step's default, under phase 6's rule)
        init, step = make_sparse_train_step(cmodel, kind, lr=TRAIN_LR,
                                            strategy="tiled")
        _, cpu_step = make_sparse_train_step(cpu_c, kind, lr=TRAIN_LR,
                                             strategy="tiled")
        set_counts(cuda_lookup, *counted)
        state, held = train_against_cpu(
            torch, stream_capture(cuda_tiled, kind), kind,
            "value" if kind == "adam" else "change", step, cmodel,
            init(cmodel), cpu_step, cpu_c, cri_batches[:TILED_HELD_STEPS],
            scaled=True)
        torch.cuda.synchronize()
        counts = read_counts(cuda_lookup, *counted)
        tiled_counts[kind] = counts
        want = {"gather_sorted": 1, f"{kind}_stream": 1}
        check(counts == per_step(want, TILED_HELD_STEPS),
              f"tiled {kind} launches {counts}, want {want} per step")
        emit(phase="main_path", path=f"train_tiled_{kind}",
             steps=TILED_HELD_STEPS, seconds=time.perf_counter() - t0,
             launches=counts, losses=held["losses"],
             cpu_losses=held["cpu_losses"], max_abs_err=held["max_abs_err"],
             table_elements_held=int(held["changes"].numel()),
             table_change_median=held["changes"].median().item(),
             table_change_max=held["changes"].max().item(),
             table_changes_past_rounding=held["moved"],
             elements_with_gradient=held["with_gradient"],
             ill_conditioned_elements=held["ill"],
             relu_flips=held["relu_flips"], ok=True)
        del held
        num, cats, labels = cri_batches[TILED_HELD_STEPS]
        if kind == "adagrad":
            # fold_sort off: one more sort per step, the same step bit for
            # bit
            _, step_unfolded = make_sparse_train_step(
                cmodel, kind, lr=TRAIN_LR, strategy="tiled", fold_sort=False)
            before = ({k: v.clone() for k, v in cmodel.state_dict().items()},
                      clone_tree(torch, state))
            runs = []
            for fn in (step, step_unfolded):
                cmodel.load_state_dict(before[0])
                state = clone_tree(torch, before[1])
                (_, state, loss), sorts = profiled_sorts(
                    torch, lambda: fn(cmodel, state, num, cats, labels))
                torch.cuda.synchronize()
                runs.append((float(loss), sorts, {
                    k: v.clone() for k, v in cmodel.state_dict().items()},
                    tree_tensors(torch, state)))
            (l1, s1, m1, a1), (l2, s2, m2, a2) = runs
            same = (l1 == l2 and all(torch.equal(m1[k], m2[k]) for k in m1)
                    and len(a1) == len(a2)
                    and all(torch.equal(x, y) for x, y in zip(a1, a2)))
            emit(phase="fold_sort", path="train_tiled_adagrad",
                 sorts_folded=s1, sorts_unfolded=s2, bit_identical=same)
            check(s1 == 1 and s2 == 2,
                  f"sorts per criteo step {s1} folded, {s2} unfolded; "
                  "want 1 and 2")
            check(same, "fold_sort=False changed the criteo step")
            del before, runs, m1, m2, a1, a2
        torch.cuda.reset_peak_memory_stats()
        holder = {"state": step_time(torch, step, cmodel, state, cri_batches,
                                     f"train_tiled_{kind}")}
        del state

        def tiled_once():
            holder["state"] = step(cmodel, holder["state"], num, cats,
                                   labels)[1]
        sorts = profile_step(torch, tiled_once, f"train_tiled_{kind}")
        check(sorts == 1, f"train_tiled_{kind} ran {sorts} sorts per step, "
                          "want 1")
        with Capture(cuda_tiled, "gather_sorted") as g_cap, \
                Capture(cuda_tiled, f"{kind}_stream") as s_cap:
            tiled_once()
        torch.cuda.synchronize()
        stream_totals[kind] = time_stream_calls(torch, cuda_tiled, kind,
                                                s_cap.calls, rate)
        if kind == "adagrad":
            gather_totals["train_tiled"] = time_gather_calls(
                torch, cuda_tiled, g_cap.calls, g_cap.kwargs, rate,
                "train_tiled")
        del g_cap, s_cap, holder
    del cmodel, cpu_c
    torch.cuda.empty_cache()

    # ---- 9. DLRM at the example's widths: against the CPU trainer at a
    # small table scale, then through `fit` from a split-binary dataset
    # with eval, pipelined and serial; then the convergence demo
    dlrm_counts = {"dlrm_against_cpu": dlrm_against_cpu_phase(
        torch, cuda_lookup, cuda_sparse, counted)}
    fit_counts, dlrm_kernels = dlrm_fit_phase(torch, cuda_lookup,
                                              cuda_sparse, counted, rate)
    dlrm_counts.update(fit_counts)
    dlrm_counts["convergence"] = convergence_phase(torch, cuda_lookup,
                                                   counted)

    # ---- 8. world size > 1: W ranks on the card(s), each held against the
    # world-1 trainer; counts to 0 in each rank, drive, read
    world_counts = {}
    for config, world, model_kw, strategy in WORLD_RUNS:
        world_counts[f"world{world}_{config}"] = world_phase(
            torch, config, world, model_kw, strategy)

    # ---- 7. result lines; the kernels of DLRM's step carry their times
    # at its shapes too (`at_dlrm_fit`), and their worst error covers them
    def entry(kname, source, by_path, tot, err):
        at_dlrm = {}
        if kname in dlrm_kernels:
            d_tot, d_err = dlrm_kernels[kname]
            err = max(err, d_err)
            at_dlrm = {"at_dlrm_fit": {
                "max_abs_err": d_err, **{k: d_tot[k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms")}}}
        return {"name": kname, "route": "cuda",
                "source": f"distributed_embeddings_tpu_torch/csrc/{source}",
                "replaces": ", ".join(TPU_SITES[kname]) or None,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"],
                "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                             else "operations"),
                "library_ms": tot["library_ms"],
                **({"chain_ms": tot["chain_ms"]} if "chain_ms" in tot
                   else {}), **at_dlrm}

    paths = {"ladder": ladder_counts, "serve": serve_counts,
             "train_adagrad": train_counts,
             "train_sgd_cut": cut_counts["sgd"],
             "train_adam_cut": cut_counts["adam"],
             "train_fused": fused_counts,
             **{f"train_tiled_{k}": c for k, c in tiled_counts.items()},
             **dense_counts, **dlrm_counts, **world_counts}

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
    # gather_sorted: one step of each path (4 Tiny groups, 1 criteo call)
    gather_row = {key: sum(t[key] for t in gather_totals.values())
                  for key in gather_totals["train_fused"]}
    kernels.append(entry("gather_sorted", "sorted_stream.cu",
                         by_path("gather_sorted"), gather_row,
                         max(gather_row["max_abs_err"],
                             sorted_worst["gather_sorted"])))
    for kind in ("sgd", "adagrad", "adam"):
        tot = stream_totals[kind]
        kernels.append(entry(f"{kind}_stream", "sorted_stream.cu",
                             by_path(f"{kind}_stream"), tot,
                             max(tot["max_abs_err"],
                                 sorted_worst[f"{kind}_stream"])))
    ladder_err = {rung["library"]: rung["max_abs_err"] for rung in matrix}
    for kname, tot in ladder_rows.items():
        kernels.append(entry(kname, f"{kname}.cu", by_path(kname), tot,
                             ladder_err[kname]))
    emit(phase="sorted_lookups_backward",
         max_abs_err=sorted_worst["lookups"], ok=True)
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
