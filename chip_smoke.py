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
     sorted_stream.cu (the last two share row_rules.cuh). The one-hot
     kernel's instantiations' registers and spill bytes from the
     compiler's log (``one_hot_ptxas``; the kernels line names any that
     spill, ``one_hot_spills``), and `sgd_rows_kernel`'s, with those of
     its variants of SGD_ROWS_VARIANTS (copies of sparse_apply.cu built
     in the background from the start of 2a; ``sgd_rows_ptxas``,
     ``sgd_rows_spills``). The native host library (``native/*.cpp``,
     g++, built in a thread from the start of 2a): a ``native`` line with
     its path, the hash in its name, the flags and the g++ version; a
     last ``native`` line after phase 15 prints its calls by path
     (`native.loader.calls`: ``integer_lookup``, ``prefetch``,
     ``host_apply``).
  3. kernel: `lookup_combine` against its plain PyTorch version at the
     zoo's widths (8..256), hotness 1/10/30, sum/mean, weighted (with
     zero-weight slots) and unweighted, int32 and int64 ids, some of them
     out of range or negative. Bit-equal at hotness 1 unweighted, rtol 1e-5
     / atol 1e-6 otherwise (the K-term sum order differs). Tables are drawn
     like the model's (uniform +-0.05). Then the one-hot kernel's edges
     (`one_hot_cases`): every form, int32 and int64 ids, unweighted and
     weights in [-2, 2), widths 6, 8, 16, 128 and 256, N = 1, R - 1, 777
     and more than one pass of its grid, each bit for bit (-0 stored as
     +0, as the plain version's sum stores it).
     sparse_kernel: `segment_sum_sorted` (through `dedup_sum`) and the
     three row kernels against their plain versions at widths 8..256, on
     streams with duplicates (a hot row about 4,000 rows long and a warm
     one of 3T + 1 rows, T the segment walk's threshold), negative ids,
     ids >= V and the dedup filler tail, three accumulating steps each. The segment sum bit-equal to its
     plain version on a CPU copy (both add in sorted order) and within
     atol 1e-6 + rtol 1e-5 of the segment's sum of magnitudes of the card's
     `index_add_` (atomics, another order each run); the row
     kernels bit-equal to their plain versions on the card (else the
     largest ulp difference is printed and rtol 1e-6 holds). Then
     `sgd_rows`' walk bit for bit, one launch a call
     (`sgd_rows_edge_cases`): N = 1, 31, 32, 33 and past one pass of its
     grid; dedup's layout (a filler suffix), fillers between unsorted
     rows, negative fillers, fillers only, no fillers; int32 and int64;
     lr 0.01 and -1; widths 6, 8, 16, 128, 132 and 256.
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
     steps give them; `sgd_rows` also beside its variants
     (``sgd_rows_variants``, as in phase 9).
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
     then the same from the same weights with ``pipelined=False``, and
     pipelined with the ``os.pread`` reader before and after them
     (``use_native_prefetch=False``): losses, eval AUCs, tables
     (`table_digest`) and MLPs bit-identical. Printed: launches (1 / 1 /
     1 a step, 1 lookup a eval forward), step
     times and samples/s, peak memory, ingest stage means, one profiled
     step each (`StepWindow`: idle share, HtoD copies pageable / pinned),
     the on-card AUC against `auc_exact` (1e-3) and a CPU StreamingAUC.
     The dataset is read through the native prefetcher: its calls checked
     (every file of every train and eval batch), then every batch held
     byte for byte against an ``os.pread`` reader of the same files, each
     reader's mean ms a batch printed beside the pipelined `fit`'s
     ``read`` stage mean through each reader (``prefetch_hold``).
     Then one more step's kernel calls held and timed (`dlrm_kernels`),
     and `sgd_rows` at its call as the source builds it and as each
     variant of SGD_ROWS_VARIANTS (2 rows a group; one pass's `rep`
     loads in flight a warp; the contiguous slot order), each bit-equal, timed in turns (``sgd_rows_variants``).
     convergence: `tools.convergence_demo.run` at
     docs/convergence_r05.json's settings, its curve beside r05's; the
     last AUC must pass 0.70.
  10. (after 8) placement: DLRM at the example's widths with Criteo
     sizes x 0.2 (19.2 GB) and its three thresholds (dp 262,144, column
     64 Mi, row 512 Mi elements) on 2 ranks, placed as phase 8 places
     them: 13 data-parallel tables, 8 table-parallel (9 placements: one
     table in two 64-wide column slices; 2 buckets), 5 row-sliced (the
     plan asserted). Each rank (`placement_rank`): its forward of its
     slice; a layer of the same tables built with ``dp_input=False``, fed
     the rank's own features at global batch size, bit-equal to it; 3
     sgd steps at the example's schedule (launches a step: a
     `lookup_combine` per tp group and per row table, a
     `segment_sum_sorted` and an `sgd_rows` per tp bucket and per row
     shard); `InferenceEngine` at W = 2 on the trained model, a 65,536-
     and a 4,097-row request (the latter padded to 4,098); one more step
     whose `lookup_combine`, `segment_sum_sorted` and `sgd_rows` calls on
     row shard 0 rank 0 holds against their plain versions and times
     (`placement_kernel`, ``path="placement"`` lines, ``at_placement``
     in the kernels line; ``sgd_rows_variants`` as in phase 9); 10 timed
     steps; one profiled step (the
     exchange's host ms by collective: ``exchange:all_to_all`` 3 a tp
     group, ``exchange:all_gather`` 2 and ``exchange:reduce_scatter`` 1 a
     row table, ``exchange:all_reduce`` 1, or the phase fails; gloo's own
     events (its reduce-scatter is an all-reduce); the card's idle
     share over the ranks); peak memory. Then the world-1 model in this
     process (the thresholds ignored: one bucket of 26 tables) with the
     same per-table weights: each rank's embedding outputs and logits
     bit-equal to world 1's on the same rows; 3 steps, each from rank
     0's MLP before it with the ranks' ReLU masks forced: losses at rtol
     1e-5, every touched row of each tp placement and row shard by change
     (`hold`, the conditioning from world 1's contributions), the dp
     tables and MLPs by value and equal on every rank; then world 1 takes
     the ranks' trained rows, dp tables and MLP, and its engine, on each
     rank's block of each request (warmed at the block sizes), gives
     every rank's logits bit for bit; latency printed beside phase 4's.
     The bytes and dtypes each collective moves in one step are printed
     too (`wire_payloads`, ``placement_wire``).
  11. (after 10) amp: the DLRM paths at ``compute_dtype=bfloat16``.
     11a (`amp_kernel_cases`): `lookup_combine`'s 16-bit forms (the bf16
     and f16 stores, ``_round`` their round-first forms) bit-equal to
     their plain versions at any K (the plain version adds the K terms
     in the kernel's order), timed beside the float32 form and their
     bound (float32 rows read, 16-bit rows written): at Tiny's 4 groups
     (run after 4b, while Tiny's buckets live), at DLRM x 0.4's call
     (inside 11c, where the store form runs), at that call's ids with
     weights in (0, 1) (the one input where the two forms differ, which
     their plain versions must show) and at row shard 0's call on rank 0
     of 11e (where the round-first form runs). At DLRM's call also the
     one-hot kernel built at each kOneHotRows of ONE_HOT_SWEEP (copies of
     the source compiled in the background from the start of 11c), each
     bit-equal to the plain version, its float32 and bf16 store forms
     timed in turns (``one_hot_rows``).
     11b (`dlrm_against_cpu_phase` at bf16): Criteo sizes x 0.02, 3 sgd
     steps held against the CPU trainer as phase 9's are, the bar widened
     by one bfloat16 rounding of a term (AMP_TERM_EPS) at the tap
     gradients' own conditioning (`dlrm_tap_cond`), launches 1 / 1 / 1
     (the bf16 store, segment sum, `sgd_rows`); then the engine against a
     CPU engine: embedding outputs bit-equal, logits AMP_SERVE_TOL. 11c
     (`dlrm_amp_fit_phase`): x 0.4 through `fit` on phase 9's stream
     (written again), pipelined, beside phase 9's float32 run: step
     median, a profiled step, peak memory, the on-card AUC against
     `auc_exact`; launches 20 / 12 / 12. 11d: its engine at 65,536 and
     4,097 rows, then the same weights at float32. 11e
     (`amp_placement_phase`): the placement plan on 2 ranks at x 0.02
     (thresholds / 10: the same 13 / 8 (9, 2) / 5 plan), a bfloat16 gloo
     probe of the three collectives on CUDA tensors first, each rank's
     embedding outputs and logits bit-equal to world 1's, launches a rank
     step 2 bf16 stores (tp groups), 5 round-first (row shards), 7
     segment sums, 7 `sgd_rows`, every float payload of the wire's
     all_to_all, all_gather and reduce-scatter bfloat16, bytes and host
     ms by collective beside phase 10's float32 step.
  12. (after 11) quantized storage and checkpoints. 12a
     (`quantized_against_cpu_phase`): DLRM with Criteo sizes x 0.02 stored
     int8 (3 sgd steps), then fp8 (2), int8 at bfloat16 (1 step), and
     Tiny cut to 100,000 rows a table stored int8 with adagrad (3 steps),
     each step held against the CPU (`quantized_held_run`): the CPU model
     takes the card's state; each decode-gather (the gathered, decoded
     rows before the combine, `RowsTap`) bit-equal on the same payload;
     the combined embedding outputs bit-equal where every input is one-hot
     (at KERNEL_TOL where one is multi-hot: the hotness sum's order);
     every `quantized_row_update` of
     the card's step captured on its touched rows (`QuantCapture`) and
     held bit for bit, payload, scales and state, against the CPU plain
     function with the card's own tap gradients (`hold_quantized`); the
     losses at LOSS_TOL (QUANT_BF16_LOSS_TOL at bfloat16). Launches: one
     `segment_sum_sorted` a quantized bucket a step and nothing else (the
     lookup and update of a quantized bucket are torch operations, the
     JAX package's XLA forms). 12b (`quantized_full_phase`): DLRM at the
     MLPerf Criteo-1TB sizes (187.8M rows x 128, 24.0 GB of int8 payload,
     0.75 GB of scales; the float32 tables would be 96.1 GB) on one card,
     its embedding rebuilt with ``storage_dtype="int8"``
     (`quantized_dlrm`, the JAX example's way), through `fit` (22 sgd
     steps at the example's schedule, pipelined, from a split-binary
     dataset): step times, samples/s, peak memory beside the byte
     reckoning and rows per GB beside f32 x 0.4's, a profiled step (idle
     share, categories, the ``quantized:lookup`` and ``quantized:update``
     ranges' device ms, each range one call with device time; the
     profiler warmed by the step before, `StepWindow`), the on-card AUC against `auc_exact`, a
     65,536-row request through `InferenceEngine`, one more step held on
     its touched rows, those rows published as an int8 row delta
     (`utils.checkpoint.save_row_delta` + `publish_atomic`, bytes against
     `ops.wire.delta_row_bytes`, reloaded verified bit for bit, a flipped
     byte refused); the temp directory's disk usage first. 12c
     (`checkpoint_phase`): resume (`resume_run`: 2 steps, save, 2 more; a
     fresh model restored and trained the same 2, bit-equal) of DLRM x
     0.02 float32 sgd and int8 sgd, and cut Tiny int8 adagrad; the float32
     model's global weights through memory-mapped ``.npy`` files into a
     fresh model, bit for bit. About 130 s in all.
  13. (after 12) the exchange wire formats and hot rows. 13a
     (`hot_tiny_phase`): full-size Tiny V3 with ``hot_rows=HOT_ROWS``
     (16,384 a bucket) at world 1, adagrad: one observed step, then
     ``sync_hot_rows(admit=True)``, then 3 steps held against a CPU hot
     trainer from the card's state (`train_against_cpu(..., hot=True)`:
     the canonical touched rows as phase 5 holds them; the hot rows and
     their accumulators by change, `hold_hot`, at their
     `gradient_scale` conditioning, eps widened by the card's atomics
     counts), launches 4 / 1 / 1 a step (the miss lookups' weighted
     `lookup_combine`, bucket 1's segment sum and `adagrad_rows`); the
     hit rate by bucket on the first held batch (`hot_stats`) and the
     host ms of one batch's observation and of the admission; the step's
     median beside a hot-less Tiny step's; one profiled step, the
     profiler warmed by the step before (`warm_window`), with the card's
     idle share and the device ms of the split, the hot gather and the
     hot update (`StepWindow.range_ms` of the layer's ``hot:*`` ranges);
     ``fit(hot_sync_every=2)`` for 4 steps;
     one request of 65,536 rows through `InferenceEngine` against the CPU
     engine on the synced weights. 13b (`hot_wire_phase`): Tiny at W = 2
     over gloo with ``exchange_wire="bf16-sr"`` and the hot shard
     (`hot_wire_rank`): the wired collectives probed on CUDA tensors
     (`hot_wire_probe`), one observed step, rank 0's keys admitted on
     both ranks, 3 steps; then world 1 (no wire) with rank 0's admitted
     rows, each step from rank 0's MLP: losses within 2^-8, touched and
     hot rows within what one rounding of each term can move them
     (`hold_bounded`), the bytes and dtypes each collective moves beside
     float32's, the stochastic rounding's device ms. 13c
     (`wire_placement_phase`): 11e's tables (Criteo x 0.02, width 128)
     and thresholds with combiner "sum" on 2 ranks over
     ``exchange_wire="bf16"``: outputs within one bfloat16 rounding of
     world 1's, every float payload bfloat16, each id payload at the
     plan's id wire, the id bytes a rank step. 13b and 13c share one
     spawn of 2 ranks (`wire_world_phase`, `wire_rank`).
  14. (after 13) host offload (``gpu_embedding_size``). 14a
     (`offload_hold_phase`): DLRM at Criteo x 0.02 with a device budget
     of x 0.4 of its elements, which sends its three largest tables to
     pinned host memory, against the same model with every table on the
     card, from one set of weights and MLPs: 3 sgd steps at the example's
     schedule (losses at LOSS_TOL, the offloaded tables bit for bit;
     launches 1 / 2 / 1 a step), 2 adagrad steps (the offloaded tables at
     rtol 2e-5 / atol 2e-5, the JAX test's bar, their largest ulp
     printed), then both at int8 storage, 2 sgd steps (losses at
     LOSS_TOL, every offloaded element within one grid step a step of the
     all-device model's, each host apply replayed bit for bit by the
     numpy functions). Every float32 host apply runs the C++ loops
     (`host_apply_rows_inplace`; its calls checked, one a step and
     offloaded bucket) and is held against the numpy twin on the same rows
     (`CppApplyTap`, `hold_cpp_applies`: sgd bit for bit, adagrad and adam
     (adam on the first call's rows with seeded moments) at rtol / atol
     1e-6 with the largest ulp). 14b (`offload_full_phase`): the host's
     MemAvailable, then DLRM at the MLPerf Criteo-1TB sizes in float32 with
     ``gpu_embedding_size`` the x 0.4 tables' elements: its three largest
     tables (61.2 GB) pinned on the host (`HostPin`: exactly their bytes),
     the other 23 (34.9 GB) on the card; the build's seconds, the pinned
     bytes, `memory_allocated` beside the device bucket's bytes; 22 sgd
     steps through `fit` from a split-binary dataset (launches 1 / 2 / 1 a
     step, checked), step times, samples/s, one profiled step (idle
     share; the ``offload:lookup`` and ``offload:update`` ranges' host ms,
     one call each; HtoD and DtoH copies; the bytes the layer moved), peak
     memory, the on-card AUC against `auc_exact`, a 65,536-row request
     through `InferenceEngine`; the C++ applies counted (one a step) and
     ``offload:update``'s host ms beside the numpy apply's 99.68
     (NUMPY_UPDATE_HOST_MS); one step's
     rows applied again by the C++ loops and by the numpy twin, timed
     (`time_host_apply`, the plain yardstick). 14c (`cached_serving_phase`,
     inside 14b on its trained model): `InferenceEngine(cache_capacity=
     1,048,576, promote_threshold=2)`, a `HotRowCache` (0.5 GiB of slots)
     over the offloaded bucket, beside the uncached engine; 12 seeded
     ClickGenerator requests of 65,536 rows (another seed than training's):
     each request's logits `torch.equal` to the uncached engine's, hits
     and promotions above 0, `lookup_combine` once a forward (the device
     bucket); the hit rate by request and cumulative, promotions,
     evictions, serve ms and the offloaded lookup's host ms cached beside
     uncached, the HtoD bytes of each run, the slots' bytes.
  15. (after 14) criteo_vocab (`criteo_vocab_phase`): the Criteo
     example's on-the-fly vocabulary flow (`tools/criteo_example.py`) at
     its full width: 26 `IntegerLookup`s of max_tokens 100,000 and 26
     tables of 100,001 x 128 float32 (1.33 GB, 2.66 GB of adam state), MLP
     512-256-1 over 13 + 26 x 128 inputs, batch 4,096 of the example's
     synthetic zipf keys (seed 0), dense adam at lr 1e-3. Every batch's
     keys through the C++ map and the numpy twin: ids, vocabularies,
     counts and sizes equal batch for batch; 3 adam steps held against
     the CPU from the card's weights and state, in two halves: the CPU
     model's forward and backward under the card's ReLU masks (losses at
     LOSS_TOL; every gradient, the card's caught at its optimizer, within
     rtol 1e-5 plus 2 * 2**-24 of its terms' magnitudes through every
     layer), then the CPU's adam twin on the card's gradient (the values
     within rtol 1e-5 of the value or, where larger, its change, plus an
     ulp; the moments bit for bit; rows adam does not move unchanged);
     then the control: one more step with the card's gemms in TF32 (the
     CPU on the card's ReLU masks whatever their margin) must fail the
     gradient bar (``criteo_tf32_control``);
     30 steps through the ingest pipeline and 30 inline from the same
     weights: losses, vocabularies, tables and MLP bit for bit. No CUDA
     kernel of the port runs on this path (checked); the native calls are
     26 translations a step. Printed: step median and samples/s, the
     ``lookup`` and ``stage`` means, one profiled step's idle share, peak
     memory, vocabulary sizes; then `--bench_lookup` at 16,777,216 keys
     (max_tokens 20,000,000): native and numpy keys/s, the host's CPUs.
  16. (after 15) store_vocab (`store_vocab_phase`): the table store and
     the dynamic vocabulary (ROADMAP A12). Full-size Tiny V3 built with
     ``vocab_slack=8192`` (450,560 more rows), adagrad at 0.01, batches
     of 65,536 of phase 5's power-law ids whose 7 managed tables (the
     shared 10,000 x 8, the four one-hot 10,000 x 8, the two one-hot
     100,000 x 16) carry raw keys, a quarter of each table's ranks moved
     to fresh keys every 4 steps (`drifting_raw_batches`). ``fit`` for 24
     pipelined steps with ``store=TableStore(layer), publish_every=4``
     into a temporary directory and ``vocab=VocabManager(admit_threshold
     2, decay 0.98), vocab_every=4``: launches 4 / 1 / 1 a step; every
     maintain cycle held (`MaintainHold`: each evicted key's stash bit-equal
     to its row before the cycle, each newly bound row zeros or its
     stashed row, its accumulator rows zero, occupancy at most the high
     watermark), admissions and evictions both above 0. A second full
     Tiny on the card (another seed) polls the directory after each
     publish (`ConsumerHold`): every bucket `torch.equal` to the
     publisher's at every version. A consumer-side manager loads the
     newest sidecar; an engine over the consumer (the publisher's MLP
     copied in) serves a 65,536-row request of raw keys with logits
     bit-equal to the publisher's engine; `restore_from_published` into
     the consumer equals the publisher's tables; the same 24 steps from
     the same initial weights with ``pipelined=False`` and publishing off
     give bit-identical losses, tables and accumulators (both runs under
     `deterministic_sums`: bucket 0's dense `index_add_` otherwise adds
     in another order each run). Printed: step median (steps with no
     maintain or publish), host ms of translation with observation, of
     the store's observation and of each cycle, publish / apply seconds
     and bytes by file, restore seconds, version lag, churn and fallback
     hit rate by table, peak memory, the temp directory's free space
     before the phase and the bytes written. 16b (`FleetHold`, a callback
     beside `ConsumerHold`; the host's MemAvailable checked first): two
     replicas, r0 and r1, each an embedding-only engine over a full-size
     Tiny layer with the same slack and its width-16 bucket (4.5 GB)
     pinned on the host under a 262,144-row `HotRowCache`, a query-only
     `VocabManager` over the 7 tables, one registry, behind
     `FleetRouter(canaries=1, reference_weights=<the publisher's weights
     at the version just published>)`; r1 joins after the third publish
     and catches up through the snapshot and the deltas. After every
     other publish (every one took ~150 s in all, past the 90 s allowed)
     the router promotes the version at parity 0.0, then 8
     requests of 4,096 rows of the step's raw keys go through `submit` /
     `flush` (`lookup_combine` once a forward for each of bucket 0's
     groups), each output `torch.equal` to the serving replica's layer
     forward with the cache scope off and within rtol 1e-6 / atol 1e-7 of
     the publisher's layer on the same translation; at the end no shed,
     no router error, no degraded reason, no poll error. Printed: the
     promoted versions, the pin, the catch-up and apply seconds by kind,
     each cache's hit rate, promotions and slots patched from deltas, the
     pinned bytes, the largest ulp gap to the publisher, the fleet's
     seconds.
  17. (inside 16, on its stream) stream_world (`stream_world_phase`, A13b):
     the serving tier at W = 2, two ranks sharing the card over gloo
     (`stream_world_rank`). Each builds full-size Tiny at W = 2 with
     phase 16's ``vocab_slack`` and ``gpu_embedding_size=fleet_budget``
     (its 35.2M-row width-16 bucket share, 2.25 GB, pinned on the host)
     under a 262,144-row `HotRowCache` (16b's), and consumes phase 16's
     publish directory with ``poll_updates(upto=v)`` for each published
     version v in turn (the snapshot, then every delta). At every version:
     each table's digest (`placement_digests`, the rank's own rows,
     reduced on the card) equal to the world-1 publisher's at that version
     (`ConsumerHold` records them), then STREAM_WORLD_REQUESTS new
     requests of STREAM_WORLD_ROWS rows of physical power-law ids, each
     rank's cached
     output `torch.equal` to an uncached engine's over the same layer, and
     both ranks' cache stats and slot keys equal. Printed: the hit rate,
     promotions, evictions, serve ms cached and uncached, the snapshot's
     and the deltas' apply seconds, the launches (2 a forward: the
     width-8 bucket's two groups) and the phase's seconds.
  18. (after 16) lookahead (`lookahead_phase`, A14): full-size Tiny V3,
     adagrad at 0.01, batches of 65,536 (phase 5's ids), LOOKAHEAD_STEPS
     steps through `LookaheadEngine(lookahead=0)` and the same steps from
     the same initial weights through ``lookahead=1`` (``patch_capacity``
     the batch: every stale sample patched), both under
     `deterministic_sums`: every loss equal and every bucket's and
     accumulator's digest (on the card) equal step by step; then
     LOOKAHEAD_TIMED steps each way timed outside `deterministic_sums`
     and one profiled step each way (idle share); then ``stale_ok=True``
     on a fresh model (finite losses). Printed: step ms both ways, the
     profiles, the patched samples and fallback recomputes a step, the
     launches a step both ways, and the host ms of the engine's two host
     walks (`touched_row_keys` of one batch, `prefetch_stale_mask` of the
     next against it) with the stale share they give.
  19. (after 18) obs (`obs_phase`, A15a): full-size Tiny V3, adagrad at
     0.01, OBS_STEPS batches of 65,536 power-law rows through
     ``fit(registry=reg, store=, publish_every=4, publish_dir=)`` inside
     `utils.profiling.trace`, under `deterministic_sums`: launches 4 / 1
     / 1 a ``train/step`` span; the capture's device time by span
     (`obs.attribution`, the sum identity exact in ns, ``train/step``'s
     time above 0). A second Tiny in an `InferenceEngine(registry=reg)`
     applies the stream (digests equal the publisher's) and serves 4
     requests of 4,096 rows through a `MicroBatcher` (4 launches a
     ``serve/predict`` span, logits equal to the publisher's engine's).
     The port's tier-1 SLO rules give no finding; the flight recorder's
     export balances; each version's lineage runs commit -> publish ->
     scan -> apply -> serve; the JSONL line and the Prometheus text
     parse; the ``exchange/*`` gauges equal a fresh report. Then the same
     steps with no registry, no profiler and no store: losses and every
     digest equal. Printed (``obs_attribution``, ``main_path`` ``obs``): device
     seconds by span, unattributed, total, the top device ops; the step
     ms of both runs; one span's host µs; the phase's seconds.
  7. the kernels line (each kernel's launches by path, the world paths'
     summed over the ranks; `sgd_rows` with ``copy_ms``, an
     `index_select` + `index_copy_` of the same rows, as a second
     yardstick; the bf16 store form of `lookup_combine` timed at DLRM x
     0.4's call, its round-first form at row shard 0's, ``at_other`` each
     at 11a's other calls), the card's line, and the last
     line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or when the port
is not beside this script.
"""

import atexit
import contextlib
import ctypes
import gc
import json
import math
import os
import re
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
LOOKUP_SOURCE = os.path.join(REPO, "distributed_embeddings_tpu_torch", "csrc",
                             "lookup_combine.cu")
ONE_HOT_ROWS_LINE = re.compile(r"constexpr int kOneHotRows = (\d+);")
# the one-hot kernel's edge cases (phase 3) run at these widths: 6 takes
# the scalar path, 256 the column-chunk loop
ONE_HOT_WIDTHS = (6, 8, 16, 128, 256)
# kOneHotRows values the one-hot kernel is timed at, at DLRM's call (11a)
ONE_HOT_SWEEP = (2, 4, 8)
SPARSE_SOURCE = os.path.join(REPO, "distributed_embeddings_tpu_torch", "csrc",
                             "sparse_apply.cu")
# sgd_rows' edge cases (phase 3b): 6 takes the scalar path, 132 and 256
# the column-chunk loop
SGD_EDGE_WIDTHS = (6, 8, 16, 128, 132, 256)
SGD_EDGE_LAYOUTS = ("dedup", "interleaved", "negative", "all_fillers",
                    "no_fillers")
# sgd_rows' walk built with 2 rows a group, with one pass's `rep` loads
# in flight a warp, and with the contiguous slot order (a warp's 32
# neighbouring slots a pass), each timed beside the source's at cut
# Tiny's calls (phase 6), DLRM x 0.4's (phase 9) and row shard 0's (10)
SGD_ROWS_VARIANTS = {
    "rows2": ("constexpr int kSgdRows = 4;", "constexpr int kSgdRows = 2;"),
    "ahead1": ("constexpr int kRepAhead = 4;",
               "constexpr int kRepAhead = 1;"),
    "contiguous": ("(lane / run * warps + warp) * run + lane % run;",
                   "warp * 32 + lane;")}
SGD_ROWS_SWEEP_DIR = os.path.join(REPO, "build", "sgd_rows_sweep")
TPU_SITES = {
    "lookup_combine": ["distributed_embeddings_tpu/ops/pallas_lookup.py:116",
                       "distributed_embeddings_tpu/ops/pallas_lookup.py:224"],
    "lookup_combine_bf16": [
        "distributed_embeddings_tpu/ops/pallas_lookup.py:116",
        "distributed_embeddings_tpu/ops/pallas_lookup.py:224 (then the cast, "
        "distributed_embeddings_tpu/layers/dist_model_parallel.py:1424)"],
    "lookup_combine_bf16_round": [
        "distributed_embeddings_tpu/ops/pallas_lookup.py:116",
        "distributed_embeddings_tpu/ops/pallas_lookup.py:224 (in the form of "
        "the XLA route, distributed_embeddings_tpu/layers/"
        "dist_model_parallel.py:2138-2151)"],
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
# lookup_combine's mixed-precision forms
AMP_FORMS = ("lookup_combine_bf16", "lookup_combine_bf16_round",
             "lookup_combine_f16", "lookup_combine_f16_round")
# the kernels of every path, by the module that counts their launches
ALL_KERNELS = ("lookup_combine", *AMP_FORMS, "segment_sum_sorted", "sgd_rows",
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


def one_hot_rows() -> int:
    """kOneHotRows of csrc/lookup_combine.cu: the rows a thread group of
    the one-hot kernel takes a batch."""
    with open(LOOKUP_SOURCE) as f:
        return int(ONE_HOT_ROWS_LINE.search(f.read()).group(1))


def same_bits(torch, got, want) -> bool:
    """Equal dtypes and equal bits (so +0 and -0 differ)."""
    view = {4: torch.int32, 2: torch.int16}[got.element_size()]
    return got.dtype == want.dtype and torch.equal(got.view(view),
                                                   want.view(view))


def one_hot_cases(torch, cuda_lookup):
    """Phase 3, K = 1: the one-hot kernel bit for bit against the plain
    version in every form (float32, the bf16 and f16 stores and their
    round-first forms), with int32 and int64 ids (some below 0, some past
    V), unweighted and with weights in [-2, 2) (a zero table row times a
    negative weight gives -0, which both store as +0), at ONE_HOT_WIDTHS
    and at N = 1, R - 1 (R = kOneHotRows), 777 (a part batch) and 8 rows
    for each thread the card can hold (2,048 an SM): more than one pass
    of the kernel's grid at any width of 5 or more (a group of 2 or more
    threads) with R up to 8. One `one_hot_kernel` line a width. Returns
    the max absolute error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    vocab = 5000
    rows = one_hot_rows()
    past_grid = 8 * 2048 * torch.cuda.get_device_properties(
        0).multi_processor_count
    sizes = (1, rows - 1, 777, past_grid)
    forms = [(torch.float32, False)] + [
        (getattr(torch, d), rnd) for d in ("bfloat16", "float16")
        for rnd in (False, True)]
    worst = 0.0
    for width in ONE_HOT_WIDTHS:
        table = torch.empty((vocab, width), device="cuda").uniform_(
            -0.05, 0.05, generator=gen)
        table[0] = 0.0
        cases = 0
        for n in sizes:
            base = torch.randint(-3, vocab + 3, (n, 1), device="cuda",
                                 generator=gen)
            w = torch.empty((n, 1), device="cuda").uniform_(
                -2.0, 2.0, generator=gen)
            for id_dtype in (torch.int32, torch.int64):
                ids = base.to(id_dtype)
                for weights in (None, w):
                    for out_dtype, rnd in forms:
                        got = cuda_lookup.lookup_combine(table, ids, weights,
                                                         out_dtype, rnd)
                        want = cuda_lookup.lookup_combine_plain(
                            table, ids, weights, out_dtype, rnd)
                        torch.cuda.synchronize()
                        err = (got.float() - want.float()).abs().max().item()
                        check(same_bits(torch, got, want),
                              f"one-hot {cuda_lookup.form_name(out_dtype, rnd)}"
                              f" width {width} N {n} {id_dtype} weighted "
                              f"{weights is not None}: not bit-equal to the "
                              f"plain version, max abs err {err}")
                        worst = max(worst, err)
                        cases += 1
                        del got, want
        emit(phase="one_hot_kernel", width=width, n=list(sizes),
             cases=cases, max_abs_err=worst, ok=True)
    return worst


def start_variant_builds(kernel_build, source, variants, out_dir):
    """nvcc, started in the background with the library's flags (and the
    source's directory for its headers), on copies of `source` in
    `out_dir`, one a variant: {tag: (old, new)}, the copy's one text
    substitution, whose text must be in the source. Returns {tag:
    (process, library)}."""
    with open(source) as f:
        text = f.read()
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.basename(source)[:-len(".cu")]
    builds = {}
    for tag, (old, new) in variants.items():
        check(old in text, f"{stem} variant {tag}: no '{old}' in the source")
        src = os.path.join(out_dir, f"{stem}_{tag}.cu")
        with open(src, "w") as f:
            f.write(text.replace(old, new))
        lib = src[:-len(".cu")] + ".so"
        builds[tag] = (subprocess.Popen(
            [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS,
             "-I", os.path.dirname(source), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    return builds


def finish_variant_builds(builds):
    """{tag: (library loaded, its `ptxas_usage`)} once every build of
    `start_variant_builds` has ended; fails on a failed build."""
    from distributed_embeddings_tpu_torch.ops import kernel_build
    out = {}
    for tag, (proc, path) in builds.items():
        log = proc.communicate(timeout=600)[0].decode(errors="replace")
        check(proc.returncode == 0, f"nvcc of variant {tag} failed:\n{log}")
        out[tag] = (ctypes.CDLL(path), kernel_build.parse_ptxas(log))
    return out


def start_one_hot_builds(kernel_build, tmp):
    """`start_variant_builds` of csrc/lookup_combine.cu at each kOneHotRows
    of ONE_HOT_SWEEP but the source's own. Returns {R: (process,
    library)}."""
    own = one_hot_rows()
    line = f"constexpr int kOneHotRows = {own};"
    return start_variant_builds(kernel_build, LOOKUP_SOURCE, {
        r: (line, f"constexpr int kOneHotRows = {r};")
        for r in ONE_HOT_SWEEP if r != own}, tmp)


@contextlib.contextmanager
def swapped_library(kernel_build, name, lib):
    """The entry points of ``csrc/<name>.cu`` taken from the loaded
    library `lib` inside the block."""
    saved = kernel_build.load(name)
    kernel_build._LIBS[name] = lib
    try:
        yield
    finally:
        kernel_build._LIBS[name] = saved


def one_hot_rows_sweep(torch, cuda_lookup, kernel_build, builds, call, at):
    """11a: the one-hot kernel at each kOneHotRows of ONE_HOT_SWEEP (the
    source's own through the package's library, the others from
    `start_one_hot_builds`) on one call (table, ids, weights): each
    bit-equal to the plain version in the float32 and bf16 store forms,
    then both timed (CUDA graph replays) in turns, R ascending, then
    descending. Prints a `one_hot_rows` line: ms by R and form, each
    library's one-hot registers and spill bytes."""
    table, ids, weights = call
    own = one_hot_rows()
    built = finish_variant_builds(builds)
    libs = {own: kernel_build.load("lookup_combine"),
            **{r: lib for r, (lib, _) in built.items()}}
    usage = {own: kernel_build.ptxas_usage("lookup_combine"),
             **{r: u for r, (_, u) in built.items()}}
    forms = (torch.float32, torch.bfloat16)
    want = {d: cuda_lookup.lookup_combine_plain(table, ids, weights, d)
            for d in forms}
    ms = {r: {cuda_lookup.form_name(d): [] for d in forms} for r in libs}
    order = sorted(libs)
    for turn in (order, order[::-1]):
        for r in turn:
            with swapped_library(kernel_build, "lookup_combine", libs[r]):
                for d in forms:
                    if turn is order:
                        got = cuda_lookup.lookup_combine(table, ids, weights,
                                                         d)
                        torch.cuda.synchronize()
                        check(same_bits(torch, got, want[d]),
                              f"one-hot kernel at kOneHotRows = {r}, "
                              f"{cuda_lookup.form_name(d)}: not bit-equal "
                              f"to the plain version at {at}")
                        del got
                    ms[r][cuda_lookup.form_name(d)].append(device_ms(
                        lambda: cuda_lookup.lookup_combine(table, ids,
                                                           weights, d),
                        reps=20))
    del want
    emit(phase="one_hot_rows", at=at, source_rows=own,
         table=list(table.shape), ids=list(ids.shape), ms=ms,
         one_hot_ptxas={r: {k: v for k, v in u.items()
                            if "one_hot_kernel" in k}
                        for r, u in usage.items()}, ok=True)


def sgd_rows_usage(usage):
    """The `sgd_rows_kernel` entries of a library's `ptxas_usage`."""
    return {k: u for k, u in usage.items() if "sgd_rows_kernel" in k}


def start_sgd_rows_builds(kernel_build):
    """`start_variant_builds` of csrc/sparse_apply.cu at each variant of
    SGD_ROWS_VARIANTS, into SGD_ROWS_SWEEP_DIR (where phase 10's rank 0
    finds them)."""
    return start_variant_builds(kernel_build, SPARSE_SOURCE,
                                SGD_ROWS_VARIANTS, SGD_ROWS_SWEEP_DIR)


def sgd_rows_variant_libs():
    """{tag: library} of `start_sgd_rows_builds`' finished builds."""
    paths = {tag: os.path.join(SGD_ROWS_SWEEP_DIR, f"sparse_apply_{tag}.so")
             for tag in SGD_ROWS_VARIANTS}
    missing = sorted(p for p in paths.values() if not os.path.exists(p))
    check(not missing, f"sgd_rows variants not built (start_sgd_rows_builds "
          f"and finish_variant_builds first): {missing}")
    return {tag: ctypes.CDLL(p) for tag, p in paths.items()}


def sgd_rows_sweep(torch, cuda_sparse, call, at):
    """`sgd_rows` as the source builds it and as each variant of
    SGD_ROWS_VARIANTS (`sgd_rows_variant_libs`) on one call (table, rep,
    sums, lr): each bit-equal to the plain version on compact copies of
    the touched rows, then timed (CUDA graph replays; the replays update
    the table) in turns, the source first, then in reverse. Prints an
    `sgd_rows_variants` line: ms by variant."""
    from distributed_embeddings_tpu_torch.ops import kernel_build
    table, rep, sums, lr = call
    libs = {"source": kernel_build.load("sparse_apply"),
            **sgd_rows_variant_libs()}
    ms = {tag: [] for tag in libs}
    order = list(libs)
    for turn in (order, order[::-1]):
        for tag in turn:
            with swapped_library(kernel_build, "sparse_apply", libs[tag]):
                if turn is order:
                    hold_rows_compact(torch, cuda_sparse, "sgd", (table,),
                                      rep, sums, (lr,))
                ms[tag].append(device_ms(
                    lambda: cuda_sparse.sgd_rows(table, rep, sums, lr),
                    reps=10))
    emit(phase="sgd_rows_variants", at=at, table=list(table.shape),
         slots=int(rep.numel()), variants={
             tag: new for tag, (_, new) in SGD_ROWS_VARIANTS.items()},
         ms=ms, ok=True)


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


def lookup_args(calls):
    """(table, ids, weights) of captured `lookup_combine` calls (the
    layer passes its output dtype, and a row shard the round-first flag,
    after them)."""
    return [tuple(args[:3]) + (None,) * (3 - len(args[:3])) for args in calls]


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


def sgd_edge_rep(torch, gen, layout, n, vocab, id_dtype):
    """rep of n slots over a table of `vocab` (> n) rows, in one of
    SGD_EDGE_LAYOUTS: dedup's (a third of the slots, at least one, hold
    sorted unique rows, then fillers V + s), fillers >= V at random slots
    between unsorted unique rows (interleaved), the same with most fillers
    negative (negative), fillers only (half of them negative), or n unique
    rows in random order (no fillers)."""
    rows = torch.randperm(vocab, device="cuda", generator=gen)[:n]
    slot = torch.arange(n, device="cuda")
    fillers = vocab + slot
    if layout == "negative":
        fillers = torch.where(slot % 3 == 0, fillers, -1 - slot)
    if layout == "dedup":
        u = max(1, n // 3)
        rep = torch.cat([rows[:u].sort().values, fillers[:n - u]])
    elif layout in ("interleaved", "negative"):
        keep = torch.rand((n,), device="cuda", generator=gen) < 0.5
        rep = torch.where(keep, rows, fillers)
    elif layout == "all_fillers":
        rep = torch.where(slot % 2 == 0, fillers, -1 - slot)
    else:
        rep = rows
    return rep.to(id_dtype)


def sgd_rows_edge_cases(torch, cuda_sparse):
    """Phase 3b, `sgd_rows`' walk: bit for bit against `sgd_rows_plain`,
    one launch a call, at every layout of SGD_EDGE_LAYOUTS, int32 and
    int64 rep, lr TRAIN_LR and -1 (pallas_scatter's add), widths
    SGD_EDGE_WIDTHS, and N = 1, 31, 32, 33 and more slots than one pass
    of its grid covers (32 a resident warp, at most 64 warps an SM). One
    `sgd_rows_edges` line a width. Returns the max absolute error."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    sizes = (1, 31, 32, 33, 2048 * torch.cuda.get_device_properties(
        0).multi_processor_count + 33)
    worst = 0.0
    for width in SGD_EDGE_WIDTHS:
        cases = 0
        for n in sizes:
            vocab = n + 64
            base = torch.empty((vocab, width), device="cuda").uniform_(
                -0.05, 0.05, generator=gen)
            sums = torch.randn((n, width), device="cuda", generator=gen)
            for layout in SGD_EDGE_LAYOUTS:
                for id_dtype in (torch.int32, torch.int64):
                    rep = sgd_edge_rep(torch, gen, layout, n, vocab, id_dtype)
                    for lr in (TRAIN_LR, -1.0):
                        got, want = base.clone(), base.clone()
                        before = cuda_sparse.launches["sgd_rows"]
                        cuda_sparse.sgd_rows(got, rep, sums, lr)
                        cuda_sparse.sgd_rows_plain(want, rep, sums, lr)
                        torch.cuda.synchronize()
                        err = (got - want).abs().max().item()
                        check(same_bits(torch, got, want)
                              and cuda_sparse.launches["sgd_rows"]
                              == before + 1,
                              f"sgd_rows {layout} width {width} N {n} "
                              f"{id_dtype} lr {lr}: not bit-equal to the "
                              f"plain version (max abs err {err}) or not "
                              f"one launch")
                        worst = max(worst, err)
                        cases += 1
            del base, sums, got, want
        emit(phase="sgd_rows_edges", width=width, n=list(sizes),
             layouts=list(SGD_EDGE_LAYOUTS), cases=cases, max_abs_err=worst,
             ok=True)
    return worst


def set_counts(cuda_lookup, *counted):
    """Every launch count of `cuda_lookup` and the `counted` modules to
    0."""
    for module in (cuda_lookup, *counted):
        for key in module.launches:
            module.launches[key] = 0


def read_counts(cuda_lookup, *counted) -> dict:
    out = {}
    for module in (cuda_lookup, *counted):
        out.update(module.launches)
    return out


# the native host library's calls by path (`native.loader.calls`, read
# just after each path that runs it); the run's `native` line prints them
NATIVE_CALLS: dict = {}


def set_native_calls():
    """Every call count of the native host library to 0."""
    from distributed_embeddings_tpu_torch.native import loader
    for key in loader.calls:
        loader.calls[key] = 0


def read_native_calls(path=None) -> dict:
    """The native host library's call counts (kept under `path` for the
    `native` line)."""
    from distributed_embeddings_tpu_torch.native import loader
    calls = dict(loader.calls)
    if path is not None:
        NATIVE_CALLS[path] = calls
    return calls


def per_step(launched: dict, steps: int) -> dict:
    """The launch counts `steps` steps give when each step launches the
    kernels of `launched` so often and no other kernel."""
    return {k: launched.get(k, 0) * steps for k in ALL_KERNELS}


def dense_names(model):
    return [n for n, p in model.named_parameters() if p.requires_grad]


def mlp_params(model) -> dict:
    """The model's dense parameters outside its embedding layer (whose
    data-parallel tables train densely too): {name: parameter}."""
    return {n: p for n, p in model.named_parameters()
            if p.requires_grad and not n.startswith("embedding.")}


def ulp(torch, x):
    """The float32 spacing at |x|."""
    x = x.abs()
    return torch.nextafter(x, torch.full_like(x, math.inf)) - x


def hold(torch, what, got, want, before, steps, mode, cond=None, lr=None,
         eps=SUM_EPS, mag=None, rtol=TRAIN_TOL["rtol"]):
    """The card's trainer (`got`) against the CPU trainer (`want`) after
    `steps` steps from `before`, on the same elements (CPU tensors).
    `cond` (optional): per element t/|g| of the step's gradient g and the
    sum t of its terms' magnitudes (`training.gradient_scale`). The two
    trainers' terms differ in their last digits (cuBLAS against the CPU's
    BLAS), so the float32 sums differ by up to about SUM_EPS * t, and by
    SUM_EPS * t/|g| relative to g; above 1/ILL_SCALE the gradient is a
    sum that cancels, "ill".
    mode "change": |change(got) - change(want)| within `rtol` (1e-4 by
    default) of the change plus `steps` ulps of the values (each step
    rounds once on each side), plus, with `cond`, 2 * SUM_EPS * t/|g| of
    the change (a change of sgd or adagrad carries its gradient's relative
    error, the accumulator's square twice; `eps`, SUM_EPS by default, may
    be a tensor broadcast over the elements: `sum_eps` widens it on rows
    that a dense aggregation summed in another order); sgd and adagrad at
    batch 65,536 move most table elements by far less than TRAIN_TOL's
    atol, where a value check would not see a row left out. Sums that
    cancel exactly (g == 0 from terms, t/|g| infinite) are not held.
    mode "value": TRAIN_TOL (adam moves each element by about lr per
    step), but, with `cond` and adam's `lr`, 1e-2 * lr at ill elements:
    adam's step does not scale with the gradient, so its low digits move
    such an element by a share of lr.
    mode "gradient": `got` and `want` are one step's gradients (`before`
    None), within `rtol` of `want` plus 2 * `eps` of `mag`, the sum of the
    magnitudes of their terms (`training.mlp_magnitudes`).
    mode "update": an update from the same gradient and state, within
    `rtol` of the larger of the value and its change (adam moves an
    element by about lr, more than an element near zero) plus `steps`
    ulps of the values (the CPU's square root is rounded within an ulp,
    not always to the nearest).
    The arithmetic runs on the card where there is one (each operation is
    elementwise and correctly rounded, so the bars and the verdict are the
    CPU's to the bit), and `change` stays there. Returns (max |got - want|
    over the held elements, |change(want)|, how many changes exceed the
    rounding allowance, the largest share of its bar an element used)."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    if before is None:
        before = torch.zeros_like(want)
    got, want, before = (x.to(dev) for x in (got, want, before))
    if cond is not None:
        cond = cond.to(dev)
    if torch.is_tensor(eps):
        eps = eps.to(dev)
    got64, want64 = got.double(), want.double()
    change = (want64 - before.double()).abs()
    diff = (got64 - want64).abs()
    rounding = steps * ulp(torch, torch.maximum(
        torch.maximum(got.abs(), want.abs()), before.abs())).double()
    if mode == "change":
        bar = rtol * change + rounding
        if cond is not None:
            cond64 = cond.double()
            eps64 = (eps.double() if torch.is_tensor(eps)
                     else torch.tensor(eps, dtype=torch.float64,
                                       device=dev))
            bar = torch.where(torch.isinf(cond64), math.inf,
                              bar + 2 * eps64 * cond64 * change)
    elif mode == "value":
        bar = TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * want64.abs()
        if cond is not None and lr is not None:
            bar = torch.where(cond > 1 / ILL_SCALE,
                              torch.full_like(bar, 1e-2 * lr), bar)
    elif mode == "gradient":
        bar = rtol * want64.abs() + 2 * eps * mag.to(dev).double()
    elif mode == "update":
        bar = rtol * torch.maximum(want64.abs(), change) + rounding
    else:
        raise ValueError(f"hold: unknown mode {mode!r}")
    bad = diff > bar
    if bool(bad.any()):
        i = int((diff - bar).flatten().argmax())
        cond_i = None if cond is None else cond.flatten()[i].item()
        raise SmokeFailure(
            f"{what}: {int(bad.sum())} of {diff.numel()} elements disagree "
            f"with the reference trainer; worst {diff.flatten()[i].item()} "
            f"against a bar of {bar.flatten()[i].item()} and a change of "
            f"{change.flatten()[i].item()} (t/|g| {cond_i})")
    held = torch.isfinite(bar)
    if not bool(held.any()):
        return 0.0, change, int((change > rounding).sum()), 0.0
    share = torch.where(diff[held] > 0, diff[held] / bar[held], 0.0)
    return (diff[held].max().item(), change,
            int((change > rounding).sum()), share.max().item())


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
        err, *_ = hold(torch, f"{label}: {name}", got, cpu_after[0][name],
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
                err, change, n, _ = hold(torch, what, got, want, old, steps,
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
    """Per bucket, t/|g| at the touched rows (on the CPU) from the
    reference step's `dedup_sum` calls (`calls`: (positional, keyword)
    arguments of each: ids, contribs, sentinel): g the row's sum of
    contributions, t the sum of their magnitudes (0 without terms,
    infinite where they cancel exactly). The conditioning of the row sums
    alone, for a model without `gradient_scale` (DLRM): each contribution
    row is one sample's gradient, which the two trainers compute to a few
    ulps."""
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
        rows = touched[b].to(rep.device)
        at = torch.searchsorted(rep, rows)
        check(bool((rep.index_select(0, at) == rows).all()),
              "a touched row has no dedup segment in the reference step")
        g, t = g.index_select(0, at).cpu(), t.index_select(0, at).cpu()
        out[b] = torch.where(t > 0, t / g.abs(), torch.zeros_like(t))
    return out


def dlrm_tap_cond(torch, model, batch, touched):
    """Per bucket, at the touched rows ([rows, width], CPU), the
    conditioning of a 16-bit DLRM's tap gradients: t/|g| of each row's
    sum over the batch of G_j = sum_k g_jk e_k, the gradient the pairwise
    dots' gradient g (symmetric, float32) gives feature j, against t, the
    same sum with every g_jk and e_k by magnitude. g is the gradient of
    the rounded interaction output, rounded to the compute dtype by the
    cast's transpose: one rounding on each trainer may put a g_jk a unit
    of bfloat16 apart (2^-7 of it), which moves G_j by up to 2^-7 t, and
    a sum that cancels carries that as a large share of its value. Run
    on `model` (the CPU model, under the card's ReLU masks) before its
    step."""
    from distributed_embeddings_tpu_torch.models.dlrm import _tril_index
    num, cats, labels = batch
    layer = model.embedding
    dtype = model.compute_dtype or torch.float32
    bottom = model.bottom_mlp(torch.as_tensor(num, dtype=torch.float32)
                              .to(dtype)).detach()
    with torch.no_grad():
        emb = layer([torch.as_tensor(c) for c in cats])
    feats = torch.stack([bottom] + [e.float() for e in emb], dim=1)
    gram = torch.bmm(feats, feats.transpose(1, 2)).requires_grad_()
    n = feats.shape[1]
    pairwise = gram.reshape(gram.shape[0], n * n)[:, _tril_index(
        n, gram.device)]
    logits = model.top_mlp(torch.cat([pairwise, bottom], dim=1).to(dtype))
    logits = logits[:, 0].float()
    lab = torch.as_tensor(labels, dtype=torch.float32).reshape(-1)
    loss = torch.mean(torch.clamp_min(logits, 0) - logits * lab
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    (g,) = torch.autograd.grad(loss, gram)
    g = g + g.transpose(1, 2)
    t_all = g.abs() @ feats.abs()                   # [B, n, d]
    g_all = g @ feats
    out = []
    for b, idx in enumerate(touched):
        t_rows = torch.zeros((idx.numel(), feats.shape[2]),
                             dtype=torch.float64)
        g_rows = torch.zeros_like(t_rows)
        for p in layer.plan.tp_placements:
            if p.bucket != b:
                continue
            gtid = layer.strategy.table_groups[1][p.table_id]
            for i, t in enumerate(layer.strategy.input_table_map):
                if t != gtid:
                    continue
                rows = (torch.as_tensor(cats[i]).long().reshape(-1)
                        .clamp(0, p.rows - 1) + p.row_offset)
                pos = torch.searchsorted(idx, rows).clamp_max(
                    max(idx.numel() - 1, 0))
                check(bool((idx[pos] == rows).all()),
                      "a looked-up row is not among the step's touched rows")
                t_rows.index_add_(0, pos, t_all[:, i + 1].double())
                g_rows.index_add_(0, pos, g_all[:, i + 1].double())
        out.append(torch.where(t_rows > 0, t_rows / g_rows.abs(),
                               torch.zeros_like(t_rows)))
    return out


def hot_arrays(torch, model, state):
    """Per hot bucket of `model`'s layer, on the CPU: [its hot rows, then
    the table-shaped tensors of its hot optimizer state]."""
    layer = model.embedding
    return [[layer._hot_entry(b)[1].detach().cpu().clone()]
            + [x.detach().cpu().clone() for x in state["emb"]["hot"][i]
               if torch.is_tensor(x)]
            for i, b in enumerate(layer._hot_buckets)]


def hold_hot(torch, label, after, other, before, cond, counts, steps=1,
             term_eps=0.0):
    """The hot shards of the card's trainer (`after`: `hot_arrays`)
    against another trainer's (`other`), from `before`, by change, as
    `hold` holds a table: per hot bucket, the bar widened by each
    element's conditioning t/|g| (`cond`: `hot_scale`) and its eps by
    (n - 1) 2^-24 for a row the card's atomics summed from n contributions
    (`counts`: `hot_counts`) and by `term_eps` (`hot_eps`). Returns the
    largest error held."""
    check(len(cond) == len(counts) == len(after) == len(other),
          f"{label}: {len(cond)} hot shards' conditioning and {len(counts)} "
          f"counts for {len(after)} hot shards")
    worst = 0.0
    for b, (got_b, want_b, before_b, c, n) in enumerate(zip(
            after, other, before, cond, counts)):
        eps = hot_eps(torch, n, term_eps)
        for i, (got, want, old) in enumerate(zip(got_b, want_b, before_b)):
            err, *_ = hold(torch, f"{label}: hot shard {b} "
                             + ("rows" if i == 0 else f"state {i - 1}"),
                             got, want, old, steps, "change", c, eps=eps)
            worst = max(worst, err)
    return worst


def hold_bounded(torch, what, got, want, before, steps, bound):
    """`got` against `want` (CPU tensors) within rtol 1e-4 of the change
    from `before` plus `steps` ulps of the values, plus `bound` (per
    element, broadcast): how far the difference between the two trainers
    can move each element. Returns the largest |got - want|."""
    got64, want64 = got.double(), want.double()
    change = (want64 - before.double()).abs()
    rounding = steps * ulp(torch, torch.maximum(
        torch.maximum(got.abs(), want.abs()), before.abs())).double()
    bar = TRAIN_TOL["rtol"] * change + rounding + bound.double()
    diff = (got64 - want64).abs()
    bad = diff > bar
    if bool(bad.any()):
        i = int((diff - bar).flatten().argmax())
        raise SmokeFailure(
            f"{what}: {int(bad.sum())} of {diff.numel()} elements disagree; "
            f"worst {diff.flatten()[i].item()} against a change of "
            f"{change.flatten()[i].item()} and a bound of "
            f"{bar.flatten()[i].item()}")
    return diff.max().item() if diff.numel() else 0.0


def train_against_cpu(torch, capture, kind, mode, step, model, state,
                      cpu_step, cpu_model, batches, scaled=None,
                      contrib=False, term_eps=0.0, tap_cond=None,
                      hot=False):
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
    `term_eps`: under a 16-bit compute dtype, how far apart the two
    trainers may round one term (a tap gradient element, an MLP input),
    relative to it (`AMP_TERM_EPS`): one rounding can take the other side
    of a tie-point, so each sum's bar widens by it (`hold`'s eps), and the
    ReLU flips' by twice it. `tap_cond` (with `contrib`): a function
    (torch, cpu model, batch, touched) -> per bucket the tap gradients'
    own conditioning (`dlrm_tap_cond`), of which twice (the terms' and
    the tap's own rounding) joins the row sums'. `hot` (with `scaled`):
    the layer's hot shards too, each step (`hold_hot`: their conditioning
    from the CPU's `gradient_scale`, the card's counts from its own hot
    sums). Returns the card's state and a dict of what was held."""
    from distributed_embeddings_tpu_torch.layers import dist_model_parallel
    from distributed_embeddings_tpu_torch.ops import sparse_update
    from distributed_embeddings_tpu_torch.training import gradient_scale
    out = dict(losses=[], cpu_losses=[], max_abs_err=0.0, changes=[],
               moved=0, touched=[], ill=0, with_gradient=0, relu_flips=[])
    for batch in batches:
        cpu_model.load_state_dict(model.state_dict())
        cpu_state = to_cpu(torch, state)
        hot_before = hot_arrays(torch, model, state) if hot else None
        with (Capture(dist_model_parallel, "_dense_sum") if hot
              else contextlib.nullcontext()) as card_hot:
            (state, loss, touched, counts), masks = relu_masks(
                model, lambda: run_trainer(step, model, state, [batch],
                                           capture))
        touched = touched_rows(torch, model, touched)
        eps = [e + term_eps for e in sum_eps(torch, model, counts, touched)]
        before = trained_arrays(torch, cpu_model, cpu_state, touched)
        taps = None
        if tap_cond is not None:
            with forced_relu(torch, cpu_model, masks, SUM_EPS + 2 * term_eps):
                taps = tap_cond(torch, cpu_model, batch, touched)
        with forced_relu(torch, cpu_model, masks,
                         SUM_EPS + 2 * term_eps) as flips:
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
        if taps is not None:
            table_cond = [torch.maximum(c, 2 * t)
                          for c, t in zip(table_cond, taps)]
        del sums, masks
        if scale is not None and scaled == "dense":
            scale = {k: v for k, v in scale.items()
                     if not k.startswith("embedding.tp.")
                     or model.embedding.tp[int(k.rsplit(".", 1)[1])]
                     .data_ptr() in counts}
        cpu_after = trained_arrays(torch, cpu_model, cpu_state, touched)
        if hot:
            # the conditioning from the CPU's gradient scale, the counts
            # from the card's sums (its atomics add them)
            out["hot_err"] = max(out.get("hot_err", 0.0), hold_hot(
                torch, kind, hot_arrays(torch, model, state),
                hot_arrays(torch, cpu_model, cpu_state), hot_before,
                hot_scale(torch, cpu_model.embedding, scale),
                hot_counts(torch, card_hot.calls)))
            del card_hot, hot_before
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
            for name, (g, t) in scale.items():
                if name.startswith("embedding.tp."):
                    # a bucket's totals are zero off the step's touched
                    # rows: count over those, not over the whole table
                    at = touched[int(name.rsplit(".", 1)[1])].to(t.device)
                    g, t = g.index_select(0, at), t.index_select(0, at)
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
def forced_relu(torch, cpu_model, masks, eps=SUM_EPS):
    """Within the block, every forward of the CPU model's MLPs takes the
    card's ReLU masks (`masks`: `relu_masks` of the card's step, one per
    layer a ReLU follows, `relu_groups`' order). A unit whose
    pre-activation z lies within rounding of 0 may take the other side on
    cuBLAS and on the CPU, and would change every gradient of its batch
    row; where the CPU's z takes the other side, it becomes |z| or -|z|,
    keeping z's gradient (z plus a detached correction, exactly z where
    nothing flips). A flip is a rounding difference only where |z| is
    within `eps` (SUM_EPS; more where the MLP's input is rounded to a
    16-bit compute dtype) of the sum t of its terms' magnitudes (the
    forward by absolute values from its MLP's input, under the card's
    masks): a flip past that fails the phase. Yields a list that gets each
    forward's count of flipped units."""
    groups = relu_groups(cpu_model)
    want = sum(n for _, n in groups)
    check(len(masks) == want,
          f"{len(masks)} ReLU masks from the card's step, want one per "
          f"layer a ReLU follows ({want})")
    flips, first_input = [], {}

    def hook(g, layers, base, i):
        def fn(mod, inp, z):
            if i == 0:
                first_input[g] = inp[0].detach().float()
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
            past = flip[rows] & (zr.abs() > eps * t)
            check(not bool(past.any()),
                  f"MLP {g} layer {i}: {int(past.sum())} ReLU units take the "
                  "other side on the card and on the CPU with |z| past "
                  f"{eps} of its terms' magnitudes")
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
    if not torch.is_tensor(tree):
        return tree
    tree = tree.detach()
    # .cpu() of a card tensor is already a copy
    return tree.clone() if tree.device.type == "cpu" else tree.cpu()


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


def hold_rows_compact(torch, cuda_sparse, kind, arrays, rep, sums, rest):
    """The row kernel of `kind` against its plain version on compact
    copies of the rows `rep` touches (rep renumbered 0..U-1 in slot order,
    its invalid slots U), so the call's own arrays stay as they are.
    Returns the max absolute error."""
    vocab = arrays[0].shape[0]
    valid = (rep >= 0) & (rep < vocab)
    rows = rep[valid].long()
    u = int(rows.numel())
    compact_rep = torch.full_like(rep, u)
    compact_rep[valid] = torch.arange(u, device=rep.device, dtype=rep.dtype)
    got = [a.index_select(0, rows) for a in arrays]
    want = [g.clone() for g in got]
    getattr(cuda_sparse, f"{kind}_rows")(*got, compact_rep, sums, *rest)
    getattr(cuda_sparse, f"{kind}_rows_plain")(*want, compact_rep, sums,
                                               *rest)
    torch.cuda.synchronize()
    return max(hold_equal(torch, f"{kind}_rows", g, w)
               for g, w in zip(got, want))


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
        err = hold_rows_compact(torch, cuda_sparse, kind, arrays, rep, sums,
                                rest)
        worst = max(worst, err)
        ms = device_ms(lambda: kernel(*arrays, rep, sums, *rest), reps=10)
        plain_ms = eager_ms(lambda: plain(*arrays, rep, sums, *rest),
                            reps=3)
        library_ms = copy_ms = None
        if kind == "sgd":
            delta = sums[valid] * (-rest[0])
            library_ms = device_ms(
                lambda: arrays[0].index_add_(0, rows, delta), reps=10)
            totals["library_ms"] += library_ms
            # a second yardstick: a plain copy of the same random rows
            # (read each once, write each once), what a row's 512 bytes
            # reach where the bound counts them at the peak rate
            copy_ms = device_ms(lambda: arrays[0].index_copy_(
                0, rows, arrays[0].index_select(0, rows)), reps=10)
            totals["copy_ms"] = totals.get("copy_ms", 0.0) + copy_ms
        bytes_ms, ops_ms = sparse_bound(kind, rep, width, u, rate)
        emit(phase=f"{kind}_rows_kernel", path=path, bucket=b,
             table=[vocab, width],
             slots=int(rep.numel()), unique_rows=u, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, copy_ms=copy_ms,
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
CATEGORIES = (("lookup", ("lookup_combine", "one_hot_kernel")),
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
# (the `obs.span` paths of `fit` and `InferenceEngine.predict` among them)
ANNOTATED_RANGES = (SELECT_RANGE, "exchange:", "gloo:", "nccl:",
                    "quantized:", "train/", "serve/")


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
        # 1-2 s a call: timed once, warmed by the call held above
        plain_ms = eager_ms(lambda: plain(*got, *rest), reps=1, warmup=0)
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


def seed_tables(torch, layer, seed):
    """Every table this rank holds (`table_rows`, by its index in the
    model) written where its plan puts it: a dp table whole, a tp
    placement's columns into its bucket rows, a row-sliced table's rows
    of this rank into its shard (the shard's padding rows zero)."""
    strat = layer.strategy
    with torch.no_grad():
        for j, gtid in enumerate(strat.table_groups[0]):
            layer.dp[j].copy_(table_rows(torch, strat, gtid, seed,
                                         layer.device))
        for pl_ in layer.plan.tp_placements:
            if pl_.rank != layer.rank:
                continue
            rows = table_rows(torch, strat,
                              strat.table_groups[1][pl_.table_id], seed,
                              layer.device)
            layer.tp[pl_.bucket][pl_.row_offset:pl_.row_offset
                                 + pl_.rows].copy_(
                rows[:, pl_.col_start:pl_.col_end])
        for t, gtid in enumerate(strat.table_groups[2]):
            rt = layer.plan.row_tables[t]
            lo, n = int(rt.row_base[layer.rank]), rt.rows_per_rank[layer.rank]
            layer.row[t][:n].copy_(table_rows(torch, strat, gtid, seed,
                                              layer.device)[lo:lo + n])
            layer.row[t][n:].zero_()


def seed_weights(torch, model, seed):
    """The same weights at every world size, no weight file written: the
    tables by `seed_tables`; MLP parameter i from seed + 10,000 + i,
    glorot-normal kernels and N(0, 1/out) biases like `Dense`."""
    seed_tables(torch, model.embedding, seed)
    with torch.no_grad():
        dense = mlp_params(model).values()
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
            err, *_ = hold(torch, f"{label}: {n}", ranks[0]["mlp"][n],
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
                err, change, n, _ = hold(
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


# ---- phase 10: the placement groups at world size > 1 (ninth slice):
# DLRM with data-parallel, column-sliced table-parallel and row-sliced
# tables on 2 ranks, against the world-1 trainer and engine
PLACEMENT_SCALE = 0.2         # Criteo sizes x 0.2: 19.2 GB of tables
PLACEMENT_WORLD = 2
PLACEMENT_KW = dict(data_parallel_threshold=262_144,
                    column_slice_threshold=67_108_864,
                    row_slice_threshold=536_870_912)
# dp tables, tp tables, tp placements, tp buckets, row tables
PLACEMENT_PLAN = dict(dp=13, tp=8, placements=9, buckets=2, row=5)
PLACEMENT_SEED = 13
PLACEMENT_REQUESTS = (65536, 4097)
PLACEMENT_LATENCY_REPS = 5


def placement_model(torch, device, seed, scale=PLACEMENT_SCALE,
                    kw=PLACEMENT_KW, compute_dtype=None):
    """The phase's DLRM on `device`: the example's widths, Criteo sizes x
    `scale`, the three thresholds `kw`, one-hot gathers through
    lookup_combine, at `compute_dtype`; tables then drawn by
    `seed_weights` alike at every world size."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        DLRM, scaled_table_sizes)
    model = DLRM(scaled_table_sizes(scale), device=device,
                 lookup_path="pallas", compute_dtype=compute_dtype,
                 generator=torch.Generator(device=device).manual_seed(seed),
                 **kw)
    seed_weights(torch, model, PLACEMENT_SEED)
    return model


def placement_batches(model, steps):
    """The phase's global batches (a seeded ClickGenerator stream)."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    gen = ClickGenerator(model.table_sizes, 13, BATCH, seed=PLACEMENT_SEED)
    return [gen.batch(s) for s in range(steps)]


def placement_request(model, rows):
    """A serving request of `rows` rows, the same on every rank."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    num, cats, _ = ClickGenerator(model.table_sizes, 13, rows,
                                  seed=PLACEMENT_SEED + 1).batch(0)
    return num, cats


def placed_rows(torch, layer, touched):
    """The rows a rank's update kernels touched (`run_trainer`'s capture),
    where they live: per tp placement of the rank and per row shard, a
    key ("tp" or "row", table index, placement or row table index) ->
    (the local table, its touched rows (sorted, unique, on the CPU), the
    offset that makes them rows of the whole table, its columns)."""
    strat = layer.strategy
    out = {}

    def rows_of(table):
        parts = touched.get(table.data_ptr(), [])
        return (torch.unique(torch.cat(parts)) if parts
                else torch.zeros(0, dtype=torch.long))
    for i, pl_ in enumerate(layer.plan.tp_placements):
        if pl_.rank != layer.rank:
            continue
        table = layer.tp[pl_.bucket]
        idx = rows_of(table)
        idx = idx[(idx >= pl_.row_offset)
                  & (idx < pl_.row_offset + pl_.rows)]
        out[("tp", strat.table_groups[1][pl_.table_id], i)] = (
            table, idx, -pl_.row_offset, (pl_.col_start, pl_.col_end))
    for t, gtid in enumerate(strat.table_groups[2]):
        rt = layer.plan.row_tables[t]
        out[("row", gtid, t)] = (layer.row[t], rows_of(layer.row[t]),
                                 int(rt.row_base[layer.rank]),
                                 (0, rt.width))
    return out


def placement_profile(torch, step_once, rank, groups, row_tables):
    """One step of a placement rank under torch.profiler: the exchange's
    ranges by collective (`ops.wire`: ``exchange:all_to_all`` 3 a tp
    group, ``exchange:all_gather`` 2 and ``exchange:reduce_scatter`` 1 a
    row table; the dense ``exchange:all_reduce`` 1, or the rank fails),
    gloo's or NCCL's own events, device time by kernel and category, the
    collectives' pinned copies, and the device intervals on the Unix
    clock (`card_profile` merges the ranks'). Returns {"window_us",
    "device_intervals_us", "profile"}."""
    from torch.autograd import DeviceType
    from distributed_embeddings_tpu_torch.ops import wire
    from distributed_embeddings_tpu_torch.parallel.mesh import (
        ALL_REDUCE_RANGE)
    busy_us, wall_us, device, prof, window = profile_call(torch, step_once)
    by_kernel = _by_name(device)
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ranges = {name: [e for e in host if e.name == name]
              for name in (wire.EXCHANGE_RANGE, wire.GATHER_RANGE,
                           wire.SCATTER_RANGE, ALL_REDUCE_RANGE)}
    # per tp group the ids, the activations and their gradients; per
    # row table the ids, and the gradients of the reduce-scatter; one
    # all-reduce of the dense gradients and the loss
    want = {wire.EXCHANGE_RANGE: 3 * groups,
            wire.GATHER_RANGE: 2 * row_tables,
            wire.SCATTER_RANGE: row_tables,
            ALL_REDUCE_RANGE: 1}
    got = {k: len(v) for k, v in ranges.items()}
    check(got == want, f"rank {rank}: exchange collectives {got} in a "
                       f"step, want {want}")
    collectives: dict = {}
    for e in host:
        if e.name.startswith(("gloo:", "nccl:")):
            ms, n = collectives.get(e.name, (0.0, 0))
            collectives[e.name] = (ms + e.cpu_time_total / 1e3, n + 1)
    cats_ms, _ = by_category(by_kernel)
    origin = prof.profiler.kineto_results.trace_start_ns() / 1e3
    return {"window_us": window,
            "device_intervals_us": [
                (origin + e.time_range.start, origin + e.time_range.end)
                for e in device],
            "profile": dict(
                wall_ms=wall_us / 1e3, rank_device_busy_ms=busy_us / 1e3,
                rank_device_busy_share=busy_us / wall_us,
                device_ms_by_category=cats_ms,
                collective_copies_ms=sum(
                    us for n, us in by_kernel.items()
                    if n.startswith("Memcpy") and "Pinned" in n) / 1e3,
                device_ms_by_kernel=[[n[:80], us / 1e3] for n, us in sorted(
                    by_kernel.items(), key=lambda kv: -kv[1])[:12]],
                exchange_calls=got,
                exchange_host_ms={k: sum(e.cpu_time_total for e in v) / 1e3
                                  for k, v in ranges.items()},
                collective_host_ms={k: {"ms": ms, "calls": n}
                                    for k, (ms, n) in collectives.items()})}


@contextlib.contextmanager
def wire_payloads(torch):
    """Within the block, what the wire's collectives and the dense
    all-reduce hand `torch.distributed` (`ops.wire` and
    `parallel.mesh` call them through it): per collective its calls, the
    bytes of its inputs and their dtypes."""
    import torch.distributed as dist
    names = ("all_to_all_single", "all_gather_into_tensor",
             "reduce_scatter_tensor", "all_reduce")
    real = {n: getattr(dist, n) for n in names}
    seen = {n: {"calls": 0, "bytes": 0, "dtypes": []} for n in names}

    def recording(name):
        def call(*args, **kwargs):
            x = args[0] if name == "all_reduce" else args[1]
            s = seen[name]
            s["calls"] += 1
            s["bytes"] += x.numel() * x.element_size()
            dtype = str(x.dtype).replace("torch.", "")
            if dtype not in s["dtypes"]:
                s["dtypes"].append(dtype)
            return real[name](*args, **kwargs)
        return call
    for n in names:
        setattr(dist, n, recording(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(dist, n, real[n])


def placement_rank(rank, world, backend, init_method, out_dir):
    """One rank of phase 10 (torch.multiprocessing, spawn): the placement
    DLRM built and drawn by `seed_weights`, its plan; the forward of its
    slice of batch 0 (embedding outputs and logits saved); the same
    tables in a layer built with ``dp_input=False`` fed this rank's
    features at global batch size, bit-equal to the dp-input forward; 3
    held sgd steps at the example's schedule (launches counted, each
    step's ReLU masks and MLP before it saved, the touched rows of its tp
    placements and row shards, its dp tables and its MLP after); the
    engine on the trained model (`PLACEMENT_REQUESTS`, logits and
    latency); one more step whose kernel calls on the first row shard
    rank 0 holds and times; then 10 timed steps after 2 warm ones, one
    profiled step and the peak memory. Results go to ``out_dir``."""
    import numpy as np
    import torch
    check("jax" not in sys.modules, f"rank {rank} imported jax")
    import torch.distributed as dist
    from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
        DistributedEmbedding)
    from distributed_embeddings_tpu_torch.layers.embedding import Embedding
    from distributed_embeddings_tpu_torch.models.dlrm import make_lr_schedule
    from distributed_embeddings_tpu_torch.ops import (cuda_lookup, cuda_sparse,
                                                      cuda_tiled)
    from distributed_embeddings_tpu_torch.parallel.mesh import (
        initialize_distributed)
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager, stage_dp_batch)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.tools import cuda_feature_probe
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (world + 1)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    initialize_distributed(backend, init_method, world, rank)
    try:
        out = {"rank": rank, "device": str(dev)}
        t0 = time.perf_counter()
        model = placement_model(torch, dev, rank)
        layer = model.embedding
        groups = layer.strategy.table_groups
        out["plan"] = dict(dp=len(groups[0]), tp=len(groups[1]),
                           placements=len(layer.plan.tp_placements),
                           buckets=len(layer.plan.tp_buckets),
                           row=len(groups[2]))
        out["table_bytes"] = sum(t.numel() * 4 for t in list(layer.dp)
                                 + list(layer.tp) + list(layer.row))
        global_batches = placement_batches(model, TRAIN_STEPS)
        stager = DeviceStager(dev)
        batches = [stage_dp_batch(b, stager) for b in global_batches]
        out["setup_s"] = time.perf_counter() - t0
        num0, cats0, _ = batches[0]
        with torch.no_grad():
            emb = layer(cats0)
            logits = model(num0, cats0)
        torch.save({"emb": torch.cat(emb, dim=1).cpu(),
                    "logits": logits.cpu()},
                   os.path.join(out_dir, f"forward{rank}.pt"))

        # model-parallel input: the same tables, this rank's features
        mp = DistributedEmbedding(
            [Embedding(v, model.embedding_dim, device="meta")
             for v in model.table_sizes], strategy="memory_balanced",
            dp_input=False, input_max_hotness=[1] * len(model.table_sizes),
            device=dev, lookup_path="pallas", **PLACEMENT_KW)
        seed_tables(torch, mp, PLACEMENT_SEED)
        strat = mp.strategy
        own = [global_batches[0][1][strat.input_groups[1][pos]]
               for pos in strat.input_ids_list[rank]]
        with torch.no_grad():
            mp_out = mp(own)
        out["mp"] = dict(
            features=len(own), tables=len(strat.table_groups[1]),
            bit_identical=all(torch.equal(a, b) for a, b in zip(mp_out,
                                                                emb)),
            max_abs_err=max((a - b).abs().max().item()
                            for a, b in zip(mp_out, emb)))
        check(out["mp"]["bit_identical"],
              f"rank {rank}: the dp_input=False forward disagrees with the "
              f"dp-input one by {out['mp']['max_abs_err']}")
        del mp, mp_out, emb, logits
        torch.cuda.empty_cache()

        # the main path: 3 sgd steps at the example's schedule
        init, step = make_sparse_train_step(model, "sgd",
                                            lr=make_lr_schedule(*DLRM_LR))
        state = init(model)
        counted = (cuda_sparse, cuda_tiled, cuda_feature_probe)
        set_counts(cuda_lookup, *counted)
        losses, touched, mlp_before, masks = [], {}, [], []
        for batch in batches:
            mlp_before.append({n: p.detach().cpu().clone()
                               for n, p in mlp_params(model).items()})
            (state, loss, step_rows, _), m = relu_masks(
                model, lambda: run_trainer(step, model, state, [batch],
                                           rows_capture(cuda_sparse, "sgd")))
            masks.append([(tuple(x.shape), np.packbits(x.numpy(), axis=1))
                          for x in m])
            losses += loss
            for ptr, parts in step_rows.items():
                touched.setdefault(ptr, []).extend(parts)
        torch.cuda.synchronize()
        out["launches"] = read_counts(cuda_lookup, *counted)
        out["losses"] = losses
        key = tuple((1, False) for _ in layer.strategy.input_groups[1])
        tp_groups, _ = layer._exchange_groups_for_key(key)
        out["groups"] = len(tp_groups)
        out["tp_buckets_updated"] = len({g.bucket for g in tp_groups})
        out["row_tables"] = len(layer.row)
        out["tables"] = {
            where: (idx, table.detach().index_select(0, idx.to(dev)).cpu(),
                    offset, cols)
            for where, (table, idx, offset, cols)
            in placed_rows(torch, layer, touched).items()}
        out["dp_tables"] = {gtid: layer.dp[j].detach().cpu().clone()
                            for j, gtid in enumerate(groups[0])}
        out["mlp"] = {n: p.detach().cpu().clone()
                      for n, p in mlp_params(model).items()}
        torch.save({"masks": masks, "mlp_before": mlp_before},
                   os.path.join(out_dir, f"steps{rank}.pt"))
        del masks

        # the engine on the trained model: every rank the same request
        engine = InferenceEngine(model, device=dev)
        served = {}
        for rows in PLACEMENT_REQUESTS:
            req = placement_request(model, rows)
            logits = engine.predict(req)
            torch.cuda.synchronize()
            times = []
            for _ in range(PLACEMENT_LATENCY_REPS):
                t1 = time.perf_counter()
                engine.predict(req)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
            served[rows] = dict(logits=logits.cpu(),
                                median_ms=statistics.median(times) * 1e3,
                                padded_to=engine._target_batch(rows))
        out["served"] = served
        del engine

        # the kernels at a row shard's shapes: one more step's calls, and
        # the bytes its collectives move
        shard = layer.row[0].data_ptr()
        with Capture(cuda_lookup, "lookup_combine") as look, \
                Capture(cuda_sparse, "segment_sum_sorted") as seg, \
                Capture(cuda_sparse, "sgd_rows") as rows_c, \
                wire_payloads(torch) as payloads:
            _, state, _ = step(model, state, *batches[0])
        torch.cuda.synchronize()
        out["wire"] = payloads
        if rank == 0:
            rate = hbm_rate(torch.cuda.get_device_name(dev))
            look_calls = [a for a in lookup_args(look.calls)
                          if a[0].data_ptr() == shard]
            row_calls = [a for a in rows_c.calls if a[0].data_ptr() == shard]
            # segment sums run bucket by bucket, then row table by table
            seg_calls = seg.calls[out["tp_buckets_updated"]:][:1]
            check(len(look_calls) == len(row_calls) == len(seg_calls) == 1,
                  f"rank 0: {len(look_calls)} lookups, {len(seg_calls)} "
                  f"segment sums, {len(row_calls)} sgd_rows calls on row "
                  "shard 0, want 1 each")
            look_err, look_tot = tiny_bucket_kernels(
                torch, cuda_lookup, look_calls, rate,
                phase="placement_kernel")
            out["kernels"] = {
                "lookup_combine": (look_tot, look_err),
                "segment_sum_sorted": time_segment_calls(
                    torch, cuda_sparse, seg_calls, rate, path="placement"),
                "sgd_rows": time_row_calls(torch, cuda_sparse, "sgd",
                                           row_calls, rate,
                                           path="placement")}
            sgd_rows_sweep(torch, cuda_sparse, row_calls[0], "placement")
        del look, seg, rows_c
        dist.barrier()

        # step time, a profiled step, peak memory
        times = []
        for i in range(2 + WORLD_TIMED_STEPS):
            num, cats, labels = batches[i % TRAIN_STEPS]
            t1 = time.perf_counter()
            _, state, loss = step(model, state, num, cats, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        out["step_ms"] = [t * 1e3 for t in times[2:]]
        holder = {"state": state}
        del state

        def step_once():
            holder["state"] = step(model, holder["state"], *batches[0])[1]
        out.update(placement_profile(torch, step_once, rank, out["groups"],
                                     out["row_tables"]))
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        check("jax" not in sys.modules, f"rank {rank} imported jax")
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def unpack_masks(torch, packed):
    import numpy as np
    return [torch.from_numpy(np.unpackbits(bits, axis=1,
                                           count=shape[1]).astype(bool))
            for shape, bits in packed]


def placement_phase(torch, cuda_lookup, cuda_sparse, counted,
                    serve_latency):
    """Phase 10: `placement_rank` on PLACEMENT_WORLD ranks (on the card(s)
    as phase 8 places them), then the world-1 model in this process (every
    table table-parallel: the thresholds are ignored at world 1) with the
    same per-table weights and batches, each rank held against it: the
    plan (PLACEMENT_PLAN), the embedding outputs and the logits of each
    rank's slice bit-equal to world 1's on the same rows (the ids are
    one-hot: a row-sliced output is one shard's row plus zeros, column
    slices concatenate), the dp_input=False forward (each rank's own
    check), 3 sgd steps (each world-1 step from rank 0's MLP before it,
    with the ranks' ReLU masks forced): losses at rtol 1e-5, the touched
    rows of every tp placement and row shard by change (`hold`, the row
    sums' conditioning from world 1's contributions), the dp tables and
    the MLPs by value (and equal on every rank), the launches the plan
    predicts; then world 1 takes the ranks' trained rows, dp tables and
    MLP, and its engine, on each rank's block of each request, gives
    every rank's logits bit for bit. Returns the launch counts of the
    ranks' held steps, summed, rank 0's kernel timings, and each rank's
    step median, exchange host ms and one step's bytes by collective
    (`wire_payloads`; phase 11e sets its bfloat16 step beside them)."""
    from distributed_embeddings_tpu_torch.models.dlrm import make_lr_schedule
    from distributed_embeddings_tpu_torch.ops import sparse_update
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    world = PLACEMENT_WORLD
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    label = f"world{world}_placement"
    emit(phase="placement_setup", path=label, world=world, backend=backend,
         device_count=cards, table_scale=PLACEMENT_SCALE, **PLACEMENT_KW,
         **({} if backend == "nccl" else
            {"nccl": f"not run: {cards} card" + ("s" if cards > 1 else "")}))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_placement")
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(torch, placement_rank, world, backend, tmp, label)
        ranks_s = time.perf_counter() - t0
        for r in ranks:
            check(r["plan"] == PLACEMENT_PLAN,
                  f"{label}: rank {r['rank']} plans {r['plan']}, want "
                  f"{PLACEMENT_PLAN}")
        emit(phase="placement_plan", path=label, **ranks[0]["plan"],
             mp_input=[r["mp"] for r in ranks])

        # the world-1 model: the same per-table weights and batches
        t0 = time.perf_counter()
        model = placement_model(torch, "cuda", 0)
        layer = model.embedding
        check(len(layer.tp) == 1 and not layer.dp and not layer.row,
              f"{label}: world 1 plans {len(layer.dp)} dp tables, "
              f"{len(layer.tp)} buckets, {len(layer.row)} row tables")
        batches = placement_batches(model, TRAIN_STEPS)
        b_l = BATCH // world
        identical, fwd_err = True, 0.0
        for r in range(world):
            got = torch.load(os.path.join(tmp, f"forward{r}.pt"))
            num, cats, _ = batches[0]
            blk = slice(r * b_l, (r + 1) * b_l)
            with torch.no_grad():
                emb = torch.cat(layer([c[blk] for c in cats]), dim=1).cpu()
                logits = model(num[blk], [c[blk] for c in cats]).cpu()
            for what, a, b in (("embedding outputs", got["emb"], emb),
                               ("logits", got["logits"], logits)):
                check(a.shape == b.shape, f"{label}: rank {r} {what} "
                      f"{tuple(a.shape)}, want {tuple(b.shape)}")
                fwd_err = max(fwd_err, (a - b).abs().max().item())
                identical = identical and torch.equal(a, b)
        emit(phase="placement_forward", path=label, bit_identical=identical,
             max_abs_err=fwd_err)
        check(identical, f"{label}: the ranks' forwards differ from world "
                         f"1's by {fwd_err}")

        # 3 sgd steps, each from rank 0's MLP before it, the ranks' ReLU
        # masks forced
        init, step = make_sparse_train_step(model, "sgd",
                                            lr=make_lr_schedule(*DLRM_LR))
        state = init(model)
        steps = [torch.load(os.path.join(tmp, f"steps{r}.pt"),
                            weights_only=False) for r in range(world)]
        mlp = mlp_params(model)
        bucket = layer.tp[0]
        cond = torch.zeros(bucket.shape[0], dtype=torch.float64)
        losses, touched, flips = [], {}, []
        for s, batch in enumerate(batches):
            with torch.no_grad():
                for n, p in mlp.items():
                    p.copy_(steps[0]["mlp_before"][s][n])
            masks = [torch.cat(parts).cuda() for parts in zip(
                *(unpack_masks(torch, st["masks"][s]) for st in steps))]
            with forced_relu(torch, model, masks) as flipped, \
                    Capture(sparse_update, "dedup_sum") as sums:
                state, loss, step_rows, _ = run_trainer(
                    step, model, state, [batch],
                    rows_capture(cuda_sparse, "sgd"))
            flips.append(flipped[-1])
            losses += loss
            for ptr, parts in step_rows.items():
                touched.setdefault(ptr, []).extend(parts)
            rows_s = touched_rows(torch, model, step_rows)
            c = contribution_cond(torch, model, zip(sums.calls, sums.kwargs),
                                  rows_s)[0]
            cond[rows_s[0]] = torch.maximum(cond[rows_s[0]], c[:, 0])
            del sums, masks
        torch.cuda.synchronize()
        rows1 = touched_rows(torch, model, touched)[0]
        mlp_last = steps[0]["mlp_before"][-1]
        del steps

        # launches a rank step, from its plan: a lookup per tp group and
        # per row table, a segment sum and an sgd_rows per updated tp
        # bucket and per row shard
        summed = dict.fromkeys(ALL_KERNELS, 0)
        for r in ranks:
            want_r = {"lookup_combine": r["groups"] + r["row_tables"],
                      "segment_sum_sorted": (r["tp_buckets_updated"]
                                             + r["row_tables"]),
                      "sgd_rows": r["tp_buckets_updated"] + r["row_tables"]}
            check(r["launches"] == per_step(want_r, TRAIN_STEPS),
                  f"{label}: rank {r['rank']} launches {r['launches']}, "
                  f"want {want_r} per step")
            for k, v in r["launches"].items():
                summed[k] += v
            check(torch.allclose(torch.tensor(r["losses"]),
                                 torch.tensor(losses), **LOSS_TOL),
                  f"{label}: rank {r['rank']} losses {r['losses']}, world "
                  f"1 {losses}")
            for n, p in r["mlp"].items():
                check(torch.equal(p, ranks[0]["mlp"][n]),
                      f"{label}: rank {r['rank']}'s {n} differs from rank "
                      "0's")
            for gtid, t in r["dp_tables"].items():
                check(torch.equal(t, ranks[0]["dp_tables"][gtid]),
                      f"{label}: rank {r['rank']}'s dp table {gtid} differs "
                      "from rank 0's")
        strat = layer.strategy
        place1 = {strat.table_groups[1][p.table_id]: p
                  for p in layer.plan.tp_placements}
        worst = 0.0
        for n, p in mlp.items():
            err, *_ = hold(torch, f"{label}: {n}", ranks[0]["mlp"][n],
                             p.detach().cpu(), mlp_last[n], 1, "value")
            worst = max(worst, err)
        for gtid, t in ranks[0]["dp_tables"].items():
            p1 = place1[gtid]
            want = bucket.detach()[p1.row_offset:p1.row_offset
                                   + p1.rows].cpu()
            before = table_rows(torch, strat, gtid, PLACEMENT_SEED,
                                "cuda").cpu()
            err, *_ = hold(torch, f"{label}: dp table {gtid}", t, want,
                             before, TRAIN_STEPS, "value")
            worst = max(worst, err)
        held_rows, changes, moved, held = 0, [], 0, {}
        for r in ranks:
            for where, (idx, vals, offset, (c0, c1)) in r["tables"].items():
                gtid = where[1]
                p1 = place1[gtid]
                rows = idx + offset
                at1 = rows + p1.row_offset
                held.setdefault(gtid, []).append(rows)
                if where[0] == "tp":
                    # a column slice's rank saw every id of its table
                    one = rows1[(rows1 >= p1.row_offset)
                                & (rows1 < p1.row_offset + p1.rows)]
                    check(bool(torch.isin(one - p1.row_offset, rows).all()),
                          f"{label}: table {gtid}: world 1 touched rows rank "
                          f"{r['rank']} did not")
                want = bucket.detach().index_select(0, at1.cuda())[
                    :, c0:c1].cpu()
                before = table_rows(torch, strat, gtid, PLACEMENT_SEED,
                                    "cuda").index_select(
                    0, rows.cuda())[:, c0:c1].cpu()
                err, change, n, _ = hold(
                    torch, f"{label}: table {gtid} ({where[0]}, rank "
                    f"{r['rank']})", vals, want, before, TRAIN_STEPS,
                    "change", cond[at1][:, None])
                worst = max(worst, err)
                changes.append(change.flatten())
                moved += n
                held_rows += int(idx.numel())
        # every world-1 touched row of a tp or row-sliced table is held
        for gtid in strat.table_groups[1]:
            if gtid in ranks[0]["dp_tables"]:
                continue
            p1 = place1[gtid]
            one = rows1[(rows1 >= p1.row_offset)
                        & (rows1 < p1.row_offset + p1.rows)] - p1.row_offset
            check(gtid in held and bool(torch.isin(
                one, torch.cat(held[gtid])).all()),
                f"{label}: table {gtid}: world 1 touched rows no rank held")
        change = torch.cat(changes)
        emit(phase="main_path", path=label, backend=backend, world=world,
             steps=TRAIN_STEPS, ranks_seconds=ranks_s,
             world1_seconds=time.perf_counter() - t0,
             launches_by_rank=[r["launches"] for r in ranks],
             losses=ranks[0]["losses"], world1_losses=losses,
             max_abs_err=worst, touched_rows_held=held_rows,
             table_change_median=change.median().item(),
             table_change_max=change.max().item(),
             table_changes_past_rounding=moved, relu_flips=flips, ok=True)

        # serving: world 1 takes the ranks' trained rows, dp tables and
        # MLP (the rows world 1 touched are among them), then serves each
        # rank's block of each request at the block's shape
        with torch.no_grad():
            for r in ranks:
                for where, (idx, vals, offset, (c0, c1)) in \
                        r["tables"].items():
                    p1 = place1[where[1]]
                    at1 = (idx + offset + p1.row_offset).cuda()
                    bucket[at1, c0:c1] = vals.cuda()
            for gtid, t in ranks[0]["dp_tables"].items():
                p1 = place1[gtid]
                bucket[p1.row_offset:p1.row_offset + p1.rows] = t.cuda()
            for n, p in mlp.items():
                p.copy_(ranks[0]["mlp"][n])
        engine = InferenceEngine(model, device="cuda")
        engine.warmup(sorted({ranks[0]["served"][rows]["padded_to"] // world
                              for rows in PLACEMENT_REQUESTS}))
        for rows in PLACEMENT_REQUESTS:
            num, cats = placement_request(model, rows)
            blk = ranks[0]["served"][rows]["padded_to"] // world
            want = torch.cat([engine.predict(
                (num[lo:lo + blk], [c[lo:lo + blk] for c in cats]))
                for lo in range(0, rows, blk)]).cpu()
            same = [torch.equal(r["served"][rows]["logits"], want)
                    for r in ranks]
            err = max((r["served"][rows]["logits"] - want).abs().max().item()
                      for r in ranks)
            emit(phase="placement_serving", path=label, rows=rows,
                 padded_to=ranks[0]["served"][rows]["padded_to"],
                 bit_identical=all(same), max_abs_err=err,
                 median_ms_by_rank=[r["served"][rows]["median_ms"]
                                    for r in ranks],
                 world1_phase4_median_ms=serve_latency)
            check(all(same), f"{label}: a {rows}-row request's logits differ "
                             f"from world 1's by {err}")
        del model, layer, state, engine, bucket
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
            emit(phase="world_card_profile", path=label, backend=backend,
                 **card_profile(ranks))
        for r in ranks:
            emit(phase="placement_wire", path=label, rank=r["rank"],
                 step=r["wire"])
        exchange = dict(
            step_ms=[statistics.median(r["step_ms"]) for r in ranks],
            wire=[r["wire"] for r in ranks],
            exchange_host_ms=[r["profile"]["exchange_host_ms"]
                              for r in ranks])
        return summed, ranks[0]["kernels"], exchange
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


def table_digest(torch, t, device=None):
    """An exact fingerprint of a float32 table: the wrapping int64 sum of
    its bit patterns times odd weights that differ by position (row
    chunks of 2^24 elements); any one element's change moves it. With
    `device`, each chunk of a host table is reduced there."""
    rows, width = t.shape
    dev = t.device if device is None else device
    chunk = max(1, (1 << 24) // width)
    col = torch.arange(width, device=dev, dtype=torch.int64) * 2 + 1
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        bits = t[r0:r1].detach().to(dev).view(torch.int32).to(torch.int64)
        weight = (torch.arange(r0, r1, device=dev,
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
    `profiled` to the end of the next. The profiler starts one step
    earlier, at the end of step ``profiled - 1``, and that step warms it
    (a trace's first kernels after its start can go missing); two host
    ranges (`WINDOW_MARKS`) mark the window, and only what lies between
    them is read: the card's busy time and idle share over the window,
    its host-to-device copies (`profile`), the device ms of named host
    ranges (`range_ms`). The steps that ran under the profiler
    (`traced`) are left out of `step_ms`."""
    WINDOW_MARKS = ("smoke:window_start", "smoke:window_end")

    def __init__(self, torch, profiled):
        self.torch, self.profiled = torch, profiled
        self.ends, self.prof = [], None
        self.traced = {profiled, profiled + 1}

    def on_step(self, step, model, loss):
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)
        self.torch.cuda.synchronize()
        if step == self.profiled - 1:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        elif step == self.profiled:
            with record_function(self.WINDOW_MARKS[0]):
                pass
        elif step == self.profiled + 1:
            with record_function(self.WINDOW_MARKS[1]):
                pass
            self.prof.stop()
        self.ends.append(time.perf_counter())

    def _window(self):
        from torch.autograd import DeviceType
        marks = {e.name: e.time_range for e in self.prof.events()
                 if e.device_type == DeviceType.CPU
                 and e.name in self.WINDOW_MARKS}
        return (marks[self.WINDOW_MARKS[0]].start,
                marks[self.WINDOW_MARKS[1]].start)

    def _device(self):
        """The window and the device events inside it (without the device
        side of the host's annotated ranges)."""
        from torch.autograd import DeviceType
        w0, w1 = self._window()
        return w0, w1, [e for e in self.prof.events()
                        if e.device_type == DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False)
                        and not e.name.startswith(ANNOTATED_RANGES)
                        and w0 <= e.time_range.start
                        and e.time_range.end <= w1]

    def unix_intervals(self):
        """The window (start, end) and its device intervals in µs of the
        Unix clock, the clock of the profiler's trace (`card_profile`)."""
        w0, w1, device = self._device()
        base = self.prof.profiler.kineto_results.trace_start_ns() / 1e3
        return (base + w0, base + w1), [
            (base + e.time_range.start, base + e.time_range.end)
            for e in device]

    def profile(self):
        w0, w1, device = self._device()
        wall = w1 - w0
        busy = busy_union((e.time_range.start, e.time_range.end)
                          for e in device)
        by_kernel = _by_name(device)
        cats, _ = by_category(by_kernel)
        return dict(wall_ms=wall / 1e3, device_busy_ms=busy / 1e3,
                    device_idle_share=1 - busy / wall if device else None,
                    htod=htod_copies(device), device_ms_by_category=cats,
                    device_ms_by_kernel=[[n[:80], us / 1e3] for n, us in sorted(
                        by_kernel.items(), key=lambda kv: -kv[1])[:10]])

    def range_ms(self, name) -> dict:
        """Device ms, host ms and calls of the window's host ranges called
        `name` (the device time of the kernels launched inside them; the
        host clock across them)."""
        from torch.autograd import DeviceType
        w0, w1 = self._window()
        ms, host_ms, calls = 0.0, 0.0, 0
        for e in self.prof.events():
            if e.device_type == DeviceType.CPU and e.name == name \
                    and w0 <= e.time_range.start <= w1:
                ms += e.device_time_total / 1e3
                host_ms += e.time_range.elapsed_us() / 1e3
                calls += 1
        return {"device_ms": ms, "host_ms": host_ms, "calls": calls}

    def step_ms(self, skip=()):
        """Each step's time (end to end), but the first two, the traced
        ones and `skip`."""
        skip = set(skip) | self.traced
        return [(b - a) * 1e3 for i, (a, b) in enumerate(
            zip(self.ends, self.ends[1:]), start=1)
            if i >= 2 and i not in skip]


def warm_window(torch, step_once) -> StepWindow:
    """`step_once()` three times under a `StepWindow` whose window is the
    third call: the first call's end starts the profiler, the second
    warms it."""
    window = StepWindow(torch, 1)
    for i in range(3):
        step_once()
        window.on_step(i, None, None)
    return window


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
    captured = lookup_args(look.calls)
    look_err, look_tot = tiny_bucket_kernels(torch, cuda_lookup, captured,
                                             rate, phase="dlrm_kernel")
    out = {"lookup_combine": (look_tot, look_err),
           "segment_sum_sorted": time_segment_calls(
               torch, cuda_sparse, seg.calls, rate, path="dlrm_fit"),
           "sgd_rows": time_row_calls(torch, cuda_sparse, "sgd", rows.calls,
                                      rate, path="dlrm_fit")}
    sgd_rows_sweep(torch, cuda_sparse, rows.calls[0], "dlrm_fit")
    emit(phase="dlrm_kernels", hbm_bytes_per_s=rate,
         **{k: dict(tot, max_abs_err=err) for k, (tot, err) in out.items()})
    return out


def dlrm_dataset(tmp, sizes, train_batches=DLRM_FIT_STEPS):
    """Write DLRM's seeded ClickGenerator stream (`train_batches` train
    batches, DLRM_EVAL_STEPS test batches) in the split-binary layout
    under `tmp`; returns ``(valid, native=True) -> RawBinaryDataset`` of
    it (read through the native prefetcher, or with ``os.pread``)."""
    from distributed_embeddings_tpu_torch.models.data import (
        RawBinaryDataset)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    t0 = time.perf_counter()
    gen = ClickGenerator(sizes, 13, BATCH, seed=DLRM_SEED)
    write_split_binary(tmp, "train",
                       [gen.batch(s) for s in range(train_batches)], sizes)
    write_split_binary(tmp, "test", [gen.batch(1_000_000 + j)
                                     for j in range(DLRM_EVAL_STEPS)], sizes)
    del gen
    emit(phase="dlrm_data", seconds=time.perf_counter() - t0,
         tables=len(sizes), rows=sum(sizes), batch=BATCH,
         train_batches=train_batches, test_batches=DLRM_EVAL_STEPS,
         bytes=sum(os.path.getsize(os.path.join(tmp, d, f))
                   for d in ("train", "test")
                   for f in os.listdir(os.path.join(tmp, d))))

    def dataset(valid, native=True):
        return RawBinaryDataset(
            tmp, batch_size=BATCH, numerical_features=13,
            categorical_features=range(len(sizes)),
            categorical_feature_sizes=sizes, valid=valid,
            use_native_prefetch=native)
    return dataset


# the split-binary datasets written so far in this run: (sizes, train
# batches) -> (directory, dataset), each removed when the script exits
_DATASETS: dict = {}


def shared_dataset(sizes, train_batches=DLRM_FIT_STEPS):
    """`dlrm_dataset` at `sizes` with `train_batches` train batches,
    written once a run in a directory of its own and read again by every
    phase that trains at those sizes (9 and 11c at x 0.4, 12b and 14b at
    the full sizes: the same seeded stream)."""
    key = (tuple(sizes), train_batches)
    if key in _DATASETS:
        emit(phase="dlrm_data", reused=True, rows=sum(sizes),
             train_batches=train_batches)
    else:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_data")
        atexit.register(shutil.rmtree, tmp, True)
        _DATASETS[key] = (tmp, dlrm_dataset(tmp, sizes, train_batches))
    return _DATASETS[key][1]


def dlrm_card_auc(torch, model, test):
    """The on-card AUC of `model`'s logits over the DLRM_EVAL_STEPS test
    batches against the exact AUC and a CPU StreamingAUC of the same
    logits (and the card's histograms against its own probabilities
    binned on the host). Returns the card's AUC."""
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager)
    from distributed_embeddings_tpu_torch.utils.metrics import (
        StreamingAUC, auc_exact)
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
    cpu_state = cpu_metric.update(cpu_metric.init("cpu"), labels, logits)
    cpu_auc = cpu_metric.result(cpu_state)
    # the histograms of the card's own sigmoid, binned on the host: the
    # counts must be the card's exactly
    probs = torch.sigmoid(logits.cuda()).cpu()
    host = StreamingAUC(from_logits=False)
    host_state = host.update(host.init("cpu"), labels, probs)
    exact_counts = (torch.equal(host_state.tp, state.tp.cpu())
                    and torch.equal(host_state.fp, state.fp.cpu()))
    emit(phase="dlrm_auc", samples=int(labels.numel()),
         logits_dtype=str(logits.dtype), bins=metric.bins,
         card_auc=card_auc, exact_auc=exact, cpu_streaming_auc=cpu_auc,
         card_minus_exact=card_auc - exact,
         card_equals_cpu=card_auc == cpu_auc,
         bins_differing_from_cpu=int(
             ((state.tp.cpu() != cpu_state.tp)
              | (state.fp.cpu() != cpu_state.fp)).sum()),
         histograms_exact=exact_counts)
    check(logits.dtype == torch.float32, f"logits in {logits.dtype}")
    check(abs(card_auc - exact) <= AUC_EXACT_TOL,
          f"on-card AUC {card_auc} against the exact {exact}")
    check(exact_counts, "the card's AUC histograms differ from "
                        "its own probabilities binned on the host")
    check(abs(card_auc - cpu_auc) <= 1e-4,
          f"on-card AUC {card_auc}, CPU StreamingAUC {cpu_auc}")
    return card_auc


def dlrm_fit_phase(torch, cuda_lookup, cuda_sparse, counted, rate):
    """DLRM at the example's widths (Criteo sizes x DLRM_TABLE_SCALE, width
    128, bottom 512-256-128, top 1024-1024-512-256-1, 13 numerical
    features, batch 65,536) trained by sparse sgd at the example's
    schedule through `fit` from a split-binary dataset (a seeded
    ClickGenerator stream written to a temporary directory, read by
    `RawBinaryDataset`: ``raw_batches`` + ``preprocess``) with eval
    every DLRM_EVAL_EVERY steps, pipelined, then again from the same
    weights with ``pipelined=False``, and pipelined with the ``os.pread``
    reader (``use_native_prefetch=False``) before and after the
    prefetcher's runs (their ``read`` stage means beside the
    prefetcher's): losses, eval AUCs, tables (by `table_digest`) and MLPs
    bit-identical. The on-card AUC against
    `auc_exact` and a CPU `StreamingAUC` of the same logits. Then the
    step's kernels held and timed at its shapes (`dlrm_step_kernels`, on
    the serial run's model). Returns the launch counts of the pipelined
    run and of the serial one, `dlrm_step_kernels`' totals, and the
    pipelined run's step median, AUCs, losses, peak memory and profiled
    step (phase 11c sets its bfloat16 run beside them)."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        DLRM, make_lr_schedule, scaled_table_sizes)
    from distributed_embeddings_tpu_torch.training import fit
    sizes = scaled_table_sizes(DLRM_TABLE_SCALE)
    dataset = shared_dataset(sizes)
    evals = DLRM_FIT_STEPS // DLRM_EVAL_EVERY
    want = {"lookup_combine": DLRM_FIT_STEPS + evals * DLRM_EVAL_STEPS,
            "segment_sum_sorted": DLRM_FIT_STEPS,
            "sgd_rows": DLRM_FIT_STEPS}
    runs, counts, read_ms = {}, {}, {}
    # the os.pread runs before and after the prefetcher's pipelined one
    for label, pipelined, native_reads in (
            ("dlrm_fit_pread", True, False), ("dlrm_fit", True, True),
            ("dlrm_fit_serial", False, True),
            ("dlrm_fit_pread_again", True, False)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = DLRM(sizes, device="cuda", lookup_path="pallas",
                     generator=torch.Generator(device="cuda")
                     .manual_seed(DLRM_SEED))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        train, test = dataset(False, native_reads), dataset(True,
                                                            native_reads)
        window = StepWindow(torch, DLRM_PROFILED_STEP)
        set_counts(cuda_lookup, *counted)
        set_native_calls()
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
        counts[label] = read_counts(cuda_lookup, *counted)
        native = read_native_calls(label)
        # each train batch's 28 files and each eval batch's, through the
        # prefetcher (none with os.pread)
        reads = (DLRM_FIT_STEPS + evals * DLRM_EVAL_STEPS) * (2 + len(sizes))
        check((native["prefetch"] >= reads if native_reads
               else native["prefetch"] == 0) and native["host_apply"] == 0,
              f"{label}: native calls {native}, want "
              f"{'at least ' + str(reads) if native_reads else 'no'} "
              "prefetcher reads")
        check(counts[label] == per_step(want, 1),
              f"{label} launches {counts[label]}, want {want} "
              f"({DLRM_FIT_STEPS} steps, {evals} evals of "
              f"{DLRM_EVAL_STEPS} forwards)")
        check(all(map(math.isfinite, hist["loss"])),
              f"{label}: non-finite losses {hist['loss']}")
        skip = {s for s in range(DLRM_FIT_STEPS)
                if s % DLRM_EVAL_EVERY == 0}
        step_ms = window.step_ms(skip)
        med = statistics.median(step_ms)
        profiled = window.profile()
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
             native_calls=native, profiled_step=profiled)
        if pipelined:
            read_ms.setdefault("native" if native_reads else "pread",
                               []).append(
                hist["ingest_stages"]["read"]["mean_ms"])
        runs[label] = (hist["loss"], hist["eval_auc"],
                       [table_digest(torch, t) for t in model.embedding.tp],
                       {n: p.detach().clone() for n, p in
                        model.named_parameters() if p.requires_grad})
        if label == "dlrm_fit":
            # the on-card AUC of the trained model's logits
            card_auc = dlrm_card_auc(torch, model, test)
            check(card_auc == hist["eval_auc"][-1],
                  f"fit's last eval AUC {hist['eval_auc'][-1]} against "
                  f"the phase's {card_auc}")
            summary = dict(median_step_ms=med, card_auc=card_auc,
                           eval_auc=hist["eval_auc"],
                           losses=hist["loss"],
                           max_memory_allocated=torch.cuda
                           .max_memory_allocated(),
                           profiled_step=profiled)
        elif label == "dlrm_fit_serial":
            step_kernels = dlrm_step_kernels(torch, cuda_lookup,
                                             cuda_sparse, model,
                                             train[0], rate)
        del model, train, test
        torch.cuda.empty_cache()
    (l1, a1, d1, m1) = runs["dlrm_fit"]
    for other in ("dlrm_fit_serial", "dlrm_fit_pread",
                  "dlrm_fit_pread_again"):
        (l2, a2, d2, m2) = runs[other]
        same = (l1 == l2 and a1 == a2 and d1 == d2
                and all(torch.equal(m1[n], m2[n]) for n in m1))
        emit(phase="dlrm_pipelined_vs_serial", against=other,
             bit_identical=same, losses_equal=l1 == l2,
             eval_auc_equal=a1 == a2, table_digests_equal=d1 == d2)
        check(same, f"the pipelined fit and {other} differ")
    prefetch_hold(dataset, read_ms)
    return counts, step_kernels, summary


def prefetch_hold(dataset, fit_read_ms):
    """Every train and test batch of a `dlrm_dataset` through the native
    prefetcher (`read_raw` in order, its window of `prefetch_depth`
    batches ahead) against an ``os.pread`` reader of the same files, byte
    for byte, each reader timed over the pass (the files are in the page
    cache: warm reads); printed beside the pipelined `fit`'s ``read``
    stage mean through each reader (`fit_read_ms`)."""
    out = {}
    for valid in (False, True):
        native, plain = dataset(valid), dataset(valid, native=False)
        check(native._prefetcher is not None and plain._prefetcher is None,
              "prefetch_hold: the readers are not the native and the "
              "os.pread one")
        ms = {"native": [], "pread": []}
        for i in range(len(native)):
            t0 = time.perf_counter()
            got = native.read_raw(i)
            t1 = time.perf_counter()
            want = plain.read_raw(i)
            ms["native"].append((t1 - t0) * 1e3)
            ms["pread"].append((time.perf_counter() - t1) * 1e3)
            check(len(got) == len(want) and all(
                a.tobytes() == b.tobytes() for a, b in zip(got, want)),
                  f"prefetch_hold: batch {i} (valid={valid}) differs from "
                  "the os.pread reader's")
        out["test" if valid else "train"] = dict(
            batches=len(native), native_mean_ms=statistics.mean(ms["native"]),
            pread_mean_ms=statistics.mean(ms["pread"]),
            batch_bytes=sum(b.nbytes for b in got))
        native.close()
        plain.close()
    emit(phase="prefetch_hold", bit_identical=True,
         fit_read_stage_mean_ms=fit_read_ms, **out)


def dlrm_against_cpu_phase(torch, cuda_lookup, cuda_sparse, counted,
                           compute_dtype=None):
    """The same DLRM at DLRM_CPU_SCALE, 3 sgd steps at batch 65,536, each
    held against a CPU trainer from the card's state (phase 5's way:
    losses, touched table rows by change, the MLPs by value; the row
    sums' conditioning from the CPU step's contributions). With a
    `compute_dtype` (phase 11b), both trainers at it: the bars widen by
    one rounding of a term (`AMP_TERM_EPS`) at the tap gradients' own
    conditioning (`dlrm_tap_cond`), and after the steps an
    `InferenceEngine` on the card's model serves a request of
    AMP_REQUESTS[-1] rows against a CPU engine with the card's weights:
    the embedding outputs bit-equal, the logits within AMP_SERVE_TOL.
    Returns the launch counts."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        DLRM, scaled_table_sizes)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    from distributed_embeddings_tpu_torch.ops.cuda_lookup import form_name
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    from distributed_embeddings_tpu_torch.utils.device import (
        resolve_compute_dtype)
    dtype = resolve_compute_dtype(compute_dtype)
    label = "dlrm_against_cpu" if dtype is None else "dlrm_amp_against_cpu"
    sizes = scaled_table_sizes(DLRM_CPU_SCALE)
    t0 = time.perf_counter()
    model = DLRM(sizes, device="cuda", lookup_path="pallas",
                 compute_dtype=dtype,
                 generator=torch.Generator(device="cuda").manual_seed(3))
    cpu_model = DLRM(sizes, device="cpu", lookup_path="pallas",
                     compute_dtype=dtype)
    gen = ClickGenerator(sizes, 13, BATCH, seed=DLRM_SEED + 1)
    batches = [gen.batch(s) for s in range(TRAIN_STEPS)]
    init, step = make_sparse_train_step(model, "sgd", lr=TRAIN_LR)
    _, cpu_step = make_sparse_train_step(cpu_model, "sgd", lr=TRAIN_LR)
    set_counts(cuda_lookup, *counted)
    _, held = train_against_cpu(torch, rows_capture(cuda_sparse, "sgd"),
                                "sgd", "change", step, model, init(model),
                                cpu_step, cpu_model, batches, scaled=False,
                                contrib=True,
                                term_eps=0.0 if dtype is None
                                else AMP_TERM_EPS,
                                tap_cond=None if dtype is None
                                else dlrm_tap_cond)
    torch.cuda.synchronize()
    counts = read_counts(cuda_lookup, *counted)
    lookup = form_name(dtype or torch.float32)
    want = {lookup: 1, "segment_sum_sorted": 1, "sgd_rows": 1}
    check(counts == per_step(want, TRAIN_STEPS),
          f"{label} launches {counts}, want {want} per step")
    emit(phase="main_path", path=label, steps=TRAIN_STEPS,
         seconds=time.perf_counter() - t0, rows=sum(sizes),
         compute_dtype=str(dtype or torch.float32),
         table_bytes=sum(t.numel() * 4 for t in model.embedding.tp),
         launches=counts, losses=held["losses"],
         cpu_losses=held["cpu_losses"], max_abs_err=held["max_abs_err"],
         touched_rows=[int(t.numel()) for t in held["touched"]],
         table_change_median=held["changes"].median().item(),
         table_change_max=held["changes"].max().item(),
         table_changes_past_rounding=held["moved"],
         relu_flips=held["relu_flips"], ok=True)
    del held
    if dtype is not None:
        # the engine at the compute dtype against a CPU engine
        cpu_model.load_state_dict(model.state_dict())
        engine = InferenceEngine(model, device="cuda")
        cpu_engine = InferenceEngine(cpu_model, device="cpu")
        rows = AMP_REQUESTS[-1]
        num, cats, _ = ClickGenerator(sizes, 13, rows,
                                      seed=DLRM_SEED + 2).batch(0)
        got, want_l = engine.predict((num, cats)).cpu(), cpu_engine.predict(
            (num, cats))
        with torch.no_grad():
            emb = [e.cpu() for e in model.embedding(
                [torch.as_tensor(c, device="cuda") for c in cats])]
            cpu_emb = cpu_model.embedding(
                [torch.as_tensor(c) for c in cats])
        emb_equal = all(a.dtype == dtype and torch.equal(a, b)
                        for a, b in zip(emb, cpu_emb))
        err = (got - want_l).abs().max().item()
        ok = (got.dtype == torch.float32 and bool(torch.isfinite(got).all())
              and torch.allclose(got, want_l, **AMP_SERVE_TOL))
        emit(phase="amp_serving_check", path=label, rows=rows,
             embedding_outputs_bit_equal=emb_equal,
             logits_dtype=str(got.dtype), max_abs_err=err,
             tolerance=AMP_SERVE_TOL, ok=ok and emb_equal)
        check(emb_equal, f"{label}: the engine's embedding outputs differ "
                         "from the CPU's")
        check(ok, f"{label}: a {rows}-row request's logits differ from the "
                  f"CPU engine's by {err}")
        del engine, cpu_engine
    del model, cpu_model
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


# ---- the tenth slice: mixed precision (compute_dtype bfloat16) on the
# DLRM paths, the engine and the placement groups
AMP_DTYPE = "bfloat16"
# how far apart one rounding to bfloat16 may put a term of two trainers
# whose float32 values differ in their low digits, relative to the term:
# half the spacing of bfloat16 at 1 (one side rounds up, the other down
# at a tie point; `train_against_cpu`'s term_eps)
AMP_TERM_EPS = 2.0 ** -8
# a bfloat16 model's logits on the card against the CPU engine's: an
# interaction element whose float32 value sits at a rounding tie point
# rounds to neighbouring bfloat16 values on the two (3.5e-5 measured at
# 4,097 rows on an H100; the JAX package's own bfloat16-against-float32
# bar is 4e-2)
AMP_SERVE_TOL = dict(rtol=1e-3, atol=2e-4)
AMP_REQUESTS = (65536, 4097)
AMP_WORLD_SCALE = 0.02        # Criteo sizes x 0.02 at W = 2: 1.92 GB
# the thresholds cut with the tables: the same 13 / 8 (9, 2) / 5 plan
AMP_WORLD_KW = {k: v // 10 for k, v in PLACEMENT_KW.items()}
AMP_WORLD_TIMED_STEPS = 5


def amp_kernel_cases(torch, cuda_lookup, captured, rate, at):
    """Phase 11a: `lookup_combine`'s mixed-precision forms, the bf16 and
    f16 stores and their round-first forms, on a path's calls `captured`
    ((table, ids, weights) each): every form bit-equal to its plain
    version on the same inputs (which adds the K terms in the kernel's
    order); at hotness 1 with weights other than 0 and 1, the one input
    where the two forms give other bits, the plain store and round-first
    results must differ too. Each form timed (CUDA graph replays) beside
    the float32 form, its plain version and its bound: each distinct
    float32 row read once, the ids and weights once, the compute dtype's
    rows written once, at the card's memory rate. One `amp_kernel` line a
    (call, form). Returns {form: totals over the calls}."""
    forms = [(getattr(torch, d), r) for d in ("bfloat16", "float16")
             for r in (False, True)]
    totals = {cuda_lookup.form_name(d, r): dict(
        ms=0.0, f32_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
        ops_ms=0.0, library_ms=None, max_abs_err=0.0)
        for d, r in forms}
    for g, (table, ids, weights) in enumerate(captured):
        n, k = ids.shape
        width = table.shape[1]
        f32_ms = device_ms(
            lambda: cuda_lookup.lookup_combine(table, ids, weights), reps=20)
        unique_rows = int(torch.unique(ids.clamp(0, table.shape[0] - 1))
                          .numel())
        forms_differ = (k == 1 and weights is not None and bool(
            ((weights != 0) & (weights != 1)).any()))
        store_want = None
        for out_dtype, rnd in forms:
            name = cuda_lookup.form_name(out_dtype, rnd)
            got = cuda_lookup.lookup_combine(table, ids, weights, out_dtype,
                                             rnd)
            want = cuda_lookup.lookup_combine_plain(table, ids, weights,
                                                    out_dtype, rnd)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = got.dtype == out_dtype and torch.equal(got, want)
            check(ok, f"{name} disagrees with its plain version at {at} "
                      f"call {g}: max abs err {err}")
            if forms_differ and not rnd:
                store_want = want
            elif forms_differ:
                check(not torch.equal(store_want, want),
                      f"{name}: the store and round-first forms' plain "
                      f"versions agree at {at} call {g}")
            out_bytes = got.element_size()
            del got, want
            ms = device_ms(lambda: cuda_lookup.lookup_combine(
                table, ids, weights, out_dtype, rnd), reps=20)
            plain_ms = device_ms(lambda: cuda_lookup.lookup_combine_plain(
                table, ids, weights, out_dtype, rnd), reps=5)
            n_bytes = (unique_rows * width * 4
                       + ids.numel() * ids.element_size()
                       + (0 if weights is None else weights.numel() * 4)
                       + n * width * out_bytes)
            bytes_ms = n_bytes / rate * 1e3
            ops_ms = 2 * n * k * width / F32_FLOP_PER_S * 1e3
            emit(phase="amp_kernel", at=at, call=g, form=name,
                 table=list(table.shape), ids=list(ids.shape),
                 weighted=weights is not None, unique_rows=unique_rows,
                 forms_differ=forms_differ, bytes=n_bytes,
                 max_abs_err=err, ms=ms,
                 f32_ms=f32_ms, plain_ms=plain_ms,
                 bound_ms=max(bytes_ms, ops_ms), library_ms=None, ok=ok)
            tot = totals[name]
            for key, val in (("ms", ms), ("f32_ms", f32_ms),
                             ("plain_ms", plain_ms),
                             ("bound_ms", max(bytes_ms, ops_ms)),
                             ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                tot[key] += val
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
    return totals


def serve_latency_ms(torch, engine, request, reps=5):
    """Median ms of `reps` synchronized `predict` calls after 2 warm
    ones."""
    times = []
    for _ in range(2 + reps):
        t0 = time.perf_counter()
        engine.predict(request)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[2:]) * 1e3


def dlrm_amp_fit_phase(torch, cuda_lookup, cuda_sparse, counted, rate,
                       f32_fit):
    """Phases 11c, 11a and 11d at DLRM x DLRM_TABLE_SCALE (phase 9's model
    freed first: two of them do not fit the card). 11c: the model at
    AMP_DTYPE trained by `fit` on phase 9's dataset (the same seeded
    stream, written again), pipelined, as phase 9 trains it: launches
    (the bf16 store form of `lookup_combine` 1 a step and 1 an eval
    forward), step median, one profiled step, peak memory, the on-card
    AUC against `auc_exact` (`dlrm_card_auc`), each beside `f32_fit`, the
    same run's float32 `dlrm_fit`. 11a: one more step's `lookup_combine`
    call, at DLRM's shapes, through every mixed-precision form
    (`amp_kernel_cases`). 11d: `InferenceEngine` on the trained model,
    AMP_REQUESTS timed, beside the same weights served at float32.
    Returns ({path: launch counts}, `amp_kernel_cases`' totals)."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        DLRM, make_lr_schedule, scaled_table_sizes)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.training import (
        fit, make_sparse_train_step)
    from distributed_embeddings_tpu_torch.ops import kernel_build
    sizes = scaled_table_sizes(DLRM_TABLE_SCALE)
    label = "dlrm_amp_fit"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dlrm_amp")
    builds = {}
    try:
        builds = start_one_hot_builds(kernel_build, tmp)
        dataset = shared_dataset(sizes)
        evals = DLRM_FIT_STEPS // DLRM_EVAL_EVERY
        want = {"lookup_combine_bf16": (DLRM_FIT_STEPS
                                        + evals * DLRM_EVAL_STEPS),
                "segment_sum_sorted": DLRM_FIT_STEPS,
                "sgd_rows": DLRM_FIT_STEPS}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = DLRM(sizes, device="cuda", lookup_path="pallas",
                     compute_dtype=AMP_DTYPE,
                     generator=torch.Generator(device="cuda")
                     .manual_seed(DLRM_SEED))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        train, test = dataset(False), dataset(True)
        window = StepWindow(torch, DLRM_PROFILED_STEP)
        set_counts(cuda_lookup, *counted)
        t0 = time.perf_counter()
        _, _, hist = fit(
            model, train.raw_batches(DLRM_FIT_STEPS), DLRM_FIT_STEPS, "sgd",
            lr=make_lr_schedule(*DLRM_LR), preprocess=train.preprocess,
            pipelined=True, eval_data=lambda j: test[j % len(test)],
            eval_every=DLRM_EVAL_EVERY, eval_steps=DLRM_EVAL_STEPS,
            log_every=0, callbacks=[window])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts(cuda_lookup, *counted)
        check(counts == per_step(want, 1),
              f"{label} launches {counts}, want {want}")
        check(all(map(math.isfinite, hist["loss"])),
              f"{label}: non-finite losses {hist['loss']}")
        skip = {s for s in range(DLRM_FIT_STEPS)
                if s % DLRM_EVAL_EVERY == 0}
        step_ms = window.step_ms(skip)
        med = statistics.median(step_ms)
        peak = torch.cuda.max_memory_allocated()
        emit(phase="main_path", path=label, compute_dtype=AMP_DTYPE,
             steps=DLRM_FIT_STEPS, build_s=build_s, fit_s=fit_s,
             launches=counts, losses=hist["loss"],
             eval_auc=hist["eval_auc"], median_step_ms=med,
             samples_per_s=BATCH / (med / 1e3), step_ms=step_ms,
             max_memory_allocated=peak,
             ingest_stage_mean_ms={k: v["mean_ms"] for k, v in
                                   hist["ingest_stages"].items()},
             profiled_step=window.profile(),
             f32_dlrm_fit=dict(median_step_ms=f32_fit["median_step_ms"],
                               max_memory_allocated=f32_fit[
                                   "max_memory_allocated"],
                               eval_auc=f32_fit["eval_auc"],
                               losses=f32_fit["losses"],
                               profiled_step=f32_fit["profiled_step"]))
        card_auc = dlrm_card_auc(torch, model, test)
        check(card_auc == hist["eval_auc"][-1],
              f"{label}: fit's last eval AUC {hist['eval_auc'][-1]} against "
              f"the phase's {card_auc}")
        emit(phase="amp_auc", path=label, card_auc=card_auc,
             f32_card_auc=f32_fit["card_auc"],
             bf16_minus_f32=card_auc - f32_fit["card_auc"])

        # 11a: the kernel forms at DLRM's shapes, one more step's call
        init, step = make_sparse_train_step(model, "sgd",
                                            lr=make_lr_schedule(*DLRM_LR))
        num, cats, labels = DeviceStager("cuda")(train[0])
        with Capture(cuda_lookup, "lookup_combine") as look:
            step(model, init(model), num, list(cats), labels)
        torch.cuda.synchronize()
        check(len(look.calls) == 1 and look.calls[0][3] == torch.bfloat16,
              f"{label}: {len(look.calls)} lookups captured, want 1 bf16")
        calls = lookup_args(look.calls)
        forms = amp_kernel_cases(torch, cuda_lookup, calls, rate, "dlrm_fit")
        one_hot_rows_sweep(torch, cuda_lookup, kernel_build, builds,
                           calls[0], "dlrm_fit")
        # the same table and ids at hotness 1 with weights in (0, 1): the
        # one input where the store and round-first forms differ
        table, ids, _ = calls[0]
        ids = ids[:, :1].contiguous()
        weights = torch.rand(ids.shape, device=ids.device,
                             generator=torch.Generator(device=ids.device)
                             .manual_seed(DLRM_SEED))
        weighted = amp_kernel_cases(torch, cuda_lookup,
                                    [(table, ids, weights)], rate,
                                    "dlrm_fit_weighted")
        for kname, tot in forms.items():
            tot["max_abs_err"] = max(tot["max_abs_err"],
                                     weighted[kname]["max_abs_err"])
        del look, calls, table, ids, weights

        # 11d: the engine at bfloat16 and, on the same weights, at float32,
        # twice each in turn (the order's effect shows in the repeats)
        served = {}
        for dtype in (AMP_DTYPE, None) * 2:
            model.compute_dtype = model.embedding.compute_dtype = (
                None if dtype is None else torch.bfloat16)
            engine = InferenceEngine(model, device="cuda")
            engine.warmup(list(AMP_REQUESTS))
            for rows in AMP_REQUESTS:
                req = ClickGenerator(sizes, 13, rows,
                                     seed=DLRM_SEED + 3).batch(0)[:2]
                logits = engine.predict(req)
                check(logits.dtype == torch.float32
                      and tuple(logits.shape) == (rows, 1)
                      and bool(torch.isfinite(logits).all()),
                      f"{label}: a {rows}-row request gave "
                      f"{logits.dtype} {tuple(logits.shape)}")
                served.setdefault(rows, {}).setdefault(
                    "float32" if dtype is None else dtype, []).append(
                    serve_latency_ms(torch, engine, req))
            del engine
        for rows, ms in served.items():
            emit(phase="amp_serving", path=label, rows=rows,
                 median_ms=ms, rows_per_s={k: [rows / (v / 1e3) for v in vs]
                                           for k, vs in ms.items()})
        del model, train, test
        torch.cuda.empty_cache()
        return {label: counts}, forms
    finally:
        for proc, _ in builds.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)


def gloo_16bit_probe(torch, dev, rank, world):
    """The collectives the wire runs, on bfloat16 CUDA tensors over the
    process group (gloo when the ranks share a card): all_to_all_single,
    all_gather_into_tensor, reduce_scatter_tensor, each against the
    values it must give. Returns {collective: ok}."""
    import torch.distributed as dist
    out = {}
    x = (torch.arange(world * 4, dtype=torch.float32, device=dev)
         + 100 * rank).to(torch.bfloat16)
    got = torch.empty_like(x)
    dist.all_to_all_single(got, x)
    want = torch.cat([(torch.arange(4, dtype=torch.float32, device=dev)
                       + 4 * rank + 100 * r) for r in range(world)])
    out["all_to_all_single"] = torch.equal(got.float(), want)
    y = torch.full((2,), rank + 0.5, dtype=torch.bfloat16, device=dev)
    gathered = torch.empty((2 * world,), dtype=torch.bfloat16, device=dev)
    dist.all_gather_into_tensor(gathered, y)
    out["all_gather_into_tensor"] = torch.equal(
        gathered.float(), torch.arange(world, device=dev).float()
        .repeat_interleave(2) + 0.5)
    z = torch.full((2 * world,), 1.5, dtype=torch.bfloat16, device=dev)
    part = torch.empty((2,), dtype=torch.bfloat16, device=dev)
    dist.reduce_scatter_tensor(part, z)
    out["reduce_scatter_tensor"] = torch.equal(
        part.float(), torch.full((2,), 1.5 * world, device=dev))
    torch.cuda.synchronize()
    return out


def amp_placement_rank(rank, world, backend, init_method, out_dir):
    """One rank of phase 11e (spawned as phase 10's are): the collectives
    probed on bfloat16 CUDA tensors (`gloo_16bit_probe`); the placement
    DLRM at AMP_WORLD_SCALE with AMP_WORLD_KW at AMP_DTYPE, drawn by
    `seed_weights`, its plan; the forward of its slice of batch 0
    (embedding outputs and logits saved); 3 sgd steps at the example's
    schedule (launches counted, each collective's calls, bytes and
    dtypes recorded by `wire_payloads`); one more step whose
    `lookup_combine` call on the first row shard (the round-first form)
    rank 0 runs through `amp_kernel_cases`; AMP_WORLD_TIMED_STEPS timed
    steps after 2 warm ones; one profiled step (`placement_profile`);
    the peak memory. Results go to ``out_dir``."""
    import torch
    check("jax" not in sys.modules, f"rank {rank} imported jax")
    import torch.distributed as dist
    from distributed_embeddings_tpu_torch.models.dlrm import make_lr_schedule
    from distributed_embeddings_tpu_torch.ops import (cuda_lookup, cuda_sparse,
                                                      cuda_tiled)
    from distributed_embeddings_tpu_torch.parallel.mesh import (
        initialize_distributed)
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager, stage_dp_batch)
    from distributed_embeddings_tpu_torch.tools import cuda_feature_probe
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (world + 1)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    initialize_distributed(backend, init_method, world, rank)
    try:
        out = {"rank": rank, "device": str(dev)}
        out["probe"] = gloo_16bit_probe(torch, dev, rank, world)
        check(all(out["probe"].values()),
              f"rank {rank}: bfloat16 collectives {out['probe']}")
        model = placement_model(torch, dev, rank, AMP_WORLD_SCALE,
                                AMP_WORLD_KW, AMP_DTYPE)
        layer = model.embedding
        groups = layer.strategy.table_groups
        out["plan"] = dict(dp=len(groups[0]), tp=len(groups[1]),
                           placements=len(layer.plan.tp_placements),
                           buckets=len(layer.plan.tp_buckets),
                           row=len(groups[2]))
        stager = DeviceStager(dev)
        batches = [stage_dp_batch(b, stager)
                   for b in placement_batches(model, TRAIN_STEPS)]
        num0, cats0, _ = batches[0]
        with torch.no_grad():
            emb = layer(cats0)
            logits = model(num0, cats0)
        out["emb_dtypes"] = sorted({str(e.dtype) for e in emb})
        torch.save({"emb": torch.cat(emb, dim=1).cpu(),
                    "logits": logits.cpu()},
                   os.path.join(out_dir, f"forward{rank}.pt"))
        del emb, logits

        # the main path: 3 sgd steps, every collective recorded
        init, step = make_sparse_train_step(model, "sgd",
                                            lr=make_lr_schedule(*DLRM_LR))
        state = init(model)
        counted = (cuda_sparse, cuda_tiled, cuda_feature_probe)
        set_counts(cuda_lookup, *counted)
        losses = []
        with wire_payloads(torch) as payloads:
            for batch in batches:
                _, state, loss = step(model, state, *batch)
                losses.append(float(loss))
        torch.cuda.synchronize()
        out["launches"] = read_counts(cuda_lookup, *counted)
        out["losses"] = losses
        out["wire"] = {k: dict(v, calls=v["calls"] / TRAIN_STEPS,
                               bytes=v["bytes"] / TRAIN_STEPS)
                       for k, v in payloads.items()}
        key = tuple((1, False) for _ in layer.strategy.input_groups[1])
        tp_groups, _ = layer._exchange_groups_for_key(key)
        out["groups"] = len(tp_groups)
        out["tp_buckets_updated"] = len({g.bucket for g in tp_groups})
        out["row_tables"] = len(layer.row)

        # 11a at a row shard's shapes: one more step's call on shard 0
        shard = layer.row[0].data_ptr()
        with Capture(cuda_lookup, "lookup_combine") as look:
            _, state, _ = step(model, state, *batches[0])
        torch.cuda.synchronize()
        if rank == 0:
            calls = [a for a in look.calls if a[0].data_ptr() == shard]
            check(len(calls) == 1 and tuple(calls[0][3:]) == (
                torch.bfloat16, True),
                  f"rank 0: {len(calls)} lookups on row shard 0, want 1 "
                  "of the bf16 round-first form")
            out["amp_kernels"] = amp_kernel_cases(
                torch, cuda_lookup, lookup_args(calls),
                hbm_rate(torch.cuda.get_device_name(dev)), "row_shard")
            del calls
        del look
        dist.barrier()

        times = []
        for i in range(2 + AMP_WORLD_TIMED_STEPS):
            t1 = time.perf_counter()
            _, state, _ = step(model, state, *batches[i % TRAIN_STEPS])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        out["step_ms"] = [t * 1e3 for t in times[2:]]
        holder = {"state": state}
        del state

        def step_once():
            holder["state"] = step(model, holder["state"], *batches[0])[1]
        out.update(placement_profile(torch, step_once, rank, out["groups"],
                                     out["row_tables"]))
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        check("jax" not in sys.modules, f"rank {rank} imported jax")
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(torch, fn, world, backend, tmp, label):
    """`fn(rank, world, backend, init_method, tmp)` on `world` spawned
    ranks, joined within WORLD_JOIN_S (a rank left alive is killed);
    returns each rank's ``tmp/rank<r>.pt``."""
    import torch.multiprocessing as torch_mp
    ctx = torch_mp.start_processes(
        fn, args=(world, backend, f"file://{tmp}/pg", tmp), nprocs=world,
        join=False, start_method="spawn")
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
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def amp_placement_phase(torch, f32_exchange):
    """Phase 11e: `amp_placement_rank` on PLACEMENT_WORLD ranks, then the
    world-1 model at AMP_DTYPE in this process (every table
    table-parallel) with the same per-table weights: the plan
    (PLACEMENT_PLAN) on each rank; each rank's embedding outputs (bfloat16)
    and logits bit-equal to world 1's on the same rows (one-hot ids: a
    row-sliced output is one shard's rounded row plus zeros); the launches
    a rank step (the bf16 store form a tp group, the round-first form a
    row shard, a segment sum and an sgd_rows a tp bucket and a row
    shard); every float payload of the wire's all_to_all, all_gather and
    reduce-scatter bfloat16; bytes and host ms by collective printed
    beside phase 10's float32 ones (`f32_exchange`: the same plan and
    batch, so the same shapes). Returns the ranks' launch counts,
    summed, and rank 0's `amp_kernel_cases` totals at row shard 0."""
    world = PLACEMENT_WORLD
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    label = f"world{world}_placement_amp"
    emit(phase="placement_setup", path=label, world=world, backend=backend,
         device_count=cards, table_scale=AMP_WORLD_SCALE,
         compute_dtype=AMP_DTYPE, **AMP_WORLD_KW)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_amp_placement")
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(torch, amp_placement_rank, world, backend, tmp,
                            label)
        ranks_s = time.perf_counter() - t0
        summed = dict.fromkeys(ALL_KERNELS, 0)
        wire_floats = ("all_to_all_single", "all_gather_into_tensor",
                       "reduce_scatter_tensor")
        for r in ranks:
            check(r["plan"] == PLACEMENT_PLAN,
                  f"{label}: rank {r['rank']} plans {r['plan']}, want "
                  f"{PLACEMENT_PLAN}")
            check(r["emb_dtypes"] == ["torch.bfloat16"],
                  f"{label}: rank {r['rank']} outputs {r['emb_dtypes']}")
            want_r = {"lookup_combine_bf16": r["groups"],
                      "lookup_combine_bf16_round": r["row_tables"],
                      "segment_sum_sorted": (r["tp_buckets_updated"]
                                             + r["row_tables"]),
                      "sgd_rows": r["tp_buckets_updated"] + r["row_tables"]}
            check(r["launches"] == per_step(want_r, TRAIN_STEPS),
                  f"{label}: rank {r['rank']} launches {r['launches']}, "
                  f"want {want_r} per step")
            for k, v in r["launches"].items():
                summed[k] += v
            floats = {n: [d for d in r["wire"][n]["dtypes"]
                          if d.startswith(("float", "bfloat"))]
                      for n in wire_floats}
            check(all(d == ["bfloat16"] for d in floats.values()),
                  f"{label}: rank {r['rank']}'s wire moved {floats}")

        # the world-1 model at the compute dtype: the same weights
        model = placement_model(torch, "cuda", 0, AMP_WORLD_SCALE,
                                AMP_WORLD_KW, AMP_DTYPE)
        layer = model.embedding
        batches = placement_batches(model, 1)
        b_l = BATCH // world
        identical, fwd_err = True, 0.0
        num, cats, _ = batches[0]
        for r in range(world):
            got = torch.load(os.path.join(tmp, f"forward{r}.pt"))
            blk = slice(r * b_l, (r + 1) * b_l)
            with torch.no_grad():
                emb = torch.cat(layer([c[blk] for c in cats]), dim=1).cpu()
                logits = model(num[blk], [c[blk] for c in cats]).cpu()
            for what, a, b in (("embedding outputs", got["emb"], emb),
                               ("logits", got["logits"], logits)):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"{label}: rank {r} {what} {a.dtype} "
                      f"{tuple(a.shape)}, want {b.dtype} {tuple(b.shape)}")
                fwd_err = max(fwd_err,
                              (a.float() - b.float()).abs().max().item())
                identical = identical and torch.equal(a, b)
        emit(phase="placement_forward", path=label, bit_identical=identical,
             max_abs_err=fwd_err)
        check(identical, f"{label}: the ranks' forwards differ from world "
                         f"1's by {fwd_err}")
        del model, layer
        torch.cuda.empty_cache()
        emit(phase="main_path", path=label, backend=backend, world=world,
             compute_dtype=AMP_DTYPE, steps=TRAIN_STEPS,
             ranks_seconds=ranks_s,
             launches_by_rank=[r["launches"] for r in ranks],
             losses_by_rank=[r["losses"] for r in ranks],
             probe=ranks[0]["probe"], ok=True)
        for r in ranks:
            emit(phase="amp_wire", path=label, rank=r["rank"],
                 step=r["wire"], f32_step=f32_exchange["wire"][r["rank"]],
                 exchange_host_ms=r["profile"]["exchange_host_ms"],
                 f32_exchange_host_ms=f32_exchange["exchange_host_ms"][
                     r["rank"]],
                 median_step_ms=statistics.median(r["step_ms"]),
                 f32_median_step_ms=f32_exchange["step_ms"][r["rank"]],
                 max_memory_allocated=r["max_memory_allocated"])
            emit(phase="world_profile", path=label, rank=r["rank"],
                 backend=backend, **r["profile"])
        if backend == "gloo":
            emit(phase="world_card_profile", path=label, backend=backend,
                 **card_profile(ranks))
        return summed, ranks[0]["amp_kernels"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------ 12. quantized storage
QUANT_CPU_SCALE = DLRM_CPU_SCALE    # 12a, 12c: Criteo sizes x 0.02
QUANT_HELD_STEPS = 3         # int8 and cut Tiny's adagrad
QUANT_FP8_STEPS = 2
QUANT_BF16_STEPS = 1
# 12b: DLRM at the MLPerf Criteo-1TB sizes (187.8M rows x 128), int8
QUANT_FULL_SCALE = 1.0
QUANT_FULL_STEPS = 22         # 2 warm + 20 timed
QUANT_PROFILED_STEP = 4
# the loss bar at bfloat16: the card's and the CPU's gemms round their
# float32 products apart, which a bfloat16 rounding of an activation can
# carry into its last place (2^-8)
QUANT_BF16_LOSS_TOL = dict(rtol=1e-3, atol=0.0)
RESUME_STEPS = 2
# the port's `ops.sparse_update.QUANTIZED_UPDATE_RANGE` and
# `layers.dist_model_parallel.QUANTIZED_LOOKUP_RANGE` (the top level
# imports no part of the package)
QUANT_UPDATE_RANGE = "quantized:update"
QUANT_LOOKUP_RANGE = "quantized:lookup"


def quantized_dlrm(torch, sizes, device, storage, seed, compute_dtype=None):
    """DLRM at the example's widths with its tables stored at `storage`
    (None: float32): built over 4-row stand-in tables, its embedding then
    rebuilt with ``storage_dtype``, as the JAX example rebuilds it
    (examples/dlrm/serve.py:103-113), so no float32 table of `sizes`
    exists. The tables' rows come from `seed`."""
    from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
        DistributedEmbedding)
    from distributed_embeddings_tpu_torch.layers.embedding import Embedding
    from distributed_embeddings_tpu_torch.models.dlrm import (
        DLRM, dlrm_initializer)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = DLRM([4] * len(sizes), device=device, lookup_path="pallas",
                 compute_dtype=compute_dtype, generator=gen)
    model.embedding = DistributedEmbedding(
        [Embedding(v, 128, embeddings_initializer=dlrm_initializer(),
                   device="meta") for v in sizes],
        strategy="memory_balanced", device=device, lookup_path="pallas",
        compute_dtype=model.compute_dtype, storage_dtype=storage,
        generator=gen)
    model.table_sizes = list(sizes)
    return model


class QuantCapture:
    """Within the block, every `quantized_row_update` call (the name of
    `module`, the port's `ops.sparse_update`, which the sparse optimizers'
    quantized rules call) runs as usual and is recorded on the host
    in compact form: the touched rows `uniq` (the valid ids, sorted), their
    payload bytes, scales and state rows before and after the call, the
    stream's ids renumbered into them (order kept: valid id -> its index
    in `uniq`, every other -> len(uniq), past the compact table) and its
    contributions. The CPU plain function on the compact rows then gives
    the card's rows bit for bit (`hold_quantized`): dedup's order, slots
    and so the rounding's draws are the same."""

    def __init__(self, torch, module):
        self.torch, self.module, self.calls = torch, module, []

    def __enter__(self):
        torch = self.torch
        self.real = real = self.module.quantized_row_update

        def rows_of(payload, scale, state, uniq):
            return dict(
                payload=payload.view(torch.uint8).index_select(0, uniq).cpu(),
                scale=scale.index_select(0, uniq).cpu(),
                state=[t.index_select(0, uniq).cpu() for t in state])

        def record(kind, payload, scale, state, grad, store_dtype, lr,
                   **kw):
            ids = grad.ids.long()
            valid = (ids >= 0) & (ids < payload.shape[0])
            uniq = torch.unique(ids[valid])
            local = torch.where(valid, torch.searchsorted(uniq, ids),
                                torch.full_like(ids, uniq.numel()))
            before = rows_of(payload, scale, state, uniq)
            out = real(kind, payload, scale, state, grad, store_dtype, lr,
                       **kw)
            self.calls.append(dict(
                kind=kind, dtype=payload.dtype, store_dtype=store_dtype,
                lr=lr, eps=kw.get("eps"), uniq=uniq.cpu(),
                ids=local.cpu(), contribs=grad.contribs.cpu(),
                n=int(ids.numel()), before=before,
                after=rows_of(payload, scale, state, uniq)))
            return out
        self.module.quantized_row_update = record
        return self

    def __exit__(self, *exc):
        self.module.quantized_row_update = self.real


def hold_quantized(torch, sparse_update, calls, label):
    """Each captured card update against the CPU plain function on its
    compact rows: payload bytes, scales and state bit-equal. Returns
    (rows, elements) held."""
    rows = elements = 0
    for i, c in enumerate(calls):
        b = c["before"]
        payload = b["payload"].clone().view(c["dtype"])
        scale, state = b["scale"].clone(), tuple(t.clone()
                                                 for t in b["state"])
        kw = {} if c["eps"] is None else {"eps": c["eps"]}
        sparse_update.quantized_row_update(
            c["kind"], payload, scale, state, sparse_update.SparseRowGrad(
                c["ids"], c["contribs"]), c["store_dtype"], c["lr"], **kw)
        a = c["after"]
        same = (torch.equal(payload.view(torch.uint8), a["payload"])
                and torch.equal(scale.view(torch.int32),
                                a["scale"].view(torch.int32))
                and all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                        for x, y in zip(state, a["state"])))
        moved = int((b["payload"] != a["payload"]).sum())
        if not same:
            emit(phase="not_bit_equal", kernel="quantized_row_update",
                 path=label, call=i,
                 payload_bytes_differing=int(
                     (payload.view(torch.uint8) != a["payload"]).sum()),
                 scales_differing=int((scale != a["scale"]).sum()))
        check(same, f"{label}: the card's quantized update {i} differs from "
                    "the CPU plain function on the same rows")
        rows += int(c["uniq"].numel())
        elements += int(c["uniq"].numel()) * int(b["payload"].shape[1])
        emit(phase="quantized_update_held", path=label, call=i,
             kind=c["kind"], store_dtype=c["store_dtype"], ids=c["n"],
             touched_rows=int(c["uniq"].numel()),
             payload_bytes_moved=moved, bit_equal=True)
    return rows, elements


class RowsTap:
    """Within the block, each decode-gather of `layer` (its
    `_quantized_rows`: a quantized bucket's rows gathered and decoded,
    before the cast and the combine) runs as usual, and its float32 rows
    are kept on the host in call order (`rows`)."""

    def __init__(self, layer):
        self.layer, self.rows = layer, []

    def __enter__(self):
        real = self.layer._quantized_rows

        def tap(b, ids):
            out = real(b, ids)
            self.rows.append(out.cpu())
            return out
        self.layer._quantized_rows = tap
        return self

    def __exit__(self, *exc):
        del self.layer._quantized_rows


def quantized_held_run(torch, sparse_update, label, model, cpu_model, kind,
                       batches, loss_tol=LOSS_TOL, lr=TRAIN_LR):
    """`kind` steps of the card's quantized model over `batches`, each
    held against the CPU: the CPU model takes the card's state; each of
    the card's decode-gathers (`RowsTap`: the gathered, decoded rows
    before the combine) bit-equal to the CPU's on the same payload; the
    combined embedding outputs bit-equal on a batch where every input is
    one-hot (a multi-hot input's hotness sum adds in another order on the
    card: KERNEL_TOL, as phase 3 holds the kernel's); the card's step, its
    updates captured and each held bit for bit against the CPU plain
    function (`hold_quantized`); its loss against the CPU model's forward
    loss within `loss_tol`."""
    import numpy as np
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager)
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    init, step = make_sparse_train_step(model, kind, lr=lr)
    state = init(model)
    stage = DeviceStager("cuda")
    out = dict(losses=[], cpu_losses=[], rows=0, elements=0,
               decoded_elements=0, outputs_bit_equal=True,
               outputs_max_abs_err=0.0)
    for s, batch in enumerate(batches):
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        num, cats, labels = stage(batch)
        with torch.no_grad():
            with RowsTap(model.embedding) as card_rows:
                got = model.embedding(list(cats))
            with RowsTap(cpu_model.embedding) as cpu_rows:
                want = cpu_model.embedding([torch.as_tensor(c) for c in
                                            batch[1]])
            decoded = (len(card_rows.rows) == len(cpu_rows.rows) > 0
                       and all(torch.equal(a.view(torch.int32),
                                           b.view(torch.int32))
                               for a, b in zip(card_rows.rows,
                                               cpu_rows.rows)))
            n_decoded = sum(a.numel() for a in card_rows.rows)
            del card_rows, cpu_rows
            got = [a.cpu() for a in got]
            same = all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(got, want))
            one_hot = all(np.ndim(c) == 1 or np.shape(c)[1] == 1
                          for c in batch[1])
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            close = all(torch.allclose(a.float(), b.float(), **KERNEL_TOL)
                        for a, b in zip(got, want))
            cpu_loss = float(cpu_model.loss_fn(
                torch.as_tensor(batch[0]), [torch.as_tensor(c)
                                            for c in batch[1]],
                torch.as_tensor(batch[2])))
        del got, want
        out["decoded_elements"] += n_decoded
        out["outputs_bit_equal"] &= same
        out["outputs_max_abs_err"] = max(out["outputs_max_abs_err"], err)
        check(decoded, f"{label} step {s}: the card's decode-gather differs "
                       "from the CPU's on the same payload")
        check(same or (close and not one_hot),
              f"{label} step {s}: the card's combined embedding outputs "
              f"differ from the CPU's by {err}")
        with QuantCapture(torch, sparse_update) as cap:
            _, state, loss = step(model, state, num, list(cats), labels)
            loss = float(loss)
        rows, elements = hold_quantized(torch, sparse_update, cap.calls,
                                        f"{label} step {s}")
        out["rows"] += rows
        out["elements"] += elements
        out["losses"].append(loss)
        out["cpu_losses"].append(cpu_loss)
        emit(phase="held_step", path=label, kind=kind, loss=loss,
             cpu_loss=cpu_loss, updates=len(cap.calls), touched_rows=rows)
        del cap
    check(torch.allclose(torch.tensor(out["losses"]),
                         torch.tensor(out["cpu_losses"]), **loss_tol),
          f"{label}: losses {out['losses']} against the CPU's "
          f"{out['cpu_losses']}")
    return out


def quantized_against_cpu_phase(torch, cuda_lookup, counted):
    """12a: DLRM at the example's widths with Criteo sizes x 0.02 stored
    int8 (3 sgd steps at batch 65,536) and fp8 (2), held against the CPU
    (`quantized_held_run`), then int8 at bfloat16 (1 step) and adagrad
    on Tiny cut to 100,000 rows a table, int8 (3 steps). Launches: one
    `segment_sum_sorted` per quantized bucket a step (dedup's) and no other
    kernel: a quantized bucket's lookup and update are the JAX package's
    XLA forms, here torch operations on the card. Returns the launch
    counts by path."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        scaled_table_sizes)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, ClickGenerator, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.ops import sparse_update
    sizes = scaled_table_sizes(QUANT_CPU_SCALE)
    gen = ClickGenerator(sizes, 13, BATCH, seed=DLRM_SEED + 3)
    batches = [gen.batch(s) for s in range(QUANT_HELD_STEPS)]
    counts = {}
    runs = [("int8", None, QUANT_HELD_STEPS, LOSS_TOL),
            ("fp8", None, QUANT_FP8_STEPS, LOSS_TOL),
            ("int8", AMP_DTYPE, QUANT_BF16_STEPS, QUANT_BF16_LOSS_TOL)]
    for storage, compute, steps, tol in runs:
        t0 = time.perf_counter()
        label = f"quant_dlrm_{storage}" + ("" if compute is None
                                           else f"_{compute}")
        model = quantized_dlrm(torch, sizes, "cuda", storage, 3, compute)
        cpu_model = quantized_dlrm(torch, sizes, "cpu", storage, 3, compute)
        set_counts(cuda_lookup, *counted)
        held = quantized_held_run(torch, sparse_update, label, model,
                                  cpu_model, "sgd", batches[:steps], tol)
        torch.cuda.synchronize()
        counts[label] = read_counts(cuda_lookup, *counted)
        want = {"segment_sum_sorted": 1}
        check(counts[label] == per_step(want, steps),
              f"{label} launches {counts[label]}, want {want} per step")
        emit(phase="main_path", path=label, steps=steps,
             seconds=time.perf_counter() - t0, rows=sum(sizes),
             storage_dtype=storage, compute_dtype=compute or "float32",
             payload_bytes=sum(t.numel() * t.element_size()
                               for t in model.embedding.tp),
             scale_bytes=sum(t.numel() * 4
                             for t in model.embedding.tp_scale),
             launches=counts[label], losses=held["losses"],
             cpu_losses=held["cpu_losses"], rows_held=held["rows"],
             elements_held=held["elements"],
             decode_gather_bit_equal=True,
             decoded_elements_held=held["decoded_elements"],
             outputs_bit_equal=held["outputs_bit_equal"],
             updates_bit_equal=True, ok=True)
        del model, cpu_model, held
        torch.cuda.empty_cache()
    # adagrad on cut Tiny, int8
    t0 = time.perf_counter()
    tiny = SYNTHETIC_MODELS["tiny"]
    cut = tiny._replace(embedding_configs=[
        e._replace(num_rows=min(e.num_rows, CUT_ROWS))
        for e in tiny.embedding_configs])
    tiny_batches = list(InputGenerator(cut, BATCH, alpha=1.05,
                                       num_batches=QUANT_HELD_STEPS, seed=0))
    tiny_batches = [(n.numpy(), [c.numpy() for c in cs], lab.numpy())
                    for n, cs, lab in tiny_batches]
    model = SyntheticModel(cut, device="cuda", storage_dtype="int8",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
    cpu_model = SyntheticModel(cut, device="cpu", storage_dtype="int8")
    label = "quant_tiny_adagrad_int8"
    set_counts(cuda_lookup, *counted)
    held = quantized_held_run(torch, sparse_update, label, model,
                              cpu_model, "adagrad", tiny_batches)
    torch.cuda.synchronize()
    counts[label] = read_counts(cuda_lookup, *counted)
    want = {"segment_sum_sorted": len(model.embedding.tp)}
    check(counts[label] == per_step(want, QUANT_HELD_STEPS),
          f"{label} launches {counts[label]}, want {want} per step")
    emit(phase="main_path", path=label, steps=QUANT_HELD_STEPS,
         seconds=time.perf_counter() - t0, storage_dtype="int8",
         buckets=[list(t.shape) for t in model.embedding.tp],
         launches=counts[label], losses=held["losses"],
         cpu_losses=held["cpu_losses"], rows_held=held["rows"],
         elements_held=held["elements"],
         decode_gather_bit_equal=True,
         decoded_elements_held=held["decoded_elements"],
         outputs_bit_equal=held["outputs_bit_equal"],
         outputs_max_abs_err=held["outputs_max_abs_err"],
         updates_bit_equal=True, ok=True)
    del model, cpu_model, held
    torch.cuda.empty_cache()
    return counts


def quantized_full_phase(torch, cuda_lookup, counted):
    """12b: DLRM at the example's widths at the MLPerf Criteo-1TB sizes
    (187.8M rows x 128) stored int8 on one card, through `fit` (sgd at the
    example's schedule, batch 65,536, a seeded ClickGenerator stream read
    from a split-binary dataset, pipelined), 22 steps: step times (the
    first 2 and the 2 under the profiler left out), samples/s, one
    profiled step (idle share, device ms by category and of the quantized
    lookup's and update's ranges, one call each), peak memory beside the byte reckoning; the on-card
    AUC against `auc_exact`; a 65,536-row request through
    `InferenceEngine`; one more step's update (from fit's state) held bit
    for bit against the CPU plain function on its touched rows; then those
    rows published
    as an int8 row delta (`utils.checkpoint.save_row_delta`), its bytes
    against `ops.wire.delta_row_bytes`, reloaded verified bit for bit, and
    one flipped byte refused. Returns (launch counts by path, a summary)."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        make_lr_schedule, scaled_table_sizes)
    from distributed_embeddings_tpu_torch.ops import sparse_update, wire
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.training import (
        fit, make_sparse_train_step)
    from distributed_embeddings_tpu_torch.utils import checkpoint
    sizes = scaled_table_sizes(QUANT_FULL_SCALE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_quant")
    emit(phase="disk", path=tempfile.gettempdir(),
         **shutil.disk_usage(tmp)._asdict())
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = quantized_dlrm(torch, sizes, "cuda", "int8", DLRM_SEED)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        layer = model.embedding
        payload = sum(t.numel() * t.element_size() for t in layer.tp)
        scales = sum(t.numel() * 4 for t in layer.tp_scale)
        emit(phase="model", config="dlrm_criteo_int8", rows=sum(sizes),
             build_s=build_s, payload_bytes=payload, scale_bytes=scales,
             memory_allocated=torch.cuda.memory_allocated())
        dataset = shared_dataset(sizes, QUANT_FULL_STEPS)
        train, test = dataset(False), dataset(True)
        window = StepWindow(torch, QUANT_PROFILED_STEP)
        set_counts(cuda_lookup, *counted)
        t0 = time.perf_counter()
        _, opt_state, hist = fit(model, train.raw_batches(QUANT_FULL_STEPS),
                                 QUANT_FULL_STEPS, "sgd",
                                 lr=make_lr_schedule(*DLRM_LR),
                                 preprocess=train.preprocess,
                                 pipelined=True, log_every=0,
                                 callbacks=[window])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = {"quant_dlrm_full": read_counts(cuda_lookup, *counted)}
        want = {"segment_sum_sorted": QUANT_FULL_STEPS}
        check(counts["quant_dlrm_full"] == per_step(want, 1),
              f"quant_dlrm_full launches {counts['quant_dlrm_full']}, "
              f"want {want}")
        check(all(map(math.isfinite, hist["loss"])),
              f"quant_dlrm_full: non-finite losses {hist['loss']}")
        peak = torch.cuda.max_memory_allocated()
        step_ms = window.step_ms()
        med = statistics.median(step_ms)
        profiled = window.profile()
        profiled.update({name: window.range_ms(name)
                         for name in (QUANT_LOOKUP_RANGE,
                                      QUANT_UPDATE_RANGE)})
        for name in (QUANT_LOOKUP_RANGE, QUANT_UPDATE_RANGE):
            check(profiled[name]["calls"] == 1
                  and profiled[name]["device_ms"] > 0,
                  f"quant_dlrm_full: the profiled step's {name} range: "
                  f"{profiled[name]}, want 1 call with device ms > 0")
        card_auc = dlrm_card_auc(torch, model, test)
        # serving
        engine = InferenceEngine(model, device="cuda")
        num, cats, _ = test[0]
        serve_ms = serve_latency_ms(torch, engine, (num, cats))
        logits = engine.predict((num, cats))
        check(tuple(logits.shape) == (BATCH, 1)
              and bool(torch.isfinite(logits).all()),
              "quant_dlrm_full: the engine's logits")
        del engine, logits
        # one more step, from fit's state (the schedule's lr past 0), its
        # update held on the touched rows
        _, step = make_sparse_train_step(
            model, "sgd", lr=make_lr_schedule(*DLRM_LR))
        with QuantCapture(torch, sparse_update) as cap:
            num, cats, labels = DeviceStager("cuda")(train[0])
            step(model, opt_state, num, list(cats), labels)
            torch.cuda.synchronize()
        rows_held, elements_held = hold_quantized(
            torch, sparse_update, cap.calls, "quant_dlrm_full")
        call = cap.calls[0]
        del cap
        # the touched rows published as an int8 row delta
        keys = call["uniq"].numpy().astype("int64")
        arrays = {"tp0_keys": keys,
                  "tp0_rows": call["after"]["payload"].view(
                      torch.int8).numpy(),
                  "tp0_scale": call["after"]["scale"].numpy()}
        meta = {"version": 1, "base_version": 0, "kind": "delta",
                "published_at": time.time(),
                "sig": [[v, 128] for v in sizes], "dtype": "int8"}
        t0 = time.perf_counter()
        written = checkpoint.save_row_delta(
            os.path.join(tmp, "delta_1.tmp"), meta, arrays)
        path = checkpoint.publish_atomic(written,
                                         os.path.join(tmp, "delta_1.npz"))
        publish_s = time.perf_counter() - t0
        row_bytes = sum(a.nbytes for a in arrays.values())
        want_bytes = len(keys) * wire.delta_row_bytes(128, "int8")
        check(row_bytes == want_bytes,
              f"the delta's rows take {row_bytes} bytes, the byte model "
              f"{want_bytes}")
        got_meta, got = checkpoint.load_row_delta(path)
        same = (got_meta["dtype"] == "int8" and all(
            got[k].dtype == a.dtype and got[k].tobytes() == a.tobytes()
            for k, a in arrays.items()))
        check(same, "the reloaded row delta differs from the published one")
        data = bytearray(open(path, "rb").read())
        at = bytes(data).index(arrays["tp0_rows"][:64].tobytes()) + 7
        data[at] ^= 0x10
        bad = os.path.join(tmp, "delta_bad.npz")
        with open(bad, "wb") as f:
            f.write(bytes(data))
        try:
            checkpoint.load_row_delta(bad)
            refused = False
        except checkpoint.StreamIntegrityError:
            refused = True
        check(refused, "a flipped byte of a row delta was not refused")
        f32_rows_per_gb = (sum(scaled_table_sizes(DLRM_TABLE_SCALE))
                           / (sum(scaled_table_sizes(DLRM_TABLE_SCALE))
                              * 128 * 4 / 1e9))
        summary = dict(
            median_step_ms=med, samples_per_s=BATCH / (med / 1e3),
            max_memory_allocated=peak, payload_bytes=payload,
            scale_bytes=scales, card_auc=card_auc, serve_ms=serve_ms)
        emit(phase="main_path", path="quant_dlrm_full",
             steps=QUANT_FULL_STEPS, rows=sum(sizes), storage_dtype="int8",
             build_s=build_s, fit_s=fit_s, launches=counts[
                 "quant_dlrm_full"], losses=hist["loss"],
             median_step_ms=med, samples_per_s=BATCH / (med / 1e3),
             step_ms=step_ms, max_memory_allocated=peak,
             table_bytes_reckoned=payload + scales,
             other_memory_at_peak=peak - payload - scales,
             rows_per_gb=sum(sizes) / ((payload + scales) / 1e9),
             f32_x0_4_rows_per_gb=f32_rows_per_gb,
             ingest_stage_mean_ms={k: v["mean_ms"] for k, v in
                                   hist["ingest_stages"].items()},
             profiled_step=profiled, card_auc=card_auc,
             serve_rows=BATCH, serve_ms=serve_ms,
             held_update_rows=rows_held, held_update_elements=elements_held,
             delta_rows=len(keys), delta_row_bytes=row_bytes,
             delta_file_bytes=os.path.getsize(path), delta_publish_s=
             publish_s, delta_reloaded_bit_equal=same,
             delta_flipped_byte_refused=refused, ok=True)
        del model, train, test, call, arrays, got, opt_state
        torch.cuda.empty_cache()
        return counts, summary
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def resume_run(torch, label, build, kind, batches, tmp):
    """Resume on the card: a model from `build(seed)` trained
    RESUME_STEPS steps, checkpointed (`utils.checkpoint.save_checkpoint`),
    trained RESUME_STEPS more; a fresh `build` restored from the save and
    trained the same steps: every table, scale and state tensor bit-equal
    to the uninterrupted run's. Returns what it printed."""
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager)
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    from distributed_embeddings_tpu_torch.utils import checkpoint
    stage = DeviceStager("cuda")

    def train(model, step, state, part):
        for batch in part:
            num, cats, labels = stage(batch)
            _, state, _ = step(model, state, num, list(cats), labels)
        return state
    t0 = time.perf_counter()
    model = build(0)
    init, step = make_sparse_train_step(model, kind, lr=TRAIN_LR)
    state = train(model, step, init(model), batches[:RESUME_STEPS])
    root = os.path.join(tmp, label)
    t1 = time.perf_counter()
    checkpoint.save_checkpoint(root, {"params": model.state_dict(),
                                      "opt_state": state},
                               step=RESUME_STEPS)
    save_s = time.perf_counter() - t1
    state = train(model, step, state, batches[RESUME_STEPS:])
    fresh = build(1)
    init2, step2 = make_sparse_train_step(fresh, kind, lr=TRAIN_LR)
    t1 = time.perf_counter()
    restored = checkpoint.restore_checkpoint(
        root, {"params": fresh.state_dict(), "opt_state": init2(fresh)},
        step=RESUME_STEPS)
    restore_s = time.perf_counter() - t1
    state2 = train(fresh, step2, restored["opt_state"],
                   batches[RESUME_STEPS:])
    torch.cuda.synchronize()
    a = tree_tensors(torch, fresh.state_dict()) + tree_tensors(torch,
                                                               state2)
    b = tree_tensors(torch, model.state_dict()) + tree_tensors(torch, state)
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    keys = checkpoint.checkpoint_keys(root, step=RESUME_STEPS)
    files = sorted(os.listdir(os.path.join(root, f"step_{RESUME_STEPS}")))
    out = dict(phase="resume", path=label, kind=kind,
               seconds=time.perf_counter() - t0, save_s=save_s,
               restore_s=restore_s, tensors=len(a),
               checkpoint_bytes=sum(os.path.getsize(os.path.join(
                   root, f"step_{RESUME_STEPS}", f)) for f in files),
               files=files, keys=keys, bit_equal=same)
    emit(**out)
    check(same, f"{label}: the resumed run differs from the uninterrupted "
                "one")
    check(keys == ["opt_state", "params"], f"{label}: checkpoint keys {keys}")
    shutil.rmtree(root, ignore_errors=True)
    return model


def checkpoint_phase(torch, cuda_lookup, counted):
    """12c: resume on the card (`resume_run`) of DLRM at Criteo sizes x
    0.02, float32 sgd and int8 sgd, and of Tiny cut to 100,000 rows a
    table, int8 adagrad; then the float32 model's global weights through
    `save_global_weights` (a directory of .npy files), `load_global_weights`
    (memory-mapped) and `set_weights` of a fresh model: every table bit
    for bit (`table_digest`). Returns the launch counts by path."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        scaled_table_sizes)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, ClickGenerator, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.utils import checkpoint
    sizes = scaled_table_sizes(QUANT_CPU_SCALE)
    gen = ClickGenerator(sizes, 13, BATCH, seed=DLRM_SEED + 4)
    batches = [gen.batch(s) for s in range(2 * RESUME_STEPS)]
    tiny = SYNTHETIC_MODELS["tiny"]
    cut = tiny._replace(embedding_configs=[
        e._replace(num_rows=min(e.num_rows, CUT_ROWS))
        for e in tiny.embedding_configs])
    tiny_batches = [(n.numpy(), [c.numpy() for c in cs], lab.numpy())
                    for n, cs, lab in InputGenerator(
                        cut, BATCH, alpha=1.05,
                        num_batches=2 * RESUME_STEPS, seed=1)]
    runs = (
        ("resume_dlrm_f32", lambda seed: quantized_dlrm(
            torch, sizes, "cuda", None, 20 + seed), "sgd", batches,
         {"lookup_combine": 1, "segment_sum_sorted": 1, "sgd_rows": 1}),
        ("resume_dlrm_int8", lambda seed: quantized_dlrm(
            torch, sizes, "cuda", "int8", 20 + seed), "sgd", batches,
         {"segment_sum_sorted": 1}),
        ("resume_tiny_adagrad_int8", lambda seed: SyntheticModel(
            cut, device="cuda", storage_dtype="int8",
            generator=torch.Generator(device="cuda").manual_seed(seed)),
         "adagrad", tiny_batches, {"segment_sum_sorted": 2}))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt")
    counts = {}
    try:
        for label, build, kind, data, want in runs:
            set_counts(cuda_lookup, *counted)
            model = resume_run(torch, label, build, kind, data, tmp)
            torch.cuda.synchronize()
            counts[label] = read_counts(cuda_lookup, *counted)
            # the uninterrupted run, then the resumed one's steps
            steps = 3 * RESUME_STEPS
            check(counts[label] == per_step(want, steps),
                  f"{label} launches {counts[label]}, want {want} per step")
            if label != "resume_dlrm_f32":
                del model
                torch.cuda.empty_cache()
                continue
            # the portable global weights of the float32 model
            t0 = time.perf_counter()
            weights = model.embedding.get_weights()
            out = checkpoint.save_global_weights(
                os.path.join(tmp, "global"), weights, npz=False)
            loaded = checkpoint.load_global_weights(out, mmap=True)
            mapped = all(type(a).__name__ == "memmap" for a in loaded)
            fresh = quantized_dlrm(torch, sizes, "cuda", None, 30)
            fresh.embedding.set_weights(loaded)
            same = ([table_digest(torch, t) for t in fresh.embedding.tp]
                    == [table_digest(torch, t) for t in model.embedding.tp])
            emit(phase="global_weights", path=label, tables=len(weights),
                 bytes=sum(w.nbytes for w in weights), memory_mapped=mapped,
                 seconds=time.perf_counter() - t0, bit_equal=same)
            check(same and mapped, "the global weights did not round-trip "
                                   "bit for bit through memory-mapped files")
            del model, fresh, weights, loaded
            shutil.rmtree(out, ignore_errors=True)
            torch.cuda.empty_cache()
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------ 13. wire formats and hot rows
HOT_ROWS = 16384              # the hot shard's capacity a bucket
HOT_WIRE = "bf16-sr"          # 13b's exchange wire
HOT_FIT_STEPS = 4
HOT_SYNC_EVERY = 2
# one rounding of a term on 13b's wire: the forward's round to nearest
# (2^-9 of it) and the gradient's stochastic rounding (a step, 2^-7 at
# most), with room
WIRE_TERM_EPS = 2.0 ** -7 + 2.0 ** -8
WIRE_PLACEMENT = "bf16"       # 13c's exchange wire


def hot_ranges():
    """The layer's profiler ranges of the hot split, gather and update."""
    from distributed_embeddings_tpu_torch.layers import dist_model_parallel
    return (dist_model_parallel.HOT_SPLIT_RANGE,
            dist_model_parallel.HOT_GATHER_RANGE,
            dist_model_parallel.HOT_UPDATE_RANGE)


def hot_tiny_phase(torch, cuda_lookup, cuda_sparse, counted):
    """Phase 13a: full-size Tiny V3 with ``hot_rows=HOT_ROWS`` at world 1,
    adagrad. One observed step (the hot sets empty), then
    ``sync_hot_rows(admit=True)``, then TRAIN_STEPS steps held against a
    CPU hot trainer from the card's state (`train_against_cpu` with the
    hot shards: the canonical touched rows as phase 5 holds them, the hot
    rows and their accumulators by change at their sums' conditioning);
    launches 4 / 1 / 1 a step (the miss lookups' weighted
    `lookup_combine`, bucket 1's segment sum and `adagrad_rows`; bucket 0
    dense, the hot update torch operations); the hit rate by bucket on
    the first held batch, and the host ms of observing one batch
    (`observe_hot_ids`) and of the admission. Then the step timed beside
    a hot-less Tiny step, one step profiled (`warm_window`: the card's
    idle share, device ms of the split, the hot gather and the hot
    update), `fit(hot_sync_every=HOT_SYNC_EVERY)` for HOT_FIT_STEPS steps,
    and one request of BATCH rows through `InferenceEngine` held against
    the CPU engine on the synced weights. Returns the launch counts by
    path."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.training import (
        fit, make_sparse_train_step)
    tiny = SYNTHETIC_MODELS["tiny"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batches = list(InputGenerator(tiny, BATCH, alpha=1.05,
                                  num_batches=1 + TRAIN_STEPS, seed=0))
    model = SyntheticModel(tiny, device="cuda", hot_rows=HOT_ROWS,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
    layer = model.embedding
    init, step = make_sparse_train_step(model, "adagrad", lr=TRAIN_LR)
    state = init(model)
    check(layer._hot_buckets == list(range(len(layer.tp))),
          f"hot_tiny: hot buckets {layer._hot_buckets}")
    emit(phase="hot_setup", path="train_hot", seconds=time.perf_counter()
         - t0, hot_rows=[layer.plan.tp_buckets[b].hot_rows
                         for b in layer._hot_buckets])
    # one observed step, the hot sets empty; then the admission
    t0 = time.perf_counter()
    layer.observe_hot_ids(batches[0][1])
    host_ms = {"observe": (time.perf_counter() - t0) * 1e3}
    _, state, _ = step(model, state, *batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state["emb"] = layer.sync_hot_rows(state["emb"], admit=True)
    torch.cuda.synchronize()
    host_ms["admit"] = (time.perf_counter() - t0) * 1e3
    resident = {b: s["resident"] for b, s in layer.hot_stats().items()}
    check(all(n == layer.plan.tp_buckets[b].hot_rows
              for b, n in resident.items()),
          f"hot_tiny: residents {resident} after the admission")
    # the first held batch's ids observed against the resident sets: the
    # hit rate the steps see
    t0 = time.perf_counter()
    layer.observe_hot_ids(batches[1][1])
    host_ms["observe_resident"] = (time.perf_counter() - t0) * 1e3
    stats = layer.hot_stats()

    # the main path: counts to 0, drive, read; each step held
    t0 = time.perf_counter()
    cpu_model = SyntheticModel(tiny, device="cpu", hot_rows=HOT_ROWS,
                               generator=torch.Generator().manual_seed(0))
    _, cpu_step = make_sparse_train_step(cpu_model, "adagrad", lr=TRAIN_LR)
    host_ms["cpu_model"] = (time.perf_counter() - t0) * 1e3
    set_counts(cuda_lookup, *counted)
    state, held = train_against_cpu(
        torch, rows_capture(cuda_sparse, "adagrad"), "adagrad", "change",
        step, model, state, cpu_step, cpu_model, batches[1:],
        scaled="dense", hot=True)
    torch.cuda.synchronize()
    counts = {"train_hot": read_counts(cuda_lookup, *counted)}
    want = {"lookup_combine": 4, "segment_sum_sorted": 1, "adagrad_rows": 1}
    check(counts["train_hot"] == per_step(want, TRAIN_STEPS),
          f"train_hot launches {counts['train_hot']}, want {want} per step")
    emit(phase="main_path", path="train_hot", steps=TRAIN_STEPS,
         seconds=time.perf_counter() - t0, launches=counts["train_hot"],
         losses=held["losses"], cpu_losses=held["cpu_losses"],
         max_abs_err=held["max_abs_err"], hot_max_abs_err=held["hot_err"],
         table_change_median=held["changes"].median().item(),
         table_change_max=held["changes"].max().item(),
         table_changes_past_rounding=held["moved"],
         relu_flips=held["relu_flips"], ok=True)
    emit(phase="hot_stats", path="train_hot", hot_rows=HOT_ROWS,
         hit_rate={b: s["hit_rate"] for b, s in stats.items()},
         stats=stats, host_ms=host_ms)
    del held

    # the step beside a hot-less one (the same weights), then a profile
    torch.cuda.reset_peak_memory_stats()
    state = step_time(torch, step, model, state, batches[1:], "train_hot")
    plain = SyntheticModel(tiny, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
    p_init, p_step = make_sparse_train_step(plain, "adagrad", lr=TRAIN_LR)
    step_time(torch, p_step, plain, p_init(plain), batches[1:],
              "train_hotless")
    del plain, p_init, p_step
    torch.cuda.empty_cache()
    holder = {"state": state}
    del state

    def step_once():
        holder["state"] = step(model, holder["state"], *batches[1])[1]
    window = warm_window(torch, step_once)
    ranges = {n: window.range_ms(n) for n in hot_ranges()}
    emit(phase="hot_profile", path="train_hot", ranges=ranges,
         **window.profile())
    for name, r in ranges.items():
        check(r["calls"] > 0 and r["device_ms"] > 0,
              f"train_hot: the profiled step's {name} range: {r}, want "
              "calls with device ms")
    del window

    # fit with the hot cadence: observe, admit every HOT_SYNC_EVERY steps
    set_counts(cuda_lookup, *counted)
    t0 = time.perf_counter()
    _, state, hist = fit(model, lambda s: batches[1 + s % TRAIN_STEPS],
                         HOT_FIT_STEPS, "adagrad", lr=TRAIN_LR,
                         opt_state=holder["state"], log_every=0,
                         hot_sync_every=HOT_SYNC_EVERY)
    torch.cuda.synchronize()
    del holder
    counts["train_hot_fit"] = read_counts(cuda_lookup, *counted)
    check(counts["train_hot_fit"] == per_step(want, HOT_FIT_STEPS),
          f"train_hot_fit launches {counts['train_hot_fit']}, want {want} "
          "per step")
    check(all(map(math.isfinite, hist["loss"])),
          f"train_hot_fit: losses {hist['loss']}")
    emit(phase="main_path", path="train_hot_fit", steps=HOT_FIT_STEPS,
         seconds=time.perf_counter() - t0, launches=counts["train_hot_fit"],
         losses=hist["loss"], hot_sync_every=HOT_SYNC_EVERY,
         hot_stats=hist["hot_stats"],
         max_memory_allocated=torch.cuda.max_memory_allocated(), ok=True)
    # the synced weights served: the card's engine against the CPU's
    num, cats, _ = batches[1]
    engine = InferenceEngine(model, device="cuda")
    set_counts(cuda_lookup, *counted)
    got = engine.predict((num, cats)).cpu()
    torch.cuda.synchronize()
    counts["serve_hot"] = read_counts(cuda_lookup, *counted)
    check(counts["serve_hot"] == per_step({"lookup_combine": 4}, 1),
          f"serve_hot launches {counts['serve_hot']}, want 4 lookups")
    cpu_model.load_state_dict(model.state_dict())
    want_logits = InferenceEngine(cpu_model, device="cpu").predict(
        (num, cats))
    err = (got - want_logits).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want_logits, **SLICE_TOL)
    emit(phase="hot_serve", path="serve_hot", rows=BATCH, max_abs_err=err,
         ok=ok)
    check(ok, f"serve_hot: the engine disagrees with the CPU's by {err}")
    del model, cpu_model, engine, layer, state
    torch.cuda.empty_cache()
    return counts


def hot_wire_probe(torch, dev, rank, world):
    """13b's probes of the wired collectives on CUDA tensors over the
    process group: the bf16 all_to_all equals the bf16 cast of the float32
    one bit for bit; the compressed reduce-scatter equals the rank-order
    sum of the bf16-rounded blocks; stochastic rounding on the card is
    bit-equal to its plain version on a CPU copy; int16 ids round-trip
    through their bytes, clipped values included. Returns {probe: ok}."""
    from distributed_embeddings_tpu_torch.ops import wire
    from distributed_embeddings_tpu_torch.parallel.mesh import gather_stack
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    out = {}
    x = torch.randn((world, 64, 16), generator=gen, device=dev) * 3.0
    out["all_to_all_bf16"] = torch.equal(
        wire.wire_all_to_all(x, "bf16"),
        wire.wire_all_to_all(x, "f32").to(torch.bfloat16).float())
    y = torch.randn((world * 32, 16), generator=gen, device=dev)
    blocks = gather_stack(y).to(torch.bfloat16).float()[
        :, rank * 32:(rank + 1) * 32]
    want = blocks[0]
    for r in range(1, world):
        want = want + blocks[r]
    out["reduce_scatter_bf16"] = torch.equal(
        wire.wire_psum_scatter(y, "bf16"), want)
    z = torch.randn((world, 1000, 24), generator=gen, device=dev) * 2.0 ** 6
    out["stochastic_round"] = torch.equal(
        wire.stochastic_round_bf16(z).view(torch.int16).cpu(),
        wire.stochastic_round_bf16(z.cpu()).view(torch.int16))
    ids = torch.randint(-40000, 40000, (world, 8, 3), generator=gen,
                        device=dev, dtype=torch.int32)
    ids[:, 0, 0] = -70000
    ids[:, 1, 1] = 32767
    got = wire.wire_id_all_to_all(ids, "int16")
    sent = gather_stack(ids)[:, rank]
    out["ids_int16"] = torch.equal(got, sent.clamp(-2**15, 2**15 - 1))
    torch.cuda.synchronize()
    return out


def admitted_rows(layer) -> dict:
    """The layer's hot-resident rows as {global table id: sorted rows}
    (each key's table and row in its plan, `_hot_key_rows`; a
    column-sliced table's rows once)."""
    out: dict = {}
    for b, (keys, _) in layer.hot_resident_rows().items():
        for gtid, _, _, rows in layer._hot_key_rows(b, keys):
            out.setdefault(gtid, set()).update(rows.tolist())
    return {g: sorted(r) for g, r in out.items()}


def hot_shard_rows(torch, layer, state, extra=()) -> dict:
    """Each hot-resident row by (global table id, row), on the CPU:
    {gtid: (rows, values [n, w], accumulators [n, w], *extra)}, each of
    `extra` a per-hot-bucket tensor over the shard's positions sliced
    alike (a table's rows in one bucket: Tiny slices no columns)."""
    out: dict = {}
    for i, b in enumerate(layer._hot_buckets):
        ids, rows = layer._hot_entry(b)
        parts = [rows.detach().cpu(), state["emb"]["hot"][i][0].cpu()] + [
            x[i].cpu() for x in extra]
        for gtid, _, m, local in layer._hot_key_rows(b, ids.long().cpu()):
            check(gtid not in out, f"table {gtid} is column-sliced")
            out[gtid] = (local, *[x[m] for x in parts])
    return out


def hot_scale(torch, layer, scale) -> list:
    """Per hot bucket, t/|g| of its shard from `gradient_scale` (0
    without terms, infinite where they cancel exactly), on the CPU."""
    out = []
    for b in layer._hot_buckets:
        g, t = scale[f"embedding.hot.{b}"]
        out.append(torch.where(t > 0, t / g.abs(), torch.zeros_like(t))
                   .cpu())
    return out


def hot_counts(torch, calls) -> list:
    """Per hot update of a step (the `_dense_sum` calls of the layer's hot
    update, one per hot bucket in bucket order: ids, contributions, rows),
    how many contributions each row of the shard took, on the CPU."""
    from distributed_embeddings_tpu_torch.ops.sparse_update import _dense_sum
    return [_dense_sum(*c[:3])[1].cpu() for c in calls]


def hot_eps(torch, n, term_eps=0.0):
    """`hold`'s eps for hot rows summed from n contributions each by the
    card's atomics: SUM_EPS + (n - 1) 2^-24, plus `term_eps`, [rows, 1]."""
    return (SUM_EPS + term_eps + (n.double() - 1).clamp_min(0)
            * 2.0 ** -24)[:, None]


def hot_wire_rank(torch, rank, world, dev):
    """Rank `rank`'s part of phase 13b (`wire_rank`): the wired
    collectives probed on CUDA tensors (`hot_wire_probe`); full-width Tiny
    with ``hot_rows=HOT_ROWS`` and ``exchange_wire=HOT_WIRE``, tables and
    MLP from `seed_weights`; one observed step on its slice of batch 0
    (the hot sets empty), ``sync_hot_rows(admit=True)`` (rank 0's keys on
    every rank), then TRAIN_STEPS adagrad steps over its slices (launches
    counted, each collective's calls, bytes and dtypes recorded by
    `wire_payloads`), its MLP and dense state before each, its touched
    rows, its hot rows and their accumulators before and after, and the
    hot ranges' and the stochastic rounding's device ms in a profiled
    step. Returns the rank's results."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.ops import (cuda_lookup, cuda_sparse,
                                                      cuda_tiled,
                                                      sparse_update, wire)
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager, dp_slice, stage_dp_batch)
    from distributed_embeddings_tpu_torch.tools import cuda_feature_probe
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    out = {"rank": rank, "device": str(dev)}
    out["probe"] = hot_wire_probe(torch, dev, rank, world)
    check(all(out["probe"].values()),
          f"rank {rank}: wired collectives {out['probe']}")
    tiny = SYNTHETIC_MODELS["tiny"]
    global_batches = list(InputGenerator(tiny, BATCH, alpha=1.05,
                                         num_batches=1 + TRAIN_STEPS,
                                         seed=0))
    stager = DeviceStager(dev)
    batches = [stage_dp_batch(b, stager) for b in global_batches]
    model = SyntheticModel(tiny, device=dev, hot_rows=HOT_ROWS,
                           exchange_wire=HOT_WIRE,
                           generator=torch.Generator(device=dev)
                           .manual_seed(rank))
    seed_weights(torch, model, WORLD_SEED)
    layer = model.embedding
    out["wires"] = [(b.wire_dtype, b.id_wire_dtype)
                    for b in layer.plan.tp_buckets]
    init, step = make_sparse_train_step(model, "adagrad", lr=TRAIN_LR)
    state = init(model)
    layer.observe_hot_ids(dp_slice(global_batches[0][1]))
    _, state, loss0 = step(model, state, *batches[0])
    state["emb"] = layer.sync_hot_rows(state["emb"], admit=True)
    out["loss0"] = float(loss0)
    out["admitted"] = admitted_rows(layer)
    out["hot_before"] = hot_shard_rows(torch, layer, state)
    counted = (cuda_sparse, cuda_tiled, cuda_feature_probe)
    capture = rows_capture(cuda_sparse, "adagrad")
    set_counts(cuda_lookup, *counted)
    losses, touched, dense_before = [], {}, []
    with wire_payloads(torch) as payloads:
        for batch in batches[1:]:
            dense_before.append(to_cpu(torch, (
                {n: p for n, p in model.named_parameters()
                 if p.requires_grad}, state["dense"])))
            state, loss, step_rows, _ = run_trainer(
                step, model, state, [batch], capture)
            losses += loss
            for ptr, parts in step_rows.items():
                touched.setdefault(ptr, []).extend(parts)
    torch.cuda.synchronize()
    out["launches"] = read_counts(cuda_lookup, *counted)
    out["losses"] = losses
    out["dense_before"] = dense_before
    out["wire"] = {k: dict(v, calls=v["calls"] / TRAIN_STEPS,
                           bytes=v["bytes"] / TRAIN_STEPS)
                   for k, v in payloads.items()}
    key = tuple((c.shape[1], False) for c in batches[0][1])
    groups, _ = layer._exchange_groups_for_key(key)
    out["groups"] = len(groups)
    out["sort_buckets"] = sum(
        sparse_update._pick("auto", *layer.tp[b].shape) != "dense"
        for b in {g.bucket for g in groups})
    # the ids a step sends: per group its [world, B_l, f_max, k] block
    # at the id wire's bytes (the groups are unweighted: no weights)
    out["id_bytes"] = sum(BATCH * g.f_max * g.k * wire_id_itemsize(
        torch, layer, g.bucket) for g in groups)
    out["id_bytes_int32"] = sum(BATCH * g.f_max * g.k for g in groups
                                ) * 4
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
    out["hot"] = hot_shard_rows(torch, layer, state)
    out["mlp"] = {n: p.detach().cpu().clone() for n, p in
                  model.named_parameters() if p.requires_grad}
    holder = {"state": state}
    del state

    def step_once():
        holder["state"] = step(model, holder["state"], *batches[1])[1]
    window = warm_window(torch, step_once)
    out["window_us"], out["device_intervals_us"] = (
        window.unix_intervals())
    prof = window.profile()
    out["profile"] = dict(
        wall_ms=prof["wall_ms"],
        rank_device_busy_ms=prof["device_busy_ms"],
        ranges={n: window.range_ms(n)
                for n in hot_ranges() + (wire.SR_RANGE,)})
    del window
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


def wire_id_itemsize(torch, layer, b) -> int:
    """Bytes an id of bucket b crosses the id wire at: 2 on the int16 wire,
    else its id dtype's."""
    if layer.plan.tp_buckets[b].id_wire_dtype == "int16":
        return 2
    return torch.empty((), dtype=layer._id_dtype(b)).element_size()


def hot_wire_phase(torch, ranks, ranks_s):
    """Phase 13b: the ranks' `hot_wire_rank` results (`ranks`, from
    `wire_world_phase`'s spawn, which took `ranks_s` s), then the world-1
    hot trainer in
    this process (float32, no wire) with the same weights: the probes;
    the plan's wires; launches a rank step from its plan; step 0 from the
    same weights, then rank 0's admitted rows admitted here
    (`_hot_keys_of`), each held step from rank 0's MLP and dense state
    before it; the losses within one bfloat16 rounding (2^-8 relative);
    the ranks' admissions and hot rows the same; every touched row of the
    ranks' tables and accumulators (from their seeds, over all 1 +
    TRAIN_STEPS steps), and the hot rows and theirs (over the held steps),
    within rtol 1e-4 of the change plus an ulp a step plus how far one
    rounding of each term (WIRE_TERM_EPS, and SUM_EPS) can move the
    element, summed over the steps (`hold_bounded`: adagrad's change moves
    by lr eps t / sqrt(acc), its accumulator by 2 eps t |g|, with t and g
    from `gradient_scale` on world 1, twice for room); every float
    payload of the wire bfloat16; the bytes by
    collective beside float32's (the float bytes twice, the ids at
    4 bytes). Returns the ranks' launch counts, summed."""
    from distributed_embeddings_tpu_torch.layers import dist_model_parallel
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.ops import cuda_sparse
    from distributed_embeddings_tpu_torch.training import (
        SPARSE_HP, gradient_scale, make_sparse_train_step)
    world = 2
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    label = f"world{world}_hot_wire"
    emit(phase="world_setup", path=label, config="tiny", world=world,
         backend=backend, device_count=cards, hot_rows=HOT_ROWS,
         exchange_wire=HOT_WIRE)
    summed = dict.fromkeys(ALL_KERNELS, 0)
    for r in ranks:
        check(all(w == HOT_WIRE for w, _ in r["wires"]),
              f"{label}: rank {r['rank']} plans the wires {r['wires']}")
        want_r = {"lookup_combine": r["groups"],
                  "segment_sum_sorted": r["sort_buckets"],
                  "adagrad_rows": r["sort_buckets"]}
        check(r["launches"] == per_step(want_r, TRAIN_STEPS),
              f"{label}: rank {r['rank']} launches {r['launches']}, "
              f"want {want_r} per step")
        for k, v in r["launches"].items():
            summed[k] += v
        floats = {n: [d for d in v["dtypes"]
                      if d.startswith(("float", "bfloat"))]
                  for n, v in r["wire"].items() if n != "all_reduce"}
        check(all(d == ["bfloat16"] for d in floats.values() if d),
              f"{label}: rank {r['rank']}'s wire moved {floats}")
        check(r["admitted"] == ranks[0]["admitted"],
              f"{label}: rank {r['rank']} admitted other rows than "
              "rank 0")
        for gtid, (rows_r, vals, acc) in r["hot"].items():
            rows0, vals0, acc0 = ranks[0]["hot"][gtid]
            check(torch.equal(rows_r, rows0) and torch.equal(vals, vals0)
                  and torch.equal(acc, acc0),
                  f"{label}: rank {r['rank']}'s hot rows of table "
                  f"{gtid} differ from rank 0's")

    # the world-1 hot trainer: the same weights, no wire
    t0 = time.perf_counter()
    tiny = SYNTHETIC_MODELS["tiny"]
    batches = list(InputGenerator(tiny, BATCH, alpha=1.05,
                                  num_batches=1 + TRAIN_STEPS, seed=0))
    model = SyntheticModel(tiny, device="cuda", hot_rows=HOT_ROWS,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(0))
    seed_weights(torch, model, WORLD_SEED)
    layer = model.embedding
    strat = layer.strategy
    placed = {strat.table_groups[1][pl_.table_id]: pl_
              for pl_ in layer.plan.tp_placements}
    dense = {n: p for n, p in model.named_parameters()
             if p.requires_grad}
    init, step = make_sparse_train_step(model, "adagrad", lr=TRAIN_LR)
    state = init(model)
    capture = rows_capture(cuda_sparse, "adagrad")
    # per element, how far the wire can move it: each step's gradient
    # g carries up to eps t of error (t the sum of its terms'
    # magnitudes, `gradient_scale`), which moves adagrad's change by
    # lr eps t / sqrt(acc) and its accumulator by 2 eps t |g|, twice
    # for the room; summed over the steps (a sum of changes that cancel
    # does not hide a step's error)
    eps_ada = SPARSE_HP["adagrad"]["eps"]
    bound, hot_bound, hot_n, losses = {}, None, None, []

    def add_bound(key, g, t, acc, eps, into):
        step_b = (2 * eps * TRAIN_LR * t / torch.sqrt(acc + eps_ada),
                  2 * eps * t * (g.abs() + eps * t))
        if key not in into:
            into[key] = step_b
        else:
            into[key] = tuple(a + b for a, b in zip(into[key], step_b))
    for s, batch in enumerate(batches):
        if s:
            mlp_r, dense_state_r = ranks[0]["dense_before"][s - 1]
            with torch.no_grad():
                for n, p in dense.items():
                    p.copy_(mlp_r[n])
                for n, a in state["dense"]["sum_of_squares"].items():
                    a.copy_(dense_state_r["sum_of_squares"][n])
        scale = gradient_scale(model, *batch)
        with Capture(dist_model_parallel, "_dense_sum") as sums:
            state, loss, _, _ = run_trainer(step, model, state, [batch],
                                            capture)
        losses += loss
        eps = SUM_EPS + WIRE_TERM_EPS
        for r in ranks:
            for gtid, (idx, _, _) in r["tables"].items():
                pl_ = placed[gtid]
                g, t = scale[f"embedding.tp.{pl_.bucket}"]
                at = (idx + pl_.row_offset).cuda()
                acc = state["emb"]["tp"][pl_.bucket][0].index_select(
                    0, at)
                add_bound(gtid, g.index_select(0, at).double(),
                          t.index_select(0, at).double(), acc.double(),
                          eps, bound)
        if s:
            n = hot_counts(torch, sums.calls)
            hot_n = n if hot_n is None else [
                torch.maximum(a, b) for a, b in zip(hot_n, n)]
            step_hot = {}
            for i, b in enumerate(layer._hot_buckets):
                g, t = scale[f"embedding.hot.{b}"]
                e = hot_eps(torch, n[i], WIRE_TERM_EPS).to(g.device)
                add_bound(i, g.double(), t.double(),
                          state["emb"]["hot"][i][0].double(), e,
                          step_hot)
            hot_bound = step_hot if hot_bound is None else {
                i: tuple(a + b for a, b in zip(hot_bound[i], v))
                for i, v in step_hot.items()}
        else:
            state["emb"] = layer.sync_hot_rows(
                state["emb"], new_keys=layer._hot_keys_of(
                    ranks[0]["admitted"]))
            check(admitted_rows(layer) == ranks[0]["admitted"],
                  f"{label}: world 1 admitted other rows than the "
                  "ranks")
        del scale
    torch.cuda.synchronize()
    rank_losses = [ranks[0]["loss0"]] + ranks[0]["losses"]
    check(all(abs(a - b) <= 2.0 ** -8 * abs(b)
              for a, b in zip(rank_losses, losses)),
          f"{label}: losses {rank_losses}, world 1 {losses}")
    worst, held_rows, steps = 0.0, 0, 1 + TRAIN_STEPS
    for r in ranks:
        for gtid, (idx, vals, acc) in r["tables"].items():
            pl_ = placed[gtid]
            on_dev = (idx + pl_.row_offset).cuda()
            before = table_rows(torch, strat, gtid, WORLD_SEED,
                                "cuda").index_select(0, idx.cuda()).cpu()
            b_tab, b_acc = (x.cpu() for x in bound[gtid])
            worst = max(worst, hold_bounded(
                torch, f"{label}: table {gtid}", vals,
                layer.tp[pl_.bucket].detach().index_select(
                    0, on_dev).cpu(), before, steps, b_tab))
            hold_bounded(torch, f"{label}: table {gtid} accumulator",
                         acc, state["emb"]["tp"][pl_.bucket][0]
                         .index_select(0, on_dev).cpu(),
                         torch.full_like(acc, 0.1), steps, b_acc)
            held_rows += int(idx.numel())
    # the hot rows by (table, row), from rank 0's after the admission
    one = hot_shard_rows(torch, layer, state, (
        [hot_bound[i][0] for i in range(len(layer._hot_buckets))],
        [hot_bound[i][1] for i in range(len(layer._hot_buckets))]))
    hot_worst = 0.0
    for gtid, (rows_r, vals, acc) in ranks[0]["hot"].items():
        rows1, vals1, acc1, b_tab, b_acc = one[gtid]
        check(torch.equal(rows_r, rows1),
              f"{label}: table {gtid}: other hot rows in world 1")
        _, vals0, acc0 = ranks[0]["hot_before"][gtid]
        hot_worst = max(hot_worst, hold_bounded(
            torch, f"{label}: hot rows of table {gtid}", vals, vals1,
            vals0, TRAIN_STEPS, b_tab))
        hold_bounded(torch, f"{label}: hot accumulators of table "
                     f"{gtid}", acc, acc1, acc0, TRAIN_STEPS, b_acc)
    emit(phase="main_path", path=label, backend=backend, world=world,
         exchange_wire=HOT_WIRE, hot_rows=HOT_ROWS, steps=TRAIN_STEPS,
         ranks_seconds=ranks_s, world1_seconds=time.perf_counter() - t0,
         launches_by_rank=[r["launches"] for r in ranks],
         losses=rank_losses, world1_losses=losses, max_abs_err=worst,
         hot_max_abs_err=hot_worst, touched_rows_held=held_rows,
         hot_rows_held=sum(len(v[0]) for v in one.values()),
         probe=ranks[0]["probe"], ok=True)
    for r in ranks:
        # float32's bytes of the same step: every wire float at 4
        # bytes, the ids at their int32 width (the all-reduce is not
        # the wire's)
        a2a = r["wire"]["all_to_all_single"]["bytes"]
        f32 = {n: (v["bytes"] if n == "all_reduce" else 2 * v["bytes"])
               for n, v in r["wire"].items()}
        f32["all_to_all_single"] = (2 * (a2a - r["id_bytes"])
                                    + r["id_bytes_int32"])
        emit(phase="hot_wire_payloads", path=label, rank=r["rank"],
             step=r["wire"], id_bytes=r["id_bytes"],
             f32_bytes=f32, profile=r["profile"],
             max_memory_allocated=r["max_memory_allocated"])
    if backend == "gloo":
        emit(phase="world_card_profile", path=label, backend=backend,
             **card_profile(ranks))
    del model, layer, state
    torch.cuda.empty_cache()
    return summed


@contextlib.contextmanager
def collective_calls(torch):
    """Within the block, every call the wire's collectives make of
    `torch.distributed`, in order: (collective, input dtype, input
    bytes)."""
    import torch.distributed as dist
    names = ("all_to_all_single", "all_gather_into_tensor",
             "reduce_scatter_tensor")
    real = {n: getattr(dist, n) for n in names}
    seen = []

    def recording(name):
        def call(out, inp, *args, **kwargs):
            seen.append((name, str(inp.dtype).replace("torch.", ""),
                         inp.numel() * inp.element_size()))
            return real[name](out, inp, *args, **kwargs)
        return call
    for n in names:
        setattr(dist, n, recording(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(dist, n, real[n])


class WireLinear:
    """13c's model: the layer's outputs times fixed coefficients (one
    ``[B, w]`` array an input, this rank's slice), summed and averaged
    over the rank's rows: a loss whose tap gradients are the coefficients
    over the batch."""

    def __init__(self, torch, layer, coefs):
        from distributed_embeddings_tpu_torch.parallel.staging import dp_slice
        self.embedding = layer
        self.coefs = [c.to(layer.device) for c in dp_slice(
            [torch.from_numpy(c) for c in coefs])]

    def named_parameters(self):
        return self.embedding.named_parameters()

    def loss_fn(self, numerical, cats, labels, taps=None,
                return_residuals=False):
        outs, res = self.embedding(list(cats), taps=taps,
                                   return_residuals=True)
        loss = sum((o * c).sum() for o, c in zip(outs, self.coefs)) \
            / self.coefs[0].shape[0]
        return (loss, res) if return_residuals else loss


def wire_placement_layer(torch, device, seed, **extra):
    """13c's layer on `device`: DLRM x AMP_WORLD_SCALE's tables (Criteo
    sizes, width 128, one-hot) with combiner "sum" (DLRM's are
    passthroughs, which the planner keeps on the float32 wire, as the JAX
    package's does), AMP_WORLD_KW's thresholds (11e's plan), the one-hot
    gathers through lookup_combine, `extra` (the exchange wire); the
    tables drawn by `seed_tables` alike at every world size."""
    from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
        DistributedEmbedding)
    from distributed_embeddings_tpu_torch.layers.embedding import Embedding
    from distributed_embeddings_tpu_torch.models.dlrm import (
        dlrm_initializer, scaled_table_sizes)
    layer = DistributedEmbedding(
        [Embedding(v, 128, combiner="sum",
                   embeddings_initializer=dlrm_initializer(), device="meta")
         for v in scaled_table_sizes(AMP_WORLD_SCALE)], device=device,
        lookup_path="pallas", **AMP_WORLD_KW, **extra,
        generator=torch.Generator(device=device).manual_seed(seed))
    seed_tables(torch, layer, PLACEMENT_SEED)
    return layer


def wire_placement_batch(layer):
    """13c's global batch (a seeded ClickGenerator stream's first) and the
    loss's coefficients."""
    import numpy as np
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    sizes = [c["input_dim"] for c in layer.strategy.global_configs]
    num, cats, labels = ClickGenerator(sizes, 13, BATCH,
                                       seed=PLACEMENT_SEED).batch(0)
    rng = np.random.RandomState(PLACEMENT_SEED)
    coefs = [rng.randn(BATCH, 128).astype(np.float32) for _ in sizes]
    return (num, cats, labels), coefs


def wire_placement_rank(torch, rank, world, dev, out_dir):
    """Rank `rank`'s part of phase 13c (`wire_rank`):
    `wire_placement_layer` with ``exchange_wire=WIRE_PLACEMENT``, its plan
    and wires; the outputs of its slice of the batch; one sgd step of
    `WireLinear` (launches counted; every collective call's dtype and
    bytes, `collective_calls`, beside the ids each should send by the
    plan: per tp group its [world, B_l, f_max, k] block, per row input its
    [B_l] ids, at the id wire's bytes). The outputs go to ``out_dir``;
    returns the rank's results."""
    from distributed_embeddings_tpu_torch.ops import (cuda_lookup, cuda_sparse,
                                                      cuda_tiled)
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager, stage_dp_batch)
    from distributed_embeddings_tpu_torch.tools import cuda_feature_probe
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    out = {"rank": rank, "device": str(dev)}
    layer = wire_placement_layer(torch, dev, rank,
                                 exchange_wire=WIRE_PLACEMENT)
    groups_ = layer.strategy.table_groups
    out["plan"] = dict(dp=len(groups_[0]), tp=len(groups_[1]),
                       placements=len(layer.plan.tp_placements),
                       buckets=len(layer.plan.tp_buckets),
                       row=len(groups_[2]))
    out["wires"] = ([(b.wire_dtype, b.id_wire_dtype)
                     for b in layer.plan.tp_buckets],
                    [(t.wire_dtype, t.id_wire_dtype)
                     for t in layer.plan.row_tables])
    batch, coefs = wire_placement_batch(layer)
    model = WireLinear(torch, layer, coefs)
    num, cats, labels = stage_dp_batch(batch, DeviceStager(dev))
    with torch.no_grad():
        outs = layer(cats)
    torch.save(torch.cat(outs, dim=1).cpu(),
               os.path.join(out_dir, f"forward{rank}.pt"))
    del outs
    init, step = make_sparse_train_step(model, "sgd", lr=TRAIN_LR)
    state = init(model)
    counted = (cuda_sparse, cuda_tiled, cuda_feature_probe)
    set_counts(cuda_lookup, *counted)
    with collective_calls(torch) as calls, \
            wire_payloads(torch) as payloads:
        _, state, loss = step(model, state, num, cats, labels)
    torch.cuda.synchronize()
    out["launches"] = read_counts(cuda_lookup, *counted)
    out["loss"] = float(loss)
    out["calls"] = calls
    out["wire"] = payloads
    key = tuple((1, False) for _ in layer.strategy.input_groups[1])
    tp_groups, _ = layer._exchange_groups_for_key(key)
    out["groups"] = len(tp_groups)
    out["tp_buckets_updated"] = len({g.bucket for g in tp_groups})
    out["row_tables"] = len(layer.row)
    b_l = BATCH // world
    row_ids = [cats[i] for i in layer.strategy.input_groups[2]]
    out["want_ids"] = (
        [("uint8", 2 * BATCH * g.f_max * g.k)
         if layer.plan.tp_buckets[g.bucket].id_wire_dtype == "int16"
         else (str(layer._id_dtype(g.bucket)).replace("torch.", ""),
               BATCH * g.f_max * g.k
               * wire_id_itemsize(torch, layer, g.bucket))
         for g in tp_groups],
        [("uint8", 2 * b_l) if layer.plan.row_tables[
            layer.strategy.map_groups[2][j]].id_wire_dtype == "int16"
         else (str(c.dtype).replace("torch.", ""),
               b_l * c.element_size())
         for j, c in enumerate(row_ids)])
    return out


def wire_placement_phase(torch, ranks, ranks_s, tmp):
    """Phase 13c: the ranks' `wire_placement_rank` results (`ranks`, from
    `wire_world_phase`'s spawn, their outputs in `tmp`), then the world-1
    layer (no wire) in this process with the same per-table
    weights: the plan (PLACEMENT_PLAN) and its wires on each rank
    (WIRE_PLACEMENT on every tp bucket and row table); each rank's
    outputs against world 1's on its rows within one bfloat16 rounding
    (2^-8 of the value: a tp output crosses the wire once, a row table's
    one-hot output is one shard's rounded row plus zeros); the launches a
    rank step (a `lookup_combine` a tp group and a row table, a
    `segment_sum_sorted` and an `sgd_rows` a tp bucket and a row shard);
    every float payload of the wire's collectives bfloat16; the id
    payloads in order, each at the plan's id wire (an int16 bucket's ids
    as 2 bytes an id); the id bytes a rank step. Returns the ranks'
    launch counts, summed."""
    world = PLACEMENT_WORLD
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    label = f"world{world}_placement_wire"
    emit(phase="placement_setup", path=label, world=world, backend=backend,
         device_count=cards, table_scale=AMP_WORLD_SCALE,
         exchange_wire=WIRE_PLACEMENT, **AMP_WORLD_KW)
    summed = dict.fromkeys(ALL_KERNELS, 0)
    floats = ("float32", "bfloat16", "float16")
    for r in ranks:
        check(r["plan"] == PLACEMENT_PLAN,
              f"{label}: rank {r['rank']} plans {r['plan']}, want "
              f"{PLACEMENT_PLAN}")
        check(all(w == WIRE_PLACEMENT for w, _ in r["wires"][0]
                  + r["wires"][1]),
              f"{label}: rank {r['rank']} plans the wires {r['wires']}")
        want_r = {"lookup_combine": r["groups"] + r["row_tables"],
                  "segment_sum_sorted": (r["tp_buckets_updated"]
                                         + r["row_tables"]),
                  "sgd_rows": r["tp_buckets_updated"] + r["row_tables"]}
        check(r["launches"] == per_step(want_r, 1),
              f"{label}: rank {r['rank']} launches {r['launches']}, "
              f"want {want_r}")
        for k, v in r["launches"].items():
            summed[k] += v
        moved = sorted({d for _, d, _ in r["calls"] if d in floats})
        check(moved == ["bfloat16"],
              f"{label}: rank {r['rank']}'s wire moved {moved}")
        ids = [(d, n) for c, d, n in r["calls"]
               if c == "all_to_all_single" and d not in floats]
        gathered = [(d, n) for c, d, n in r["calls"]
                    if c == "all_gather_into_tensor"
                    and d not in floats]
        check(ids == r["want_ids"][0] and gathered == r["want_ids"][1],
              f"{label}: rank {r['rank']}'s id payloads {ids} / "
              f"{gathered}, the plan's {r['want_ids']}")
    # world 1: the same weights, no wire
    layer = wire_placement_layer(torch, "cuda", 0)
    (_, cats, _), _ = wire_placement_batch(layer)
    b_l = BATCH // world
    worst = 0.0
    for r in range(world):
        got = torch.load(os.path.join(tmp, f"forward{r}.pt"))
        with torch.no_grad():
            want = torch.cat(layer([c[r * b_l:(r + 1) * b_l]
                                    for c in cats]), dim=1).cpu()
        check(got.shape == want.shape,
              f"{label}: rank {r} outputs {tuple(got.shape)}, want "
              f"{tuple(want.shape)}")
        err = (got - want).abs()
        worst = max(worst, err.max().item())
        check(bool((err <= 2.0 ** -8 * want.abs()).all()),
              f"{label}: rank {r}'s embedding outputs differ from world "
              f"1's by {err.max().item()}, past one bfloat16 rounding")
    del layer
    torch.cuda.empty_cache()
    emit(phase="main_path", path=label, backend=backend, world=world,
         exchange_wire=WIRE_PLACEMENT, ranks_seconds=ranks_s,
         launches_by_rank=[r["launches"] for r in ranks],
         losses_by_rank=[r["loss"] for r in ranks],
         max_abs_err=worst, ok=True)
    for r in ranks:
        ids = [n for c, d, n in r["calls"] if d not in floats]
        emit(phase="placement_wire", path=label, rank=r["rank"],
             step=r["wire"], id_bytes=sum(ids),
             int16_id_payloads=sum(d == "uint8" for _, d, _ in
                                   r["calls"]),
             buckets_int16=sum(i == "int16" for _, i in
                               r["wires"][0] + r["wires"][1]))
    return summed


def wire_rank(rank, world, backend, init_method, out_dir):
    """One rank of phases 13b and 13c, which share one spawn (as phase 8's
    ranks are spawned): `hot_wire_rank`, then `wire_placement_rank`, in
    one process group. Results go to ``out_dir``."""
    import torch
    check("jax" not in sys.modules, f"rank {rank} imported jax")
    import torch.distributed as dist
    from distributed_embeddings_tpu_torch.parallel.mesh import (
        initialize_distributed)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (world + 1)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    initialize_distributed(backend, init_method, world, rank)
    try:
        out = {"hot": hot_wire_rank(torch, rank, world, dev)}
        gc.collect()
        torch.cuda.empty_cache()
        out["placement"] = wire_placement_rank(torch, rank, world, dev,
                                               out_dir)
        check("jax" not in sys.modules, f"rank {rank} imported jax")
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def wire_world_phase(torch) -> dict:
    """Phases 13b and 13c: `wire_rank` on 2 ranks (sharing the card over
    gloo when it is the machine's only one), then `hot_wire_phase` and
    `wire_placement_phase` on their results. Returns the launch counts
    by path."""
    check(PLACEMENT_WORLD == 2, "13b and 13c share a spawn of 2 ranks")
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_wire")
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(torch, wire_rank, 2, backend, tmp, "world2_wire")
        ranks_s = time.perf_counter() - t0
        return {"world2_hot_wire": hot_wire_phase(
                    torch, [r["hot"] for r in ranks], ranks_s),
                "world2_placement_wire": wire_placement_phase(
                    torch, [r["placement"] for r in ranks], ranks_s, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- 14: host offload
# the device budget of phase 14's layers: the elements of DLRM's tables at
# Criteo x 0.4 (phase 9's fit: 9,613,690,624 elements, 38.45 GB, with its
# step at 47.28 GB peak); at the full sizes the three largest tables pass
# it and go to host memory
OFFLOAD_BUDGET_SCALE = 0.4
OFFLOAD_FULL_STEPS = 22       # 2 warm + 20 timed, as 12b
OFFLOAD_PROFILED_STEP = 4
# host memory the full scale leaves beside its pinned tables (the
# dataset, the step's staging and pending rows, the process): else the
# largest scale of OFFLOAD_SCALES whose offloaded part fits in half of
# MemAvailable
OFFLOAD_HOST_SPARE = 16 * 2**30
OFFLOAD_SCALES = (1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1)
OFFLOAD_HOLD_SCALE = DLRM_CPU_SCALE   # the holds: Criteo x 0.02
OFFLOAD_HOLD_BUDGET = 0.4     # the holds' device budget: this share of
                              # their elements (the three largest go)
OFFLOAD_SGD_STEPS = 3
OFFLOAD_ADAGRAD_STEPS = 2
OFFLOAD_INT8_STEPS = 2
OFFLOAD_TABLE_TOL = dict(rtol=2e-5, atol=2e-5)  # the JAX test's table bar
# the port's `layers.dist_model_parallel.OFFLOAD_LOOKUP_RANGE` and
# `OFFLOAD_UPDATE_RANGE`
# `offload:update`'s host ms when the numpy rules applied the offloaded
# rows (the full smoke on an H100 80GB HBM3 at 700 W), printed beside the
# C++ apply's
NUMPY_UPDATE_HOST_MS = 99.68
OFFLOAD_LOOKUP_RANGE = "offload:lookup"
OFFLOAD_UPDATE_RANGE = "offload:update"


def mem_available() -> int:
    """The host's MemAvailable (/proc/meminfo), bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def offload_budget() -> int:
    """14b's device budget in elements (OFFLOAD_BUDGET_SCALE's tables)."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        scaled_table_sizes)
    return sum(scaled_table_sizes(OFFLOAD_BUDGET_SCALE)) * 128


def offload_embedding(torch, sizes, device, budget, storage=None, gen=None):
    """DLRM's embedding at `sizes` (width 128, the example's initializer)
    with the device budget `budget` (None: every table on the device)."""
    from distributed_embeddings_tpu_torch.layers.dist_model_parallel import (
        DistributedEmbedding)
    from distributed_embeddings_tpu_torch.layers.embedding import Embedding
    from distributed_embeddings_tpu_torch.models.dlrm import dlrm_initializer
    return DistributedEmbedding(
        [Embedding(v, 128, embeddings_initializer=dlrm_initializer(),
                   device="meta") for v in sizes],
        strategy="memory_balanced", device=device, lookup_path="pallas",
        gpu_embedding_size=budget, storage_dtype=storage, generator=gen)


def offload_plan(torch, sizes, budget) -> dict:
    """The plan of `offload_embedding` at `sizes` (a layer on the meta
    device, which allocates nothing): the offloaded and the device
    buckets' bytes and the offloaded tables' rows."""
    layer = offload_embedding(torch, sizes, "meta", budget)
    off = [b for b, bk in enumerate(layer.plan.tp_buckets) if bk.offload]
    nbytes = [max(bk.rows_max, 1) * bk.width * 4
              for bk in layer.plan.tp_buckets]
    return dict(offloaded_buckets=off,
                offloaded_bytes=sum(nbytes[b] for b in off),
                device_bytes=sum(n for b, n in enumerate(nbytes)
                                 if b not in off),
                offloaded_rows=sorted(
                    (sizes[layer.strategy.table_groups[1][pl.table_id]]
                     for pl in layer.plan.tp_placements if pl.bucket in off),
                    reverse=True))


def offload_scale(torch) -> tuple:
    """The table scale phase 14 trains at: the full sizes when the host's
    MemAvailable holds their offloaded part and OFFLOAD_HOST_SPARE more,
    else the largest of OFFLOAD_SCALES whose offloaded part fits in half
    of it. Returns (scale, its plan, MemAvailable)."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        scaled_table_sizes)
    avail = mem_available()
    budget = offload_budget()
    for scale in OFFLOAD_SCALES:
        plan = offload_plan(torch, scaled_table_sizes(scale), budget)
        room = (avail - OFFLOAD_HOST_SPARE if scale == 1.0 else avail / 2)
        if plan["offloaded_bytes"] <= room:
            return scale, plan, avail
    raise SmokeFailure(f"MemAvailable {avail}: no table scale's offloaded "
                       "part fits")


def offload_dlrm(torch, sizes, device, budget, seed, storage=None):
    """DLRM at the example's widths with its embedding rebuilt under the
    device budget `budget` (and at `storage`), as the JAX example rebuilds
    it (examples/dlrm/serve.py:103-113); built over 4-row stand-in tables,
    so no table of `sizes` is drawn twice."""
    from distributed_embeddings_tpu_torch.models.dlrm import DLRM
    gen = torch.Generator(device=device).manual_seed(seed)
    model = DLRM([4] * len(sizes), device=device, lookup_path="pallas",
                 generator=gen)
    model.embedding = offload_embedding(torch, sizes, device, budget,
                                        storage, gen)
    model.table_sizes = list(sizes)
    return model


def layer_table(torch, layer, gtid) -> tuple:
    """Table `gtid` of a world-1 layer on the card, wherever its bucket
    lives (a host bucket's rows copied up): (its float32 rows, decoded at
    a quantized storage; their per-row scales, None at float32)."""
    from distributed_embeddings_tpu_torch.ops import wire
    pl = next(p for p in layer.plan.tp_placements
              if layer.strategy.table_groups[1][p.table_id] == gtid)
    rows = slice(pl.row_offset, pl.row_offset + pl.rows)
    payload = layer.tp[pl.bucket].detach()[rows].to("cuda")
    sd = layer.plan.tp_buckets[pl.bucket].storage_dtype
    if sd == "f32":
        return payload, None
    scale = layer.tp_scale[pl.bucket].detach()[rows].to("cuda")
    return wire.decode_rows(payload, scale, sd), scale


def model_snapshot(torch, model) -> dict:
    """A copy of every tensor of `model`'s state, each where it lives (a
    host bucket's on the host), for `load_state_dict` to copy back."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class HostApplyTap:
    """Records each quantized host apply of `layer` (its
    `_host_quantized_apply`, which still runs): the payload bytes, scales
    and state of the touched rows before and after, and the pending rows,
    so the port's numpy functions replay it (`replay_host_apply`)."""

    def __init__(self, torch, layer):
        self.torch, self.layer, self.calls = torch, layer, []
        self.real = layer._host_quantized_apply

    def __enter__(self):
        self.layer._host_quantized_apply = self
        return self

    def __exit__(self, *exc):
        del self.layer._host_quantized_apply

    def _rows(self, b, ru):
        layer = self.layer
        raw = layer.tp[b].data.view(self.torch.uint8).numpy()
        return raw[ru].copy(), layer.tp_scale[b].data.numpy()[ru].copy()

    def __call__(self, b, arrays, rep, sums, valid, opt, kw):
        import numpy as np
        ru = rep[valid > 0].astype(np.int64)
        payload, scale = self._rows(b, ru)
        state = [np.copy(x[ru]) if np.ndim(x) else x for x in arrays]
        self.real(b, arrays, rep, sums, valid, opt, kw)
        after = self._rows(b, ru)
        self.calls.append(dict(
            b=b, sd=self.layer._bucket_store_dtype(b), payload=payload,
            scale=scale, state=state, sums=sums[valid > 0].copy(),
            kind=opt.kind, lr=opt.lr, kw=dict(kw), payload_after=after[0],
            scale_after=after[1],
            state_after=[np.copy(x[ru]) if np.ndim(x) else x
                         for x in arrays]))


def replay_host_apply(call):
    """A recorded quantized host apply replayed on its touched rows by the
    numpy functions (`ops.wire.decode_rows_np`, `ops.sparse_update.
    host_apply_rows_plain`, `ops.wire.encode_rows_np`): True when it
    gives the card's rows, scales and state bit for bit."""
    import numpy as np
    from distributed_embeddings_tpu_torch.ops import sparse_update, wire
    sd, m = call["sd"], len(call["sums"])
    raw = call["payload"].view(np.int8) if sd == "int8" else call["payload"]
    sub = np.ascontiguousarray(wire.decode_rows_np(raw, call["scale"], sd))
    state = [np.copy(x) if np.ndim(x) else x for x in call["state"]]
    st = ((state[0], state[1], state[2]) if call["kind"] == "adam"
          else tuple(x for x in state if np.ndim(x)))
    sparse_update.host_apply_rows_plain(
        call["kind"], sub, st, np.arange(m), call["sums"],
        np.ones(m, np.float32), call["lr"], **call["kw"])
    pay, scl = wire.encode_rows_np(sub, sd, sr=True)
    return (np.asarray(pay).view(np.uint8).tobytes()
            == call["payload_after"].tobytes()
            and np.array_equal(scl, call["scale_after"])
            and all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(state, call["state_after"])))


class CppApplyTap:
    """Records each host apply of the offloaded layer's float32 buckets
    (`host_apply_rows_inplace`, the C++ loops, which still run): the
    touched rows of the table and its state before and after, and the
    pending rows, so `hold_cpp_applies` replays each by the numpy twin.
    With `args_only`, it copies nothing and keeps the last call's
    arguments (`last`: one step's rows, for `time_host_apply`)."""

    def __init__(self, args_only=False):
        from distributed_embeddings_tpu_torch.layers import (
            dist_model_parallel)
        self.module, self.calls = dist_model_parallel, []
        self.real = dist_model_parallel.host_apply_rows_inplace
        self.args_only, self.last = args_only, None

    def __enter__(self):
        self.module.host_apply_rows_inplace = self
        return self

    def __exit__(self, *exc):
        self.module.host_apply_rows_inplace = self.real

    def __call__(self, kind, table, state, rep, sums, valid, lr, **kw):
        import numpy as np
        if self.args_only:
            self.last = ((kind, table, state, rep, sums, valid, lr), kw)
            return self.real(kind, table, state, rep, sums, valid, lr, **kw)
        ok = valid > 0
        ru = rep[ok].astype(np.int64)

        def rows():
            return [np.copy(table[ru])] + [np.copy(x[ru]) for x in state
                                           if np.ndim(x)]
        before = rows()
        self.real(kind, table, state, rep, sums, valid, lr, **kw)
        self.calls.append(dict(
            kind=kind, before=before, after=rows(),
            sums=np.ascontiguousarray(sums[ok]), lr=lr, kw=dict(kw),
            count=state[2] if kind == "adam" else None))


def hold_cpp_applies(torch, calls) -> dict:
    """Each recorded C++ host apply (`CppApplyTap`) against the numpy twin
    (`host_apply_rows_plain`) on copies of the same rows before it: sgd
    bit for bit; adagrad and adam within the JAX test's rtol and atol of
    1e-6 (tests/test_host_apply.py), their largest ulp distance printed.
    Adam, which no offloaded step here runs, is held on the first call's
    rows with moments drawn from a seed and a step count of 3. Returns per
    kind the calls, rows, largest abs and ulp distance and whether every
    element was bit-equal."""
    import numpy as np
    from distributed_embeddings_tpu_torch.ops import sparse_update
    out = {}

    def held(kind, before, after, sums, lr, kw, count=None):
        m = len(sums)
        arrays = [np.copy(x) for x in before]
        st = ((arrays[1], arrays[2], count) if kind == "adam"
              else tuple(arrays[1:]))
        sparse_update.host_apply_rows_plain(
            kind, arrays[0], st, np.arange(m), sums, np.ones(m, np.float32),
            lr, **kw)
        equal = all(np.array_equal(a, b) for a, b in zip(after, arrays))
        err = max(float(np.abs(a - b).max()) if a.size else 0.0
                  for a, b in zip(after, arrays))
        ulps = max(max_ulp(torch, torch.from_numpy(a), torch.from_numpy(b))
                   if a.size else 0 for a, b in zip(after, arrays))
        close = all(np.allclose(a, b, rtol=1e-6, atol=1e-6)
                    for a, b in zip(after, arrays))
        rec = out.setdefault(kind, dict(calls=0, rows=0, max_abs_err=0.0,
                                        max_ulp=0, bit_equal=True))
        rec["calls"] += 1
        rec["rows"] += m
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["max_ulp"] = max(rec["max_ulp"], ulps)
        rec["bit_equal"] &= equal
        check(equal if kind == "sgd" else close,
              f"host apply {kind}: the C++ loop and the numpy twin differ "
              f"by {err} ({ulps} ulp) on {m} rows")
    for call in calls:
        held(call["kind"], call["before"], call["after"], call["sums"],
             call["lr"], call["kw"], call["count"])
    first = calls[0]
    rng = np.random.RandomState(DLRM_SEED)
    table = np.ascontiguousarray(first["before"][0])
    mu = (rng.randn(*table.shape) * 0.01).astype(np.float32)
    nu = (np.abs(rng.randn(*table.shape)) * 0.01).astype(np.float32)
    before = [table.copy(), mu.copy(), nu.copy()]
    m = len(first["sums"])
    sparse_update.host_apply_rows_inplace(
        "adam", table, (mu, nu, 3), np.arange(m), first["sums"],
        np.ones(m, np.float32), 1e-3)
    held("adam", before, [table, mu, nu], first["sums"], 1e-3, {}, 3)
    return out


def offload_pair_steps(torch, counting, models, kind, steps, batches, lr):
    """`steps` sparse steps of `kind` on each model of `models` (the
    offloaded one first) over the same staged batches. Returns each
    model's losses and the launch counts of the first model's steps
    (`counting`: ``(cuda_lookup, *counted)``, set to 0 just before)."""
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager)
    from distributed_embeddings_tpu_torch.training import (
        make_sparse_train_step)
    stage = DeviceStager("cuda")
    out, counts = [], None
    for model in models:
        init, step = make_sparse_train_step(model, kind, lr=lr)
        state = init(model)
        if counts is None:
            set_counts(*counting)
        losses = []
        for s in range(steps):
            num, cats, labels = stage(batches[s])
            _, state, loss = step(model, state, num, list(cats), labels)
            losses.append(float(loss))
        torch.cuda.synchronize()
        if counts is None:
            counts = read_counts(*counting)
        out.append(losses)
        del state
    return out, counts


def offload_hold_phase(torch, cuda_lookup, counted) -> dict:
    """14a: DLRM at Criteo x OFFLOAD_HOLD_SCALE with a device budget that
    forces its largest tables to the host (OFFLOAD_HOLD_BUDGET of its
    elements), on the card, against the same model with every table on the
    card, from one source of weights (`get_weights` of the all-device
    model into the other's `set_weights`; both reset from snapshots
    between runs) and the same MLPs: OFFLOAD_SGD_STEPS sgd steps at the
    example's schedule (losses at LOSS_TOL, every offloaded table bit for
    bit) and OFFLOAD_ADAGRAD_STEPS adagrad steps (losses at LOSS_TOL, the
    offloaded tables at OFFLOAD_TABLE_TOL, the JAX test's bar, with their
    largest ulp distance: the card's adagrad takes an approximate
    reciprocal square root, the host a correctly rounded one); then both
    at int8 storage from the same float32 weights, OFFLOAD_INT8_STEPS sgd
    steps (losses at LOSS_TOL; every offloaded element within one grid
    step a step of the all-device model's, whose update fuses decode and
    rule into one rounding and multiplies by its scale's reciprocal where
    the host divides; each host apply replayed bit for bit by the numpy
    functions). The tables are compared on the card. Launches of the
    offloaded sgd steps: `lookup_combine` 1, `segment_sum_sorted` 1 + the
    offloaded buckets, `sgd_rows` 1 a step. Returns the launch counts."""
    import numpy as np
    from distributed_embeddings_tpu_torch.models.dlrm import (
        make_lr_schedule, scaled_table_sizes)
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    t0 = time.perf_counter()
    sizes = scaled_table_sizes(OFFLOAD_HOLD_SCALE)
    budget = int(OFFLOAD_HOLD_BUDGET * sum(sizes) * 128)
    dev = offload_dlrm(torch, sizes, "cuda", None, DLRM_SEED + 3)
    off = offload_dlrm(torch, sizes, "cuda", budget, DLRM_SEED + 3)
    layer = off.embedding
    check(layer.offloaded_buckets and not dev.embedding.offloaded_buckets,
          f"offload_hold: offloaded buckets {layer.offloaded_buckets}")
    strat = layer.strategy
    off_tables = sorted({strat.table_groups[1][pl.table_id]
                         for pl in layer.plan.tp_placements
                         if pl.bucket in layer.offloaded_buckets})
    weights = dev.embedding.get_weights()
    mlp = {k: v.clone() for k, v in dev.state_dict().items()
           if not k.startswith("embedding.")}
    off.load_state_dict(mlp, strict=False)
    layer.set_weights(weights)
    initial = [torch.from_numpy(weights[t]) for t in off_tables]
    check(all(torch.equal(layer_table(torch, layer, t)[0].cpu(), w)
              for t, w in zip(off_tables, initial)),
          "offload_hold: set_weights/get_weights through the host buckets")
    snaps = [(m, model_snapshot(torch, m)) for m in (off, dev)]
    gen = ClickGenerator(sizes, 13, BATCH, seed=DLRM_SEED + 4)
    batches = [gen.batch(s) for s in range(OFFLOAD_SGD_STEPS)]
    del gen
    pinned = all(layer.tp[b].is_pinned() and layer.tp[b].device.type == "cpu"
                 for b in layer.offloaded_buckets)
    emit(phase="offload_hold_model", scale=OFFLOAD_HOLD_SCALE,
         budget_elements=budget, offloaded_tables=off_tables,
         offloaded_rows=[sizes[t] for t in off_tables],
         pinned_host_bytes=layer.pinned_host_bytes(),
         host_tables_pinned=pinned, seconds=time.perf_counter() - t0)
    check(pinned, "offload_hold: the offloaded tables are not pinned host "
                  "tensors")
    summary, counts, cpp_applies = {}, None, []
    for kind, steps, lr in (("sgd", OFFLOAD_SGD_STEPS,
                             make_lr_schedule(*DLRM_LR)),
                            ("adagrad", OFFLOAD_ADAGRAD_STEPS, TRAIN_LR)):
        t1 = time.perf_counter()
        for m, snap in snaps:
            m.load_state_dict(snap)
        set_native_calls()
        with CppApplyTap() as tap:
            (l_off, l_dev), launched = offload_pair_steps(
                torch, (cuda_lookup, *counted), (off, dev), kind, steps,
                batches, lr)
        native = read_native_calls(f"offload_hold_{kind}")
        check(native["host_apply"] == steps * len(layer.offloaded_buckets)
              == len(tap.calls),
              f"offload_hold {kind}: native calls {native}, {len(tap.calls)}"
              f" recorded applies, want {steps} a step and bucket")
        cpp_applies.append(tap.calls)
        counts = counts or launched
        got = [layer_table(torch, layer, t)[0] for t in off_tables]
        want = [layer_table(torch, dev.embedding, t)[0] for t in off_tables]
        ulp = max(max_ulp(torch, a, b) for a, b in zip(got, want))
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        close = all(torch.allclose(a, b, **OFFLOAD_TABLE_TOL)
                    for a, b in zip(got, want))
        moved = sum(int((a.cpu() != w).sum())
                    for a, w in zip(got, initial))
        losses_ok = np.allclose(l_off, l_dev, **LOSS_TOL)
        summary[kind] = dict(losses=l_off, all_device_losses=l_dev,
                             offloaded_elements_moved=moved,
                             offloaded_bit_equal=equal, max_abs_err=err,
                             max_ulp=ulp)
        emit(phase="offload_hold", optimizer=kind, steps=steps,
             seconds=time.perf_counter() - t1, **summary[kind],
             tolerance=("bit" if kind == "sgd" else OFFLOAD_TABLE_TOL),
             ok=losses_ok and (equal if kind == "sgd" else close))
        check(losses_ok, f"offload_hold {kind}: losses {l_off} against the "
                         f"all-device model's {l_dev}")
        check(moved > 0, f"offload_hold {kind}: no offloaded element moved")
        check(equal if kind == "sgd" else close,
              f"offload_hold {kind}: offloaded tables {err} ({ulp} ulp) "
              "from the all-device model's")
        del got, want
    want = {"lookup_combine": 1,
            "segment_sum_sorted": 1 + len(layer.offloaded_buckets),
            "sgd_rows": 1}
    check(counts == per_step(want, OFFLOAD_SGD_STEPS),
          f"offload_hold launches {counts}, want {want} per step")
    t1 = time.perf_counter()
    held = hold_cpp_applies(torch, [c for calls in cpp_applies
                                    for c in calls])
    emit(phase="host_apply_hold", seconds=time.perf_counter() - t1,
         tolerance=dict(sgd="bit", adagrad=dict(rtol=1e-6, atol=1e-6),
                        adam=dict(rtol=1e-6, atol=1e-6)), **held, ok=True)
    del off, dev, snaps, layer, cpp_applies
    torch.cuda.empty_cache()
    # int8: both models stored quantized, from the same float32 weights
    t1 = time.perf_counter()
    pair = [offload_dlrm(torch, sizes, "cuda", b, DLRM_SEED + 3,
                         storage="int8") for b in (budget, None)]
    for m in pair:
        m.load_state_dict(mlp, strict=False)
        m.embedding.set_weights(weights)
    del weights
    off8, dev8 = pair
    layer8 = off8.embedding
    set_native_calls()
    with HostApplyTap(torch, layer8) as tap:
        (l_off, l_dev), _ = offload_pair_steps(
            torch, (cuda_lookup, *counted), pair, "sgd", OFFLOAD_INT8_STEPS,
            batches, make_lr_schedule(*DLRM_LR))
    native = read_native_calls("offload_hold_int8")
    check(native["host_apply"] == len(tap.calls) > 0,
          f"offload_hold int8: native calls {native} for {len(tap.calls)} "
          "host applies")
    replayed = [replay_host_apply(c) for c in tap.calls]
    grid, equal_share = 0.0, []
    for t in off_tables:
        a, sa = layer_table(torch, layer8, t)
        b, sb = layer_table(torch, dev8.embedding, t)
        grid = max(grid, ((a - b).abs() / torch.maximum(sa, sb)).max().item())
        equal_share.append(float((a == b).float().mean()))
    losses_ok = np.allclose(l_off, l_dev, **LOSS_TOL)
    grid_ok = grid <= OFFLOAD_INT8_STEPS * (1 + 1e-6)
    ok = losses_ok and bool(replayed) and all(replayed) and grid_ok
    emit(phase="offload_hold", optimizer="sgd", storage_dtype="int8",
         steps=OFFLOAD_INT8_STEPS, seconds=time.perf_counter() - t1,
         losses=l_off, all_device_losses=l_dev,
         host_applies_replayed_bit_equal=sum(replayed),
         host_applies=len(replayed),
         touched_rows=[len(c["sums"]) for c in tap.calls],
         max_grid_steps_from_all_device=grid,
         bit_equal_share_by_table=equal_share, ok=ok)
    check(losses_ok, f"offload_hold int8: losses {l_off} against the "
                     f"all-device model's {l_dev}")
    check(replayed and all(replayed), "offload_hold int8: a host apply the "
                                      "numpy functions do not replay")
    check(grid_ok, f"offload_hold int8: offloaded elements {grid} grid "
                   "steps from the all-device model's")
    del pair, off8, dev8, layer8, tap
    torch.cuda.empty_cache()
    return {"offload_hold": counts}


def time_host_apply(call) -> dict:
    """One step's host apply (`CppApplyTap(args_only=True)`) timed again
    on the live host table: the C++ loops (`host_apply_rows_inplace`) and the numpy twin
    (`host_apply_rows_plain`, the plain yardstick) on the same rows, each
    from the same table rows (restored after each), both results compared
    (sgd: bit for bit)."""
    import numpy as np
    from distributed_embeddings_tpu_torch.ops import sparse_update
    (kind, table, state, rep, sums, valid, lr), kw = call
    ru = np.asarray(rep)[np.asarray(valid) > 0].astype(np.int64)
    saved = table[ru].copy()
    out, rows = {}, {}
    for name, fn in (("cpp", sparse_update.host_apply_rows_inplace),
                     ("plain", sparse_update.host_apply_rows_plain)):
        t0 = time.perf_counter()
        fn(kind, table, state, rep, sums, valid, lr, **kw)
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        rows[name] = table[ru].copy()
        table[ru] = saved
    check(kind == "sgd" and np.array_equal(rows["cpp"], rows["plain"]),
          "offload_full: the timed C++ apply and its numpy twin differ")
    return dict(kind=kind, rows=int(ru.size), width=int(table.shape[1]),
                bit_equal=True, **out)


class TrafficTap:
    """A `fit` callback: the layer's cumulative `offload_traffic` at the
    end of each step."""

    def __init__(self, layer):
        self.layer, self.at = layer, []

    def on_step(self, step, model, loss):
        self.at.append(dict(self.layer.offload_traffic))


# 14c: the hot-row cache over the offloaded bucket of 14b's model
OFFLOAD_CACHE_ROWS = 1_048_576     # 0.5 GiB of slots at width 128
OFFLOAD_CACHE_THRESHOLD = 2
OFFLOAD_SERVE_REQUESTS = 12
OFFLOAD_SERVE_SEED = DLRM_SEED + 7  # not the training stream's seed


def restore_counts(saved: dict, cuda_lookup, *counted):
    """Every launch count of `cuda_lookup` and the `counted` modules back
    to `saved` (`read_counts`' form)."""
    for module in (cuda_lookup, *counted):
        for key in module.launches:
            module.launches[key] = saved[key]


def cached_serving_phase(torch, cuda_lookup, counted, model, sizes) -> dict:
    """14c: 14b's trained model (its offloaded bucket in pinned host
    memory) served through `InferenceEngine(cache_capacity=
    OFFLOAD_CACHE_ROWS, promote_threshold=2)`, a `HotRowCache` over each
    offloaded bucket, beside the uncached engine on the same model.
    OFFLOAD_SERVE_REQUESTS requests of BATCH rows, seeded ClickGenerator
    batches (power law, alpha 1.05, OFFLOAD_SERVE_SEED); the cached run
    is the main path (counts to 0, drive, read: `lookup_combine` once a
    forward, for the device bucket), then the uncached run. Each
    request's logits `torch.equal` to the uncached engine's; hits and
    promotions both above 0. Printed: the hit rate by request and
    cumulative, promotions, evictions, serve ms (a synchronized `predict`)
    cached beside uncached, the host ms of the offloaded lookup
    (`_offload_group_out`, the cached path inside it) cached beside
    uncached, the HtoD bytes the layer moved in each run, the slots'
    bytes, the phase's seconds. Returns the launch counts."""
    import numpy as np
    from distributed_embeddings_tpu_torch.models.synthetic import (
        ClickGenerator)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    t_phase = time.perf_counter()
    layer = model.embedding
    gen = ClickGenerator(sizes, 13, BATCH, seed=OFFLOAD_SERVE_SEED)
    requests = [gen.batch(i)[:2] for i in range(OFFLOAD_SERVE_REQUESTS)]
    cached = InferenceEngine(model, device="cuda",
                             cache_capacity=OFFLOAD_CACHE_ROWS,
                             promote_threshold=OFFLOAD_CACHE_THRESHOLD)
    plain = InferenceEngine(model, device="cuda")
    for engine in (cached, plain):
        engine.warmup([BATCH], example=requests[0])
    torch.cuda.synchronize()
    check(set(cached.caches) == set(layer.offloaded_buckets),
          f"offload_serve: caches over {sorted(cached.caches)}, offloaded "
          f"{layer.offloaded_buckets}")
    slot_bytes = sum(c.slots.numel() * c.slots.element_size()
                     for c in cached.caches.values())
    runs = {}
    for name, engine in (("cached", cached), ("plain", plain)):
        lookup_ms = timed_method(layer, "_offload_group_out")
        htod = layer.offload_traffic["htod_bytes"]
        outs, serve_ms, hit_rate, cumulative = [], [], [], []
        before = (0, 0)
        if name == "cached":
            set_counts(cuda_lookup, *counted)
        for num, cats in requests:
            t0 = time.perf_counter()
            outs.append(engine.predict((num, cats)))
            torch.cuda.synchronize()
            serve_ms.append((time.perf_counter() - t0) * 1e3)
            st = engine.cache_stats()
            hits, misses = st["hits"] - before[0], st["misses"] - before[1]
            before = (st["hits"], st["misses"])
            hit_rate.append(hits / max(hits + misses, 1))
            cumulative.append(st["hits"] / max(st["hits"] + st["misses"], 1))
        if name == "cached":
            counts = read_counts(cuda_lookup, *counted)
        del layer._offload_group_out
        runs[name] = dict(outs=outs, serve_ms=serve_ms, hit_rate=hit_rate,
                          cumulative=cumulative, lookup_ms=list(lookup_ms),
                          htod_bytes=layer.offload_traffic["htod_bytes"]
                          - htod)
    want = {"lookup_combine": 1}
    check(counts == per_step(want, OFFLOAD_SERVE_REQUESTS),
          f"offload_serve_cached launches {counts}, want {want} a forward")
    for i, (a, b) in enumerate(zip(runs["cached"]["outs"],
                                   runs["plain"]["outs"])):
        check(tuple(a.shape) == (BATCH, 1) and bool(torch.isfinite(a).all())
              and torch.equal(a, b),
              f"offload_serve: request {i}'s cached logits differ from the "
              "uncached engine's")
    st = cached.cache_stats()
    per = list(st["buckets"].values())
    promotions = sum(c["promotions"] for c in per)
    evictions = sum(c["evictions"] for c in per)
    check(st["hits"] > 0 and promotions > 0,
          f"offload_serve: hits {st['hits']}, promotions {promotions}")
    emit(phase="main_path", path="offload_serve_cached",
         requests=OFFLOAD_SERVE_REQUESTS, rows=BATCH,
         cache_rows=OFFLOAD_CACHE_ROWS,
         promote_threshold=OFFLOAD_CACHE_THRESHOLD, slot_bytes=slot_bytes,
         launches=counts, bit_equal=True,
         hit_rate_by_request=runs["cached"]["hit_rate"],
         hit_rate_cumulative=runs["cached"]["cumulative"],
         hit_rate=st["hit_rate"], hits=st["hits"], misses=st["misses"],
         promotions=promotions, evictions=evictions,
         resident=sum(c["resident"] for c in per),
         serve_ms={k: runs[k]["serve_ms"] for k in runs},
         serve_ms_median={k: statistics.median(runs[k]["serve_ms"])
                          for k in runs},
         offload_lookup_host_ms={k: runs[k]["lookup_ms"] for k in runs},
         offload_lookup_host_ms_median={
             k: statistics.median(runs[k]["lookup_ms"]) for k in runs},
         htod_bytes={k: runs[k]["htod_bytes"] for k in runs},
         seconds=time.perf_counter() - t_phase, ok=True)
    del cached, plain, runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"offload_serve_cached": counts}


def offload_full_phase(torch, cuda_lookup, counted) -> dict:
    """14b: DLRM at the example's widths at the MLPerf Criteo-1TB sizes
    in float32 on one card, its embedding rebuilt with
    ``gpu_embedding_size`` the elements of the x 0.4 tables: the three
    largest tables (61.2 GB) in pinned host memory, the rest (34.9 GB) on
    the card (the host's MemAvailable decides the scale first,
    `offload_scale`). The build's and its page-locking's seconds (the
    driver's ``cudaHostRegister``), the pinned bytes, MemAvailable after,
    `memory_allocated` beside the device buckets' bytes; `fit` (sgd at
    the example's schedule, batch 65,536, a seeded ClickGenerator stream
    from a split-binary dataset, pipelined) for OFFLOAD_FULL_STEPS steps:
    step times, samples/s, launches a step checked (`lookup_combine` 1,
    `segment_sum_sorted` 1 + the offloaded buckets, `sgd_rows` 1), one
    profiled step (the card's idle share, the host ms of the offloaded
    lookup's and update's ranges, each one call, the HtoD copies and the
    HtoD and DtoH device ms by category, the bytes the layer moved), peak
    device memory;
    the on-card AUC against `auc_exact`; a 65,536-row request through
    `InferenceEngine`. Returns the launch counts."""
    from distributed_embeddings_tpu_torch.models.dlrm import (
        make_lr_schedule, scaled_table_sizes)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.training import fit
    scale, plan, avail = offload_scale(torch)
    sizes = scaled_table_sizes(scale)
    emit(phase="offload_host", mem_available=avail, scale=scale,
         full_scale=scale == 1.0, budget_elements=offload_budget(), **plan,
         host_spare=OFFLOAD_HOST_SPARE)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = offload_dlrm(torch, sizes, "cuda", offload_budget(), DLRM_SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    layer = model.embedding
    off = layer.offloaded_buckets
    dev_bytes = sum(t.numel() * 4 for b, t in enumerate(layer.tp)
                    if b not in off)
    host_bytes = sum(layer.tp[b].numel() * 4 for b in off)
    allocated = torch.cuda.memory_allocated() - before
    pinned = layer.pinned_host_bytes()
    emit(phase="model", config="dlrm_criteo_offload", scale=scale,
         rows=sum(sizes), build_s=build_s,
         pin_s=sum(p.seconds for p in layer._host_pins),
         offloaded_buckets=off,
         host_table_bytes=host_bytes, device_table_bytes=dev_bytes,
         pinned_host_bytes=pinned, mem_available_after=mem_available(),
         memory_allocated_by_build=allocated,
         host_tables_pinned=all(layer.tp[b].is_pinned() for b in off))
    check(off and off == plan["offloaded_buckets"] and host_bytes ==
          plan["offloaded_bytes"], f"offload_full: buckets {off}, the "
                                   f"plan's {plan}")
    check(all(layer.tp[b].is_pinned() for b in off)
          and host_bytes <= pinned < host_bytes + 4096 * len(off),
          f"offload_full: {pinned} bytes pinned for {host_bytes}")
    check(allocated < dev_bytes + 2**30,
          f"offload_full: the build took {allocated} bytes on the card, its "
          f"device buckets {dev_bytes}")
    dataset = shared_dataset(sizes, OFFLOAD_FULL_STEPS)
    train, test = dataset(False), dataset(True)
    window = StepWindow(torch, OFFLOAD_PROFILED_STEP)
    traffic = TrafficTap(layer)
    set_counts(cuda_lookup, *counted)
    set_native_calls()
    t0 = time.perf_counter()
    with CppApplyTap(args_only=True) as last_apply:
        _, _, hist = fit(model, train.raw_batches(OFFLOAD_FULL_STEPS),
                         OFFLOAD_FULL_STEPS, "sgd",
                         lr=make_lr_schedule(*DLRM_LR),
                         preprocess=train.preprocess, pipelined=True,
                         log_every=0, callbacks=[window, traffic])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = {"offload_dlrm_full": read_counts(cuda_lookup, *counted)}
    native = read_native_calls("offload_dlrm_full")
    check(native["host_apply"] == OFFLOAD_FULL_STEPS * len(off)
          and native["prefetch"] >= OFFLOAD_FULL_STEPS * (2 + len(sizes)),
          f"offload_dlrm_full: native calls {native}, want "
          f"{OFFLOAD_FULL_STEPS * len(off)} C++ applies and the prefetcher's "
          "reads")
    want = {"lookup_combine": 1, "segment_sum_sorted": 1 + len(off),
            "sgd_rows": 1}
    check(counts["offload_dlrm_full"] == per_step(want,
                                                  OFFLOAD_FULL_STEPS),
          f"offload_dlrm_full launches {counts['offload_dlrm_full']}, "
          f"want {want} per step")
    check(all(map(math.isfinite, hist["loss"])),
          f"offload_dlrm_full: non-finite losses {hist['loss']}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = window.step_ms()
    med = statistics.median(step_ms)
    profiled = window.profile()
    for name in (OFFLOAD_LOOKUP_RANGE, OFFLOAD_UPDATE_RANGE):
        profiled[name] = window.range_ms(name)
        check(profiled[name]["calls"] == 1,
              f"offload_dlrm_full: the profiled step's {name} range: "
              f"{profiled[name]}, want 1 call")
    p = OFFLOAD_PROFILED_STEP
    profiled["bytes"] = {k: traffic.at[p + 1][k] - traffic.at[p][k]
                         for k in traffic.at[p]}
    card_auc = dlrm_card_auc(torch, model, test)
    engine = InferenceEngine(model, device="cuda")
    num, cats, _ = test[0]
    serve_ms = serve_latency_ms(torch, engine, (num, cats))
    logits = engine.predict((num, cats))
    check(tuple(logits.shape) == (BATCH, 1)
          and bool(torch.isfinite(logits).all()),
          "offload_dlrm_full: the engine's logits")
    del engine, logits
    # 14c: the same model served through the hot-row cache
    counts.update(cached_serving_phase(torch, cuda_lookup, counted, model,
                                       sizes))
    # one step's rows applied again by the C++ loops and by the numpy twin
    profiled["host_apply_timed"] = time_host_apply(last_apply.last)
    del last_apply
    emit(phase="main_path", path="offload_dlrm_full",
         steps=OFFLOAD_FULL_STEPS, scale=scale, rows=sum(sizes),
         build_s=build_s, fit_s=fit_s,
         launches=counts["offload_dlrm_full"], losses=hist["loss"],
         median_step_ms=med, samples_per_s=BATCH / (med / 1e3),
         step_ms=step_ms, max_memory_allocated=peak,
         device_table_bytes=dev_bytes, host_table_bytes=host_bytes,
         other_memory_at_peak=peak - dev_bytes,
         ingest_stage_mean_ms={k: v["mean_ms"] for k, v in
                               hist["ingest_stages"].items()},
         profiled_step=profiled, card_auc=card_auc, serve_rows=BATCH,
         serve_ms=serve_ms, native_calls=native,
         update_host_ms=dict(
             cpp=profiled[OFFLOAD_UPDATE_RANGE]["host_ms"],
             numpy_apply_before=NUMPY_UPDATE_HOST_MS), ok=True)
    del model, train, test, layer
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---- 15. the Criteo example's on-the-fly vocabulary flow at full width
CRITEO_VOCAB = dict(n_cat=26, max_tokens=100_000, embedding_dim=128,
                    mlp_dims=(512, 256, 1), n_num=13)
CRITEO_VOCAB_BATCH = 4096
CRITEO_VOCAB_LR = 1e-3        # the example's --lr
CRITEO_VOCAB_SEED = 0
CRITEO_VOCAB_STEPS = 30       # each of the pipelined and the serial run
CRITEO_VOCAB_HELD = 3         # adam steps held against the CPU
CRITEO_VOCAB_PROFILED = 4
# the held steps' bar: dense_criteo's rtol (1e-5, no atol), and for a
# gradient 2 CRITEO_SUM_EPS of its terms' magnitude t (`criteo_scale`):
# one float32 rounding of t, which already sums the magnitudes of every
# term through every layer, forward and backward (float32 rounding that
# does not line up across a sum of n terms stays near 2**-24 / sqrt(n)
# of it); a step with the card's gemms in TF32 (2**-11) crosses it
# (`criteo_tf32_control`)
CRITEO_TABLE_RTOL = 1e-5
CRITEO_SUM_EPS = 2.0 ** -24
BENCH_LOOKUP_KEYS = 16_777_216
BENCH_LOOKUP_TOKENS = 20_000_000   # docs/parity.md's IntegerLookup run
BENCH_LOOKUP_BATCH = 65536


def criteo_translate_two_ways(batches) -> dict:
    """Every batch's raw keys through the C++ map and through the numpy
    twin (`IntegerLookup(use_native=False)`), one lookup a feature each,
    via the example's lookup stage: after each batch the indices, and each
    feature's vocabulary, counts and size, equal. Returns the pass's
    record."""
    import numpy as np
    from distributed_embeddings_tpu_torch.tools import criteo_example as ce
    n_cat, tokens = CRITEO_VOCAB["n_cat"], CRITEO_VOCAB["max_tokens"]
    native = ce.make_lookups(n_cat, tokens, use_native=True)
    twin = ce.make_lookups(n_cat, tokens, use_native=False)
    stages = (ce.lookup_stage(native), ce.lookup_stage(twin))
    t0 = time.perf_counter()
    ms = {"native": 0.0, "numpy": 0.0}
    for i, batch in enumerate(batches):
        out = []
        for name, stage in zip(ms, stages):
            t1 = time.perf_counter()
            out.append(stage(batch)[1])
            ms[name] += (time.perf_counter() - t1) * 1e3
        check(np.array_equal(out[0], out[1]),
              f"criteo_vocab: batch {i}'s ids differ between the C++ map "
              "and the numpy twin")
        for j, (a, b) in enumerate(zip(native, twin)):
            check(a.size == b.size and np.array_equal(a.counts(), b.counts())
                  and a.get_vocabulary() == b.get_vocabulary(),
                  f"criteo_vocab: batch {i} feature {j}: vocabulary, counts "
                  "or size differ between the C++ map and the numpy twin")
    rec = dict(batches=len(batches), keys=len(batches) * CRITEO_VOCAB_BATCH
               * n_cat, seconds=time.perf_counter() - t0,
               lookup_ms_per_batch={k: v / len(batches)
                                    for k, v in ms.items()},
               vocab_sizes=[lk.size for lk in native], identical=True)
    emit(phase="criteo_translate", **rec)
    return rec


def criteo_scale(torch, model, numerical, idx, labels):
    """`training.gradient_scale` for the Criteo example's model, taken to
    the full depth: its loss and, per parameter, (g, t): the gradient and
    the magnitude its rounding scales with. t is the backward by absolute
    values with the ReLU masks kept (`training.mlp_magnitudes`), where
    each layer's input is taken at its forward magnitude sum (A: the input
    by absolute value through |w| and |b|, masked), not at its value, and
    the logit's gradient carries the logit's magnitude sum through the
    sigmoid's slope (at most 1/4) and the mean's 1/B: so t bounds, to
    first order, the terms' own rounding from every layer before them as
    well as the last sum's. A table's t sums each sample's input columns
    of the MLP input's magnitude into its row. Updates nothing. Returns
    (loss, {name: (g, t)})."""
    from distributed_embeddings_tpu_torch.training import mlp_magnitudes
    acts = []
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out: acts.append((mod, inp[0], out)))
        for layer in model.mlp]
    params = dict(model.named_parameters())
    flags = {n: p.requires_grad for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    try:
        loss = model.loss_fn(numerical, idx, labels)
        grads = torch.autograd.grad(loss, [*params.values(), acts[-1][2]])
    finally:
        for h in hooks:
            h.remove()
        for n, p in params.items():
            p.requires_grad_(flags[n])
    by_name = dict(zip(params, grads))
    with torch.no_grad():
        # forward magnitudes: A[i] the magnitude of layer i's input
        mags = [acts[0][1].abs()]
        for i, (layer, _, z) in enumerate(acts):
            tz = mags[-1] @ layer.w.abs() + layer.b.abs()
            mags.append(tz * (z > 0) if i < len(acts) - 1 else tz)
        batch = acts[-1][2].shape[0]
        out, scale = mlp_magnitudes(
            model, acts, grads[-1].abs() + 0.25 * mags[-1] / batch, by_name,
            inputs=mags)
        n_num = numerical.shape[1]
        ids = torch.as_tensor(idx).long()
        for j, t in enumerate(model.tables):
            w = t.output_dim
            name = f"tables.{j}.embeddings"
            out[name] = (by_name[name],
                         torch.zeros_like(t.embeddings).index_add_(
                             0, ids[:, j],
                             scale[:, n_num + j * w:n_num + (j + 1) * w]))
    return float(loss.detach()), out


def criteo_vocab_held(torch, model, cpu_model, batches,
                      flip_eps=SUM_EPS) -> dict:
    """CRITEO_VOCAB_HELD adam steps of the example's flow on the card, each
    held against the CPU from the card's weights and adam state before it,
    in its two halves. The CPU model (the same code) runs the step's
    forward and backward under the card's ReLU masks (`forced_relu`,
    `criteo_scale`; a flip past `flip_eps`, SUM_EPS by default, fails):
    the losses at LOSS_TOL, and each parameter's
    gradient, the card's caught at its optimizer, by `hold`'s "gradient"
    mode at CRITEO_TABLE_RTOL and CRITEO_SUM_EPS (a table's on the rows its
    batch touched; the others are 0 on both). The CPU's adam twin
    (`training.adam`, the same expressions) then updates, from the card's
    gradient and state, the rows adam moves (a table's rows touched by
    this step or an earlier one: the others have a zero gradient and zero
    moments, so their step is 0) and the MLP: the card's values by
    `hold`'s "update" mode at CRITEO_TABLE_RTOL and an ulp, its moments
    bit for bit; the rows adam does not move unchanged on the card, bit
    for bit. `batches` are translated (numerical, idx, labels) numpy
    batches. The record keeps, per parameter, the largest share of its
    gradient bar an element used."""
    from distributed_embeddings_tpu_torch.parallel.staging import (
        DeviceStager)
    from distributed_embeddings_tpu_torch.tools import criteo_example as ce
    from distributed_embeddings_tpu_torch.training import adam as dense_adam
    lr = CRITEO_VOCAB_LR
    opt, step = ce.make_step(lr)
    twin = dense_adam(lr)
    caught = {}
    card_update = opt.update

    def catching(params, grads, st):
        caught["grads"] = grads
        return card_update(params, grads, st)
    opt.update = catching
    state = opt.init(dict(model.named_parameters()))
    stage = DeviceStager("cuda")
    rec = dict(losses=[], cpu_losses=[], gradient_err=0.0, update_err=0.0,
               gradient_bar_share={}, moving_rows=[], relu_flips=[])
    for numerical, idx, labels in batches:
        ids = torch.from_numpy(idx).long()
        moving = {}
        for j, t in enumerate(model.tables):
            name = f"tables.{j}.embeddings"
            earlier = (state["nu"][name] != 0).any(dim=1).nonzero().flatten()
            moving[name] = torch.unique(torch.cat([ids[:, j],
                                                   earlier.cpu()]))

        def rows_of(name, x):
            x = x.detach()
            if name in moving:
                x = x.index_select(0, moving[name].to(x.device))
            return x.cpu().clone()
        cpu_model.load_state_dict(model.state_dict())
        params = dict(model.named_parameters())
        before = {n: rows_of(n, p) for n, p in params.items()}
        still = {}
        for n in moving:
            mask = torch.ones(params[n].shape[0], dtype=torch.bool,
                              device=params[n].device)
            mask[moving[n].to(mask.device)] = False
            still[n] = (mask, params[n].detach()[mask].clone())
        twin_state = {"count": state["count"],
                      "mu": {n: rows_of(n, x) for n, x in state["mu"].items()},
                      "nu": {n: rows_of(n, x) for n, x in state["nu"].items()}}
        card_batch = stage((numerical, idx, labels))
        (_, state, loss), masks = relu_masks(
            model, lambda: step(model, state, *card_batch))
        card_grads = {n: rows_of(n, g) for n, g in caught.pop("grads").items()}
        with forced_relu(torch, cpu_model, masks, flip_eps) as flips:
            cpu_loss, scale = criteo_scale(
                torch, cpu_model, *(torch.from_numpy(x)
                                    for x in (numerical, idx, labels)))
        rec["losses"].append(float(loss))
        rec["cpu_losses"].append(cpu_loss)
        rec["relu_flips"].append(flips[-1])
        # the backward: the card's gradients against the CPU's
        for n, (g, t) in scale.items():
            got = card_grads[n]
            if n in moving:
                g, t = rows_of(n, g), rows_of(n, t)
            err, _, _, share = hold(
                torch, f"criteo_vocab {n} gradient", got, g, None, 0,
                "gradient", eps=CRITEO_SUM_EPS, mag=t, rtol=CRITEO_TABLE_RTOL)
            rec["gradient_err"] = max(rec["gradient_err"], err)
            rec["gradient_bar_share"][n] = max(
                rec["gradient_bar_share"].get(n, 0.0), share)
        # the update: the CPU twin on the card's gradient and state
        want = {n: x.clone() for n, x in before.items()}
        twin.update(want, card_grads, twin_state)
        for n, p in params.items():
            err, *_ = hold(torch, f"criteo_vocab {n} update", rows_of(n, p),
                           want[n], before[n], 1, "update",
                           rtol=CRITEO_TABLE_RTOL)
            rec["update_err"] = max(rec["update_err"], err)
            for moment in ("mu", "nu"):
                check(torch.equal(rows_of(n, state[moment][n]),
                                  twin_state[moment][n]),
                      f"criteo_vocab {n}: adam's {moment} differs from the "
                      "CPU twin's")
            if n in still:
                mask, old = still[n]
                check(torch.equal(p.detach()[mask], old),
                      f"criteo_vocab {n}: a row adam does not move changed")
        rec["moving_rows"].append(sum(int(m.numel())
                                      for m in moving.values()))
        del before, still, twin_state, card_grads, scale, want
        emit(phase="held_step", kind="criteo_vocab_adam",
             loss=rec["losses"][-1], cpu_loss=cpu_loss, relu_flips=flips[-1])
    check(torch.allclose(torch.tensor(rec["losses"]),
                         torch.tensor(rec["cpu_losses"]), **LOSS_TOL),
          f"criteo_vocab: losses {rec['losses']} against the CPU's "
          f"{rec['cpu_losses']}")
    return rec


def criteo_tf32_control(torch, model, cpu_model, batch) -> str:
    """The held step's control: one more step held as
    `criteo_vocab_held` holds it, with the card's float32 gemms in TF32
    (10-bit mantissas), which must come out not correct. The CPU takes
    the card's ReLU masks whatever the flips' margin, so the gradient
    bar, the only check of the MLP's gradients' precision, is what must
    fail. Returns the failure."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        criteo_vocab_held(torch, model, cpu_model, [batch],
                          flip_eps=math.inf)
        failure = None
    except SmokeFailure as e:
        failure = str(e)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    emit(phase="criteo_tf32_control", failed=failure is not None,
         failure=failure)
    check(failure is not None and " gradient: " in failure,
          f"criteo_vocab: the held step with the card's gemms in TF32 did "
          f"not fail its gradient bar ({failure})")
    return failure


def criteo_vocab_phase(torch, cuda_lookup, counted) -> dict:
    """15: `tools/criteo_example.py` at the example's full width: 26
    features, `max_tokens` 100,000 (26 tables of 100,001 x 128 float32,
    1.33 GB, and 2.66 GB of adam state), MLP 512-256-1 over 13 + 26 x 128
    inputs, batch 4,096 of the example's synthetic zipf keys (seed 0).
    The keys of every batch translated by the C++ map and by the numpy
    twin, equal batch for batch (`criteo_translate_two_ways`); 3 adam
    steps held against the CPU (`criteo_vocab_held`), and a fourth with
    the card's gemms in TF32 that must fail (`criteo_tf32_control`); 30
    steps through the
    ingest pipeline (lookup and stage workers) and 30 inline, from the
    same weights with fresh vocabularies: losses, vocabularies, tables and
    MLP bit for bit. Printed: the step median and samples/s, the
    ``lookup`` and ``stage`` means, one profiled step (idle share), peak
    memory, the vocabulary sizes, the native calls (26 translations a
    step; no CUDA kernel of the port runs on this path: a combiner-less
    lookup is a gather, `jnp.take` in the JAX package); then the example's
    ``--bench_lookup`` at BENCH_LOOKUP_KEYS keys (max_tokens
    BENCH_LOOKUP_TOKENS): native and numpy keys/s and the host's CPUs.
    Returns the launch counts."""
    import itertools
    from distributed_embeddings_tpu_torch.tools import criteo_example as ce
    t_phase = time.perf_counter()
    cfg = CRITEO_VOCAB
    torch.cuda.reset_peak_memory_stats()
    raw = list(itertools.islice(ce.synthetic_batches(
        CRITEO_VOCAB_BATCH, cfg["n_num"], cfg["n_cat"], CRITEO_VOCAB_SEED),
        CRITEO_VOCAB_STEPS))
    translated = criteo_translate_two_ways(raw)
    t0 = time.perf_counter()
    model = ce.CriteoModel(**cfg, device="cuda", seed=CRITEO_VOCAB_SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    cpu_model = ce.CriteoModel(**cfg, device="cpu")
    emit(phase="model", config="criteo_vocab", build_s=build_s,
         tables=cfg["n_cat"], rows=cfg["max_tokens"] + 1,
         table_bytes=sum(t.embeddings.numel() * 4 for t in model.tables),
         mlp_in=cfg["n_num"] + cfg["n_cat"] * cfg["embedding_dim"])
    # the held steps, on the first batches' translation
    lookups = ce.make_lookups(cfg["n_cat"], cfg["max_tokens"])
    stage = ce.lookup_stage(lookups)
    t0 = time.perf_counter()
    held = criteo_vocab_held(torch, model, cpu_model, [
        stage(b) for b in raw[:CRITEO_VOCAB_HELD]])
    emit(phase="main_path", path="criteo_vocab_held",
         steps=CRITEO_VOCAB_HELD, seconds=time.perf_counter() - t0,
         gradient_tolerance=dict(rtol=CRITEO_TABLE_RTOL,
                                 plus="2 eps t", eps=CRITEO_SUM_EPS),
         update_tolerance=dict(rtol=CRITEO_TABLE_RTOL, of="max(|value|, "
                               "|change|)", plus="1 ulp", moments="bit",
                               rows_not_moved="bit"), **held, ok=True)
    criteo_tf32_control(torch, model, cpu_model,
                        stage(raw[CRITEO_VOCAB_HELD]))
    del cpu_model, lookups
    gc.collect()
    # pipelined, then serial, from the same weights and fresh vocabularies
    runs, counts = {}, {}
    for serial in (False, True):
        label = "criteo_vocab_serial" if serial else "criteo_vocab"
        model.load_state_dict(initial)
        lookups = ce.make_lookups(cfg["n_cat"], cfg["max_tokens"])
        # the serial run's window lies past its last step: it only times
        timer = StepWindow(torch, CRITEO_VOCAB_STEPS + 1 if serial
                           else CRITEO_VOCAB_PROFILED)
        set_counts(cuda_lookup, *counted)
        set_native_calls()
        out = ce.train(model, lookups, raw, CRITEO_VOCAB_STEPS,
                       lr=CRITEO_VOCAB_LR, serial=serial, log_every=0,
                       callbacks=[timer])
        counts[label] = read_counts(cuda_lookup, *counted)
        native = read_native_calls(label)
        check(not any(counts[label].values()),
              f"{label}: a CUDA kernel of the port ran: {counts[label]}")
        check(native == {"integer_lookup": cfg["n_cat"] * CRITEO_VOCAB_STEPS,
                         "prefetch": 0, "host_apply": 0},
              f"{label}: native calls {native}, want "
              f"{cfg['n_cat']} translations a step")
        check(all(map(math.isfinite, out["losses"])),
              f"{label}: non-finite losses {out['losses']}")
        step_ms = timer.step_ms()
        med = statistics.median(step_ms)
        line = dict(steps=CRITEO_VOCAB_STEPS, batch=CRITEO_VOCAB_BATCH,
                    seconds=out["seconds"], median_step_ms=med,
                    samples_per_s=CRITEO_VOCAB_BATCH / (med / 1e3),
                    step_ms=step_ms, ingest_stage_mean_ms=out["stage_ms"],
                    losses=out["losses"], vocab_sizes=out["vocab"],
                    native_calls=native, launches=counts[label])
        if not serial:
            line.update(profiled_step=timer.profile(),
                        max_memory_allocated=torch.cuda
                        .max_memory_allocated())
        emit(phase="main_path", path=label, **line)
        runs[serial] = (out["losses"], out["vocab"],
                        {k: v.clone() for k, v in
                         model.state_dict().items()},
                        [lk.get_vocabulary() for lk in lookups])
        del out, lookups
    (l1, v1, m1, g1), (l2, v2, m2, g2) = runs[False], runs[True]
    same = (l1 == l2 and v1 == v2 and g1 == g2
            and all(torch.equal(m1[k], m2[k]) for k in m1))
    emit(phase="criteo_vocab_pipelined_vs_serial", bit_identical=same,
         losses_equal=l1 == l2, vocab_equal=g1 == g2)
    check(same, "criteo_vocab: the pipelined and the serial run differ")
    del runs, m1, m2, model, initial
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = ce.bench_lookup(BENCH_LOOKUP_KEYS, BENCH_LOOKUP_BATCH,
                            BENCH_LOOKUP_TOKENS, cfg["n_cat"],
                            log_fn=lambda m: None)
    emit(phase="bench_lookup", seconds=time.perf_counter() - t0,
         cpu_count=os.cpu_count(), cpus_usable=len(os.sched_getaffinity(0)),
         **bench)
    check(bench["native_vocab_after"] > 1 and bench["numpy_keys_per_sec"] > 0,
          f"bench_lookup: {bench}")
    emit(phase="criteo_vocab_done", seconds=time.perf_counter() - t_phase)
    return counts


# ---- 16. the table store and the dynamic vocabulary at full width
STORE_VOCAB_SLACK = 8192      # rows reserved past each Tiny table: 450,560
STORE_VOCAB_STEPS = 24
STORE_VOCAB_EVERY = 4         # vocab_every, publish_every and the drift
STORE_VOCAB_DRIFT = 0.25      # share of a managed table's ranks each drift
STORE_VOCAB_ADMIT = 2
STORE_VOCAB_DECAY = 0.98
# Tiny's embedding configs whose tables the manager takes: the shared
# 10,000 x 8 (its hotness-1 and hotness-10 inputs), the four one-hot
# 10,000 x 8 and the two one-hot 100,000 x 16 (7 of 55 tables: the
# tracker's Python loop costs about 3 us a unique key, ROADMAP D9)
STORE_VOCAB_CONFIGS = (0, 6, 7)
STORE_VOCAB_SEED = 0
STORE_VOCAB_CONSUMER_SEED = 1


def managed_tiny_tables(tiny) -> list:
    """The global table ids of STORE_VOCAB_CONFIGS' tables in `tiny`."""
    out, start = [], 0
    for i, cfg in enumerate(tiny.embedding_configs):
        if i in STORE_VOCAB_CONFIGS:
            out.extend(range(start, start + cfg.num_tables))
        start += cfg.num_tables
    return out


def drifting_raw_batches(tiny, managed, steps) -> list:
    """`steps` + 1 batches of phase 5's power-law ids (alpha 1.05, seed
    STORE_VOCAB_SEED) whose managed tables' ids are raw keys: rank r of
    table t is the key ``r + 10^9 (1 + epoch_t[r])`` (bench.py's
    `run_vocab_bench`); before every STORE_VOCAB_EVERY-th batch a
    STORE_VOCAB_DRIFT share of each managed table's ranks, drawn by a
    second seeded generator, moves to fresh keys."""
    import numpy as np
    from distributed_embeddings_tpu_torch.models.synthetic import (
        InputGenerator, expand_embedding_configs)
    tables, table_map, _ = expand_embedding_configs(tiny)
    gen = InputGenerator(tiny, BATCH, alpha=1.05, num_batches=steps + 1,
                         seed=STORE_VOCAB_SEED)
    drift = np.random.RandomState(STORE_VOCAB_SEED + 1)
    epoch = {t: np.zeros((tables[t][0],), np.int64) for t in managed}
    out = []
    for i, (num, cats, labels) in enumerate(gen.batches):
        if i and i % STORE_VOCAB_EVERY == 0:
            for ep in epoch.values():
                ep[drift.choice(len(ep), int(len(ep) * STORE_VOCAB_DRIFT),
                                replace=False)] += 1
        cats = list(cats)
        for inp, t in enumerate(table_map):
            if t in epoch:
                ids = cats[inp].numpy().astype(np.int64)
                cats[inp] = ids + 10 ** 9 * (1 + epoch[t][ids])
        out.append((num, cats, labels))
    return out


def timed_method(obj, name) -> list:
    """Replace ``obj.name`` by a wrapper that records each call's host ms
    in the returned list."""
    real = getattr(obj, name)
    sink = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            sink.append((time.perf_counter() - t0) * 1e3)
    setattr(obj, name, timed)
    return sink


class MaintainHold:
    """Phase 16's holds around every `VocabManager.maintain` cycle (the
    instance's method replaced): before the cycle, each managed table's
    bound keys, their rows on the card and its stash; after it, each
    evicted key's stash entry bit-equal to its row from before, each newly
    bound key's row zeros or its stashed row from before, bit for bit, its
    accumulator rows zero, and occupancy at most the high watermark. The
    cycle's host ms and its evictions, admissions and restores are
    kept."""

    def __init__(self, torch, mgr):
        self.torch, self.mgr = torch, mgr
        self.real = mgr.maintain
        mgr.maintain = self
        self.ms, self.cycles = [], []

    def __call__(self, params=None, opt_states=None):
        import numpy as np
        torch, mgr = self.torch, self.mgr
        before = {}
        for t, mv in mgr.vocabs.items():
            keys = mv.resident_keys()
            before[t] = (keys, mgr._gather_table_rows(
                t, np.asarray(mv.binding.lookup(keys))), dict(mv.stash))
        t0 = time.perf_counter()
        out = self.real(params, opt_states)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        cycle = {}
        for t, mv in mgr.vocabs.items():
            keys, rows, stash = before[t]
            now = mv.resident_keys()
            gone = ~np.isin(keys, now)
            if gone.any():
                kept = np.stack([mv.stash[int(k)] for k in keys[gone]])
                check(kept.tobytes() == rows[gone].tobytes(),
                      f"store_vocab: table {t}: a stashed row differs from "
                      "its row before the cycle")
            new = now[~np.isin(now, keys)]
            restored = 0
            if len(new):
                rows_new = np.asarray(mv.binding.lookup(new))
                got = mgr._gather_table_rows(t, rows_new)
                want = np.zeros_like(got)
                for i, k in enumerate(new.tolist()):
                    if k in stash:
                        want[i] = stash[k]
                        restored += 1
                check(got.tobytes() == want.tobytes(),
                      f"store_vocab: table {t}: a newly bound row is neither "
                      "zeros nor its stashed row")
                for bucket, flat, _, _ in mgr._flat_keys(t, rows_new):
                    rows_max = max(mgr.emb.plan.tp_buckets[bucket].rows_max,
                                   1)
                    acc = opt_states["tp"][bucket][0]
                    idx = torch.as_tensor(flat % rows_max, device=acc.device)
                    check(bool((acc.index_select(0, idx) == 0).all()),
                          f"store_vocab: table {t}: an admitted slot's "
                          "accumulator row is not zero")
            check(mv.occupancy <= mgr.high_watermark + 1e-9,
                  f"store_vocab: table {t}: occupancy {mv.occupancy} past "
                  f"the high watermark {mgr.high_watermark}")
            cycle[t] = {"evicted": int(gone.sum()), "admitted": len(new),
                        "restored": restored,
                        "occupancy": round(mv.occupancy, 4)}
        self.cycles.append(cycle)
        return out


class ConsumerHold:
    """Phase 16's consumer, an `on_step` callback of the publisher's `fit`:
    after every step it synchronizes and stamps the time; after a step
    that published, it polls the publish directory (`DeltaConsumer`) and
    holds every bucket of the consumer layer bit-equal to the publisher's
    (`torch.equal` on the card)."""

    def __init__(self, torch, store, cons):
        self.torch, self.store, self.cons = torch, store, cons
        self.stamps, self.versions = [], []
        # the publisher's table digests at each consumed version (phase 17)
        self.digests = {}

    def hold(self):
        torch = self.torch
        pub, con = self.store.emb, self.cons.store.emb
        for b, (a, c) in enumerate(zip(pub.tp, con.tp)):
            check(torch.equal(a, c), f"store_vocab: consumer bucket {b} "
                  f"differs from the publisher's at version "
                  f"{self.cons.store.version}")

    def poll(self):
        if self.store.version != self.cons.store.version:
            check(self.cons.poll(), "store_vocab: a publish the consumer "
                  "did not see")
            check(self.cons.store.version == self.store.version,
                  f"store_vocab: consumer at {self.cons.store.version}, "
                  f"publisher at {self.store.version}")
            self.hold()
            self.versions.append(self.cons.store.version)
            self.digests[self.store.version] = placement_digests(
                self.torch, self.store.emb)

    def on_step(self, step, model, loss):
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        self.poll()


@contextlib.contextmanager
def deterministic_sums(torch):
    """torch's deterministic algorithms for phase 16's two runs: Tiny's
    bucket 0 takes the dense update, whose `index_add_` the card's atomics
    otherwise add in another order each run (warn_only: an operation
    without a deterministic form runs as it is); uninitialized memory is
    not filled."""
    import warnings
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    det = getattr(torch.utils, "deterministic", None)
    fill = getattr(det, "fill_uninitialized_memory", None)
    torch.use_deterministic_algorithms(True, warn_only=True)
    if fill is not None:
        det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        if fill is not None:
            det.fill_uninitialized_memory = fill


# 16b: a serving fleet over phase 16's stream
STORE_FLEET_CACHE_ROWS = 262_144     # 16 MiB of slots at width 16
STORE_FLEET_REQUESTS = 8
STORE_FLEET_ROWS = 4096
STORE_FLEET_JOIN_AFTER = 3           # r1 joins after the third publish
# the router steps at every other publish: stepped at every one, 16b took
# about 150 s on the card (a canary step 16-33 s), past the 90 s allowed
STORE_FLEET_STEP_EVERY = 2
STORE_FLEET_TOL = dict(rtol=1e-6, atol=1e-7)
STORE_FLEET_SEEDS = {"r0": 2, "r1": 3}
STORE_FLEET_HOST_SPARE = 16 * 2**30


def fleet_budget(tiny) -> int:
    """The device budget (elements) that keeps Tiny's width-8 tables,
    with their vocabulary slack, on the card: every width-16 table, each
    larger than all of them, goes to host memory as one bucket."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        expand_embedding_configs)
    tables, _, _ = expand_embedding_configs(tiny)
    return sum((rows + STORE_VOCAB_SLACK) * w for rows, w in tables
               if w == 8)


def fleet_replica(torch, tiny, mgr_kw, registry, name, example):
    """One replica of 16b: an embedding-only engine over a full-size Tiny
    layer built as phase 16 builds it, with ``gpu_embedding_size`` =
    `fleet_budget` (its width-16 bucket in pinned host memory) and a
    STORE_FLEET_CACHE_ROWS-row `HotRowCache` over that bucket; a
    query-only `VocabManager` over the managed tables, the shared
    registry, ``replica=name``; warmed at STORE_FLEET_ROWS on `example`
    (raw keys, translated by the manager)."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SyntheticModel)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.vocab import VocabManager
    layer = SyntheticModel(
        tiny, device="cuda", vocab_slack=STORE_VOCAB_SLACK,
        gpu_embedding_size=fleet_budget(tiny),
        generator=torch.Generator(device="cuda").manual_seed(
            STORE_FLEET_SEEDS[name])).embedding
    engine = InferenceEngine(layer, device="cuda",
                             cache_capacity=STORE_FLEET_CACHE_ROWS,
                             vocab_manager=VocabManager(layer, **mgr_kw),
                             registry=registry, replica=name)
    engine.warmup([STORE_FLEET_ROWS],
                  example=engine.vocab.translate(example))
    return engine


def host_cats(cats) -> list:
    """A batch's categorical inputs as numpy arrays."""
    return [c.numpy() if hasattr(c, "numpy") else c for c in cats]


class FleetHold:
    """16b, an `on_step` callback of the publisher's `fit` after
    `ConsumerHold`: two replicas (`fleet_replica`) behind one
    `FleetRouter(pub_dir, canaries=1, reference_weights=...)`, the
    reference the publisher's `get_weights` at the version just published.
    r0 joins before the first publish; r1 after the STORE_FLEET_JOIN_AFTER-th
    (its catch-up through the snapshot and the deltas timed). After every
    STORE_FLEET_STEP_EVERY-th publish: `router.step()` promotes the
    version at parity 0.0; STORE_FLEET_REQUESTS requests of
    STORE_FLEET_ROWS rows of the step's raw keys go through
    `submit` / `flush` (launch counts to 0, drive, read; the publisher's
    counts restored after); each request's outputs `torch.equal` to the
    serving replica's layer forward with the cache scope off and within
    STORE_FLEET_TOL of the publisher's layer on the same query-only
    translation (the largest ulp gap kept)."""

    def __init__(self, torch, store, model, pub_dir, tiny, mgr_kw, batches,
                 counting):
        from distributed_embeddings_tpu_torch.fleet import FleetRouter
        from distributed_embeddings_tpu_torch.obs.registry import (
            MetricRegistry)
        t0 = time.perf_counter()
        self.torch, self.store, self.model = torch, store, model
        self.batches, self.counting = batches, counting
        self.registry = MetricRegistry()
        example = host_cats(batches[0][1])
        example = [c[:STORE_FLEET_ROWS] for c in example]
        self.engines = {}
        for name in ("r0", "r1"):
            t1 = time.perf_counter()
            self.engines[name] = fleet_replica(torch, tiny, mgr_kw,
                                               self.registry, name, example)
            emit(phase="store_fleet_replica", replica=name,
                 seconds=time.perf_counter() - t1,
                 pinned_bytes=self.engines[name].embedding
                 .pinned_host_bytes(), mem_available=mem_available())
        self.applies = {"snapshot": [], "delta": []}
        for eng in self.engines.values():
            self._time_applies(eng.store)
        self.router = FleetRouter(pub_dir, registry=self.registry,
                                  canaries=1,
                                  reference_weights=self.reference)
        self.router.add_replica("r0", self.engines["r0"])
        self.build_s = time.perf_counter() - t0
        pub_layer = model.embedding
        for eng in self.engines.values():
            layer = eng.embedding
            check([(p.table_id, p.bucket, p.row_offset, p.rows)
                   for p in layer.plan.tp_placements]
                  == [(p.table_id, p.bucket, p.row_offset, p.rows)
                      for p in pub_layer.plan.tp_placements]
                  and len(layer.offloaded_buckets) == 1
                  and list(eng.caches) == layer.offloaded_buckets,
                  f"store_fleet: the replica's plan differs from the "
                  f"publisher's, or offloads {layer.offloaded_buckets}")
        self.seen = store.version
        self.publishes = 0
        self.promotes, self.catch_up_s, self.seconds = [], None, 0.0
        self.launches = {k: 0 for k in read_counts(*counting)}
        self.forwards, self.max_ulp = 0, 0

    def _time_applies(self, store):
        real = store.apply_published

        def timed(path):
            t0 = time.perf_counter()
            info = real(path)
            self.applies[info["kind"]].append(time.perf_counter() - t0)
            return info
        store.apply_published = timed

    def reference(self, version):
        """The publisher's weights at `version`: the router steps right
        after a publish, so only the current version has them."""
        return self.store.get_weights() if version == self.store.version \
            else None

    def on_step(self, step, model, loss):
        self.poll(step)

    def poll(self, step):
        if self.store.version == self.seen:
            return
        self.seen = self.store.version
        self.publishes += 1
        t0 = time.perf_counter()
        saved = read_counts(*self.counting)
        try:
            if self.publishes == STORE_FLEET_JOIN_AFTER:
                t1 = time.perf_counter()
                self.router.add_replica("r1", self.engines["r1"])
                self.catch_up_s = time.perf_counter() - t1
                m = self.router._members["r1"]
                check(m.state == "serving"
                      and m.engine.store.version == self.router.pinned_version,
                      f"store_fleet: r1 {m.state} at v{m.engine.store.version}"
                      f", pinned v{self.router.pinned_version}")
            if self.publishes % STORE_FLEET_STEP_EVERY:
                return
            ev = self.router.step()["event"]
            check(ev is not None and ev["event"] == "promote"
                  and ev["version"] == self.store.version
                  and ev["parity_devs"] == [0.0],
                  f"store_fleet: at v{self.store.version} the router "
                  f"stepped {ev}; errors {self.router.errors}")
            self.promotes.append(ev["version"])
            t1 = time.perf_counter()
            self.serve(step)
            emit(phase="store_fleet_step", version=ev["version"],
                 catch_up_s=self.catch_up_s,
                 step_s=t1 - t0, serve_s=time.perf_counter() - t1)
        finally:
            restore_counts(saved, *self.counting)
            self.seconds += time.perf_counter() - t0

    def serve(self, step):
        torch = self.torch
        cats = host_cats(self.batches[step][1])
        reqs = [[c[i * STORE_FLEET_ROWS:(i + 1) * STORE_FLEET_ROWS]
                 for c in cats] for i in range(STORE_FLEET_REQUESTS)]
        batches = sum(m.batcher.batches
                      for m in self.router._members.values())
        set_counts(*self.counting)
        routed = [self.router.submit(r) for r in reqs]
        check(all(routed), f"store_fleet: shed {routed}")
        out = self.router.flush()
        torch.cuda.synchronize()
        counts = read_counts(*self.counting)
        forwards = sum(m.batcher.batches
                       for m in self.router._members.values()) - batches
        for k, v in counts.items():
            self.launches[k] += v
        self.forwards += forwards
        layer = self.engines["r0"].embedding
        for r, req in zip(routed, reqs):
            eng = self.engines[r.replica]
            ids = eng.vocab.translate(req)
            with torch.no_grad():
                plain = eng.embedding(ids)
                ref = self.model.embedding(ids)
            for i, (a, b, c) in enumerate(zip(out[r.handle], plain, ref)):
                check(torch.equal(a, b),
                      f"store_fleet: {r.replica}'s output {i} differs from "
                      "its layer's uncached forward")
                check(torch.allclose(a, c, **STORE_FLEET_TOL),
                      f"store_fleet: {r.replica}'s output {i} is off the "
                      "publisher's layer")
                self.max_ulp = max(self.max_ulp, max_ulp(torch, a, c))
        groups, _ = layer._exchange_groups_for_key(tuple(
            (1 if x.ndim == 1 else x.shape[1], False)
            for x in [ids[i] for i in layer.strategy.input_groups[1]]))
        on_card = sum(1 for g in groups if g.bucket not in layer.offloaded_buckets)
        want = {"lookup_combine": on_card}
        check(counts == per_step(want, forwards),
              f"store_fleet launches {counts} over {forwards} forwards, "
              f"want {want} a forward")

    def finish(self) -> dict:
        """The end checks and the printed line's fields."""
        router, reg = self.router, self.registry
        check(router.shed == 0 and router.errors == [],
              f"store_fleet: {router.shed} sheds, errors {router.errors}")
        for name, eng in self.engines.items():
            check(not eng.degraded_reasons(),
                  f"store_fleet: {name} degraded {eng.degraded_reasons()}")
            check(reg.counter("serve/poll_errors_total",
                              replica=name).value == 0,
                  f"store_fleet: {name} poll errors: {eng.last_poll_error}")
        caches = {}
        for name, eng in self.engines.items():
            (b, cache), = eng.caches.items()
            caches[name] = dict(bucket=b, hit_rate=cache.hit_rate,
                                hits=cache.hits, misses=cache.misses,
                                promotions=cache.promotions,
                                evictions=cache.evictions,
                                patched=cache.patched,
                                refreshes=cache.refreshes,
                                version=eng.store.version)
        return dict(publishes=self.publishes, promotes=self.promotes,
                    pinned_version=router.pinned_version,
                    step_every=STORE_FLEET_STEP_EVERY,
                    catch_up_s=self.catch_up_s, apply_s=self.applies,
                    caches=caches, launches=self.launches,
                    forwards=self.forwards, max_ulp_publisher=self.max_ulp,
                    pinned_bytes=sum(e.embedding.pinned_host_bytes()
                                     for e in self.engines.values()),
                    build_s=self.build_s, seconds=self.seconds,
                    stats=router.stats())


def store_vocab_model(torch, tiny, seed):
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SyntheticModel)
    return SyntheticModel(tiny, device="cuda", vocab_slack=STORE_VOCAB_SLACK,
                          generator=torch.Generator(device="cuda")
                          .manual_seed(seed))


def store_vocab_phase(torch, cuda_lookup, counted, consume=None) -> dict:
    """16: the table store and the dynamic vocabulary (ROADMAP A12) at full
    width. Full-size Tiny V3 built with ``vocab_slack=STORE_VOCAB_SLACK``
    (450,560 more rows), adagrad at TRAIN_LR, batches of BATCH rows of
    phase 5's power-law ids whose 7 managed tables (STORE_VOCAB_CONFIGS)
    take raw keys that drift (`drifting_raw_batches`). The publisher:
    ``fit(..., STORE_VOCAB_STEPS steps, store=TableStore(layer),
    publish_every=4, publish_dir=<temp>, vocab=VocabManager(7 tables,
    admit_threshold 2, decay 0.98), vocab_every=4)``, pipelined; launches
    4 / 1 / 1 a step (`lookup_combine` / `segment_sum_sorted` /
    `adagrad_rows`, as in phase 5); every maintain cycle held
    (`MaintainHold`); admissions and evictions both above 0. The consumer:
    a second full-size Tiny (another seed) polled after each publish
    (`ConsumerHold`), every bucket bit-equal to the publisher's at every
    applied version. Then a consumer-side manager loads the newest
    sidecar, and an engine over the consumer model (the publisher's MLP
    copied in: the stream carries tables) serves a BATCH-row request of
    raw keys with logits bit-equal to the publisher's engine;
    `restore_from_published` into the consumer equals the publisher's
    final tables; and the same steps from the same initial weights with
    ``pipelined=False`` and publishing off give bit-identical losses,
    tables and accumulators (both runs under `deterministic_sums`).
    Printed: the step median (steps with no maintain or publish), host ms
    of a step's translation with observation, of the store's observation
    and of a maintain cycle; each publish's seconds, kind and bytes, each
    apply's seconds; restore seconds, the version lag; admissions,
    evictions, occupancy and fallback hit rate by table; peak memory, the
    temp directory's free space before the phase and the bytes written.
    Then ``consume(publish_dir, versions, digests)`` (phase 17), whose
    launch counts by path join the phase's, before the directory goes.
    Returns the launch counts."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.store import (
        DeltaConsumer, TableStore, restore_from_published)
    from distributed_embeddings_tpu_torch.training import (
        fit, make_sparse_train_step)
    from distributed_embeddings_tpu_torch.vocab import (
        VocabManager, latest_vocab_state)
    t_phase = time.perf_counter()
    tiny = SYNTHETIC_MODELS["tiny"]
    managed = managed_tiny_tables(tiny)
    steps = STORE_VOCAB_STEPS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store")
    pub_dir = os.path.join(tmp, "stream")
    disk = shutil.disk_usage(tmp)._asdict()
    mgr_kw = dict(tables=managed, admit_threshold=STORE_VOCAB_ADMIT,
                  decay=STORE_VOCAB_DECAY)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        batches = drifting_raw_batches(tiny, managed, steps)
        data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = store_vocab_model(torch, tiny, STORE_VOCAB_SEED)
        layer = model.embedding
        initial = [table_digest(torch, t) for t in layer.tp]
        consumer = store_vocab_model(torch, tiny, STORE_VOCAB_CONSUMER_SEED)
        init, _ = make_sparse_train_step(model, "adagrad", lr=TRAIN_LR)
        state = init(model)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        slack = sum(c.get("vocab_slack", 0)
                    for c in layer.strategy.global_configs)
        check(slack == 55 * STORE_VOCAB_SLACK,
              f"store_vocab: {slack} slack rows")
        emit(phase="store_vocab_setup", path="store_vocab", tmp=tmp,
             disk_before=disk, data_s=data_s, build_s=build_s,
             managed_tables=managed, slack_rows=slack,
             buckets=[list(t.shape) for t in layer.tp],
             table_bytes=sum(t.numel() * 4 for t in layer.tp))

        store = TableStore(layer, opt_states=state["emb"])
        # 16b: the fleet's replicas hold their width-16 bucket pinned
        host_need = 2 * sum(t.numel() * 4 for t in layer.tp[1:])
        avail = mem_available()
        check(avail > host_need + STORE_FLEET_HOST_SPARE,
              f"store_fleet: {avail} bytes of host memory available, the "
              f"replicas pin {host_need} (+ {STORE_FLEET_HOST_SPARE} spare)")
        fleet = FleetHold(torch, store, model, pub_dir, tiny, mgr_kw,
                          batches, (cuda_lookup, *counted))
        mgr = VocabManager(layer, **mgr_kw)
        maint = MaintainHold(torch, mgr)
        translate_ms = timed_method(mgr, "translate")
        observe_ms = timed_method(store, "observe")
        publish_ms = timed_method(store, "publish")
        cstore = TableStore(consumer.embedding)
        apply_ms = timed_method(cstore, "apply_published")
        cons = DeltaConsumer(cstore, pub_dir)
        hold = ConsumerHold(torch, store, cons)

        # the main path: counts to 0, drive, read
        set_counts(cuda_lookup, *counted)
        set_native_calls()
        t0 = time.perf_counter()
        with deterministic_sums(torch):
            _, state, hist = fit(
                model, batches[:steps], steps, "adagrad", lr=TRAIN_LR,
                opt_state=state, store=store,
                publish_every=STORE_VOCAB_EVERY, publish_dir=pub_dir,
                vocab=mgr, vocab_every=STORE_VOCAB_EVERY, log_every=0,
                callbacks=[hold, fleet])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts(cuda_lookup, *counted)
        read_native_calls("store_vocab")
        want = {"lookup_combine": 4, "segment_sum_sorted": 1,
                "adagrad_rows": 1}
        check(counts == per_step(want, steps),
              f"store_vocab launches {counts}, want {want} per step")
        # a publish after the loop (the tail cycle's rebinds) is polled here
        hold.poll()
        hold.hold()
        fleet.poll(steps)
        emit(phase="main_path", path="store_fleet", mem_available=avail,
             requests=STORE_FLEET_REQUESTS, rows=STORE_FLEET_ROWS,
             cache_rows=STORE_FLEET_CACHE_ROWS, **fleet.finish(), ok=True)
        fleet_counts = dict(fleet.launches)
        del fleet
        gc.collect()
        published = hist["published"]
        kinds = [p["kind"] for p in published]
        check(kinds[0] == "snapshot" and set(kinds[1:]) == {"delta"}
              and len(kinds) >= steps // STORE_VOCAB_EVERY,
              f"store_vocab: published {kinds}")
        st = hist["vocab_stats"]
        check(st["admissions"] > 0 and st["evictions"] > 0,
              f"store_vocab: admissions {st['admissions']}, evictions "
              f"{st['evictions']}")
        losses = hist["loss"]
        check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
        # steps with neither a maintain cycle (at its start) nor a publish
        # (at its end): each one's wall time from the step before's end
        plain = [(hold.stamps[s] - hold.stamps[s - 1]) * 1e3
                 for s in range(1, steps)
                 if s % STORE_VOCAB_EVERY not in (0, STORE_VOCAB_EVERY - 1)]
        emit(phase="main_path", path="store_vocab", steps=steps,
             seconds=fit_s, launches=counts, losses=losses,
             step_median_ms=statistics.median(plain), step_ms=plain,
             samples_per_s=BATCH / (statistics.median(plain) / 1e3),
             consumer_versions=hold.versions, ok=True)
        files = sorted(os.listdir(pub_dir))
        written = sum(os.path.getsize(os.path.join(pub_dir, f))
                      for f in files)
        stats = cons.stats()
        emit(phase="store_vocab_stream", path="store_vocab",
             publishes=[{"kind": p["kind"], "version": p["version"],
                         "bytes": p["bytes"], "rows": p["rows"],
                         "seconds": ms / 1e3}
                        for p, ms in zip(published, publish_ms)],
             applies=[{"kind": a["kind"], "version": a["version"],
                       "bytes": a["bytes"], "rows": a["rows"],
                       "seconds": ms / 1e3}
                      for a, ms in zip(cons.applied, apply_ms)],
             snapshot_bytes=published[0]["bytes"],
             delta_bytes_mean=statistics.mean(
                 [p["bytes"] for p in published[1:]]),
             full_table_bytes=store.full_table_bytes(),
             files=len(files), bytes_written=written,
             sidecar_bytes=sum(os.path.getsize(os.path.join(pub_dir, f))
                               for f in files if f.startswith("vocab_")),
             version_lag_max=stats["staleness_versions_max"],
             staleness_s_max=stats["staleness_s_max"], ok=True)
        emit(phase="store_vocab_vocab", path="store_vocab",
             translate_observe_ms=translate_ms, store_observe_ms=observe_ms,
             maintain_ms=maint.ms, cycles=maint.cycles,
             admissions=st["admissions"], evictions=st["evictions"],
             occupancy=st["occupancy"],
             fallback_hit_rate=st["fallback_hit_rate"],
             tables={t: {k: s[k] for k in (
                 "capacity", "bound", "occupancy", "admissions", "evictions",
                 "fallback_hit_rate", "stashed")}
                 for t, s in st["tables"].items()}, ok=True)

        # the sidecar and the engines over raw keys
        mgr_c = VocabManager(consumer.embedding, **mgr_kw)
        side = latest_vocab_state(pub_dir, upto=cstore.version)
        check(side is not None, "store_vocab: no sidecar")
        mgr_c.load_state(side)
        for t in managed:
            check(mgr_c.vocabs[t].resident_keys().tobytes()
                  == mgr.vocabs[t].resident_keys().tobytes(),
                  f"store_vocab: table {t}: the sidecar's binding differs")
        with torch.no_grad():
            consumer.mlp.load_state_dict(model.mlp.state_dict())
        num, cats, _ = batches[steps]
        got = InferenceEngine(consumer, device="cuda",
                              vocab_manager=mgr_c).predict((num, cats))
        want_logits = InferenceEngine(model, device="cuda",
                                      vocab_manager=mgr).predict((num, cats))
        check(torch.equal(got, want_logits),
              "store_vocab: the consumer engine's logits differ")
        request_fallback = mgr_c.stats()["fallback_hit_rate"]

        # restore from the stream into the consumer
        t0 = time.perf_counter()
        rstore = restore_from_published(consumer.embedding, pub_dir)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(rstore.version == store.version,
              f"store_vocab: restored v{rstore.version}, published "
              f"v{store.version}")
        hold.hold()
        peak = torch.cuda.max_memory_allocated()
        versions, digests = hold.versions, hold.digests
        del consumer, cstore, cons, rstore, mgr_c, hold
        gc.collect()
        torch.cuda.empty_cache()

        # the serial control: the same steps from the same initial weights,
        # publishing off
        serial = store_vocab_model(torch, tiny, STORE_VOCAB_SEED)
        check([table_digest(torch, t) for t in serial.embedding.tp]
              == initial, "store_vocab: the serial model's initial tables "
              "differ")
        s_init, _ = make_sparse_train_step(serial, "adagrad", lr=TRAIN_LR)
        s_state = s_init(serial)
        t0 = time.perf_counter()
        with deterministic_sums(torch):
            _, s_state, s_hist = fit(
                serial, batches[:steps], steps, "adagrad", lr=TRAIN_LR,
                opt_state=s_state,
                vocab=VocabManager(serial.embedding, **mgr_kw),
                vocab_every=STORE_VOCAB_EVERY, log_every=0, pipelined=False)
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        check(s_hist["loss"] == losses, "store_vocab: serial losses differ")
        for b, (a, c) in enumerate(zip(layer.tp, serial.embedding.tp)):
            check(torch.equal(a, c),
                  f"store_vocab: serial bucket {b} differs")
            check(torch.equal(state["emb"]["tp"][b][0],
                              s_state["emb"]["tp"][b][0]),
                  f"store_vocab: serial accumulator {b} differs")
        emit(phase="store_vocab_check", path="store_vocab",
             engine_rows=BATCH, engine_bit_equal=True,
             request_fallback_hit_rate=request_fallback,
             restore_s=restore_s, restore_bit_equal=True,
             serial_s=serial_s, serial_bit_equal=True,
             max_memory_allocated=peak,
             seconds=time.perf_counter() - t_phase, ok=True)
        del serial, s_state, model, state, layer, store, mgr, batches
        gc.collect()
        torch.cuda.empty_cache()
        out = {"store_vocab": counts, "store_fleet": fleet_counts}
        if consume is not None:
            out.update(consume(pub_dir, versions, digests))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- 17. the serving tier across ranks (A13b) on phase 16's stream
STREAM_WORLD = 2
STREAM_WORLD_REQUESTS = 2          # a version: cached, then uncached
STREAM_WORLD_ROWS = 4096           # 16b's request
STREAM_WORLD_SEED = 5              # the layer's initial tables (overwritten)
STREAM_WORLD_REQUEST_SEED = 9      # the requests' power-law ids


def placement_digests(torch, layer) -> dict:
    """`table_digest` of each table slice this rank holds, by (global
    table id, first column): a host bucket's rows reduced on the card,
    so a layer at any world size and any plan compares table by table
    with another's."""
    out = {}
    for pl in layer.plan.tp_placements:
        if pl.rank != layer.rank:
            continue
        gtid = layer.strategy.table_groups[1][pl.table_id]
        part = layer.tp[pl.bucket][pl.row_offset:pl.row_offset + pl.rows,
                                   pl.col_start:pl.col_end]
        out[(gtid, pl.col_start)] = table_digest(torch, part,
                                                 device=torch.device("cuda"))
    return out


def stream_world_rank(rank, world, backend, init_method, out_dir):
    """One rank of phase 17 (see the module docstring): the spec (the
    publish directory, its versions, the requests) from
    ``out_dir/spec.pt``; the results to ``out_dir/rank<r>.pt``."""
    import hashlib

    import torch
    check("jax" not in sys.modules, f"rank {rank} imported jax")
    import torch.distributed as dist
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, SyntheticModel)
    from distributed_embeddings_tpu_torch.ops import (cuda_lookup,
                                                      cuda_sparse,
                                                      cuda_tiled)
    from distributed_embeddings_tpu_torch.parallel.mesh import (
        initialize_distributed)
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    from distributed_embeddings_tpu_torch.tools import cuda_feature_probe
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (world + 1)))
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    initialize_distributed(backend, init_method, world, rank)
    counted = (cuda_sparse, cuda_tiled, cuda_feature_probe)
    try:
        spec = torch.load(os.path.join(out_dir, "spec.pt"),
                          weights_only=False)
        tiny = SYNTHETIC_MODELS["tiny"]
        t0 = time.perf_counter()
        layer = SyntheticModel(
            tiny, device=dev, vocab_slack=STORE_VOCAB_SLACK,
            gpu_embedding_size=fleet_budget(tiny),
            generator=torch.Generator(device=dev).manual_seed(
                STREAM_WORLD_SEED)).embedding
        engine = InferenceEngine(layer, device=dev,
                                 cache_capacity=STORE_FLEET_CACHE_ROWS)
        plain = InferenceEngine(layer, device=dev)
        for eng in (engine, plain):
            eng.warmup([STREAM_WORLD_ROWS], example=spec["requests"][0])
        torch.cuda.synchronize()
        out = {"build_s": time.perf_counter() - t0,
               "offloaded": layer.offloaded_buckets,
               "buckets": [(list(t.shape), t.device.type)
                           for t in layer.tp],
               "pinned_bytes": layer.pinned_host_bytes(), "versions": []}
        # the main path: counts to 0, drive, read
        set_counts(cuda_lookup, *counted)
        per = len(spec["requests"]) // len(spec["versions"])
        for n, v in enumerate(spec["versions"]):
            t1 = time.perf_counter()
            infos = engine.poll_updates(spec["pub_dir"], upto=v)
            torch.cuda.synchronize()
            apply_s = time.perf_counter() - t1
            row = {"version": v, "apply_s": apply_s,
                   "infos": [(i["kind"], i["version"]) for i in infos],
                   "store_version": engine.store.version,
                   "degraded": sorted(engine.degraded_reasons()),
                   "poll_error": engine.last_poll_error,
                   "digests": placement_digests(torch, layer),
                   "cached_ms": [], "plain_ms": [], "equal": []}
            for req in spec["requests"][n * per:(n + 1) * per]:
                t1 = time.perf_counter()
                got = engine.predict(req)
                torch.cuda.synchronize()
                row["cached_ms"].append((time.perf_counter() - t1) * 1e3)
                t1 = time.perf_counter()
                want = plain.predict(req)
                torch.cuda.synchronize()
                row["plain_ms"].append((time.perf_counter() - t1) * 1e3)
                row["equal"].append(all(torch.equal(a, b)
                                        for a, b in zip(got, want)))
            row["cache"] = engine.cache_stats()
            row["slot_keys"] = {
                b: hashlib.sha256(c._slot_keys.tobytes()).hexdigest()
                for b, c in engine.caches.items()}
            out["versions"].append(row)
        out["counts"] = read_counts(cuda_lookup, *counted)
        out["forwards"] = 2 * len(spec["requests"])
        out["update_stats"] = engine.update_stats(spec["pub_dir"])
        check("jax" not in sys.modules, f"rank {rank} imported jax")
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def stream_world_phase(torch, pub_dir, versions, digests) -> dict:
    """Phase 17 (see the module docstring), on phase 16's publish
    directory: `stream_world_rank` on STREAM_WORLD ranks, held against
    the publisher's digests at each of its `versions`. Returns the launch
    counts by path (summed over the ranks)."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator)
    t_phase = time.perf_counter()
    tiny = SYNTHETIC_MODELS["tiny"]
    backend = ("nccl" if torch.cuda.device_count() >= STREAM_WORLD
               else "gloo")
    requests = [[c.numpy() for c in cats] for _, cats, _ in InputGenerator(
        tiny, STREAM_WORLD_ROWS, alpha=1.05,
        num_batches=STREAM_WORLD_REQUESTS * len(versions),
        seed=STREAM_WORLD_REQUEST_SEED)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream")
    try:
        torch.save({"pub_dir": pub_dir, "versions": list(versions),
                    "requests": requests}, os.path.join(tmp, "spec.pt"))
        t0 = time.perf_counter()
        ranks = spawn_ranks(torch, stream_world_rank, STREAM_WORLD, backend,
                            tmp, "world2_stream")
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, res in enumerate(ranks):
        check(len(res["offloaded"]) == 1 and res["buckets"][
            res["offloaded"][0]][1] == "cpu",
            f"stream_world: rank {r} offloads {res['offloaded']} of "
            f"{res['buckets']}")
    first = versions[0]
    for i, v in enumerate(versions):
        rows = [res["versions"][i] for res in ranks]
        want = [("snapshot" if v == first else "delta", v)]
        for r, row in enumerate(rows):
            check(row["infos"] == want and row["store_version"] == v
                  and not row["degraded"] and row["poll_error"] is None,
                  f"stream_world: rank {r} at version {v}: applied "
                  f"{row['infos']}, store {row['store_version']}, degraded "
                  f"{row['degraded']}, {row['poll_error']}")
            check(all(row["equal"]), f"stream_world: rank {r} at version "
                  f"{v}: cached outputs differ from the uncached engine's")
        check(rows[0]["cache"] == rows[1]["cache"]
              and rows[0]["slot_keys"] == rows[1]["slot_keys"],
              f"stream_world: the ranks' caches differ at version {v}: "
              f"{rows[0]['cache']} / {rows[1]['cache']}")
        held = {}
        for row in rows:
            check(not set(held) & set(row["digests"]),
                  f"stream_world: two ranks hold a table at version {v}")
            held.update(row["digests"])
        check(held == digests[v], f"stream_world: table digests at version "
              f"{v} differ from the publisher's: "
              f"{sorted(k for k in digests[v] if held.get(k) != digests[v][k])}")
    counts = {}
    for res in ranks:
        for k, c in res["counts"].items():
            counts[k] = counts.get(k, 0) + c
    forwards = sum(res["forwards"] for res in ranks)
    check(counts["lookup_combine"] == 2 * forwards
          and sum(counts.values()) == counts["lookup_combine"],
          f"stream_world launches {counts} over {forwards} rank forwards, "
          "want lookup_combine 2 a forward (the width-8 bucket's groups)")
    check(ranks[0]["update_stats"] == ranks[1]["update_stats"],
          "stream_world: the ranks' update_stats differ")
    last = ranks[0]["versions"][-1]["cache"]["buckets"]
    applies = ranks[0]["versions"]
    emit(phase="main_path", path="world2_stream", world=STREAM_WORLD,
         backend=backend, versions=list(versions),
         rows=STREAM_WORLD_ROWS, requests_a_version=STREAM_WORLD_REQUESTS,
         launches=counts, forwards=forwards,
         hit_rate=[res["versions"][-1]["cache"]["hit_rate"]
                   for res in ranks],
         hit_rate_by_version=[row["cache"]["hit_rate"] for row in applies],
         promotions=[b["promotions"] for b in last.values()],
         evictions=[b["evictions"] for b in last.values()],
         cached_ms=[ms for row in applies for ms in row["cached_ms"]],
         uncached_ms=[ms for row in applies for ms in row["plain_ms"]],
         cached_median_ms=statistics.median(
             ms for row in applies for ms in row["cached_ms"]),
         uncached_median_ms=statistics.median(
             ms for row in applies for ms in row["plain_ms"]),
         snapshot_apply_s=[res["versions"][0]["apply_s"] for res in ranks],
         delta_apply_s=[[row["apply_s"] for row in res["versions"][1:]]
                        for res in ranks],
         build_s=[res["build_s"] for res in ranks],
         pinned_bytes=[res["pinned_bytes"] for res in ranks],
         update_stats=ranks[0]["update_stats"], ranks_s=ranks_s,
         seconds=time.perf_counter() - t_phase, ok=True)
    return {"world2_stream": counts}


# ---- 18. lookahead training (A14) at world 1
LOOKAHEAD_STEPS = 6          # held steps a depth
LOOKAHEAD_TIMED = 4          # then timed, outside `deterministic_sums`
LOOKAHEAD_SEED = 0


def lookahead_digests(torch, model, state) -> list:
    """Each bucket's and each accumulator's `table_digest`, on the card."""
    return ([table_digest(torch, t) for t in model.embedding.tp]
            + [table_digest(torch, s[0]) for s in state["emb"]["tp"]])


def lookahead_run(torch, cuda_lookup, counted, batches, label, **kw):
    """LOOKAHEAD_STEPS synchronized steps of a fresh full Tiny through a
    `LookaheadEngine` (`kw`) under `deterministic_sums`, counts to 0
    first; then LOOKAHEAD_TIMED more, timed, outside it (its deterministic
    `index_add_` takes ~170 ms of a step); then two under the profiler
    (`profile_step`). Returns (losses, digests after each held step, the
    timed steps' ms, the held steps' launches, the engine stats after the
    timed steps, and for a patching run the host ms of the engine's two
    host walks on the first two batches and the stale share they give,
    else None)."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, SyntheticModel)
    from distributed_embeddings_tpu_torch.schedule import LookaheadEngine
    model = SyntheticModel(SYNTHETIC_MODELS["tiny"], device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(LOOKAHEAD_SEED))
    eng = LookaheadEngine(model, "adagrad", lr=TRAIN_LR, **kw)
    eng.init()
    torch.cuda.synchronize()
    losses, digests, times = [], [], []
    set_counts(cuda_lookup, *counted)
    with deterministic_sums(torch):
        for i in range(LOOKAHEAD_STEPS):
            loss = eng.step(batches[i], batches[i + 1])
            losses.append(float(loss))
            digests.append(lookahead_digests(torch, model, eng.opt_state))
    counts = read_counts(cuda_lookup, *counted)
    for i in range(LOOKAHEAD_STEPS, LOOKAHEAD_STEPS + LOOKAHEAD_TIMED):
        t0 = time.perf_counter()
        eng.step(batches[i], batches[i + 1])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    stats = dict(eng.stats)
    at = {"i": LOOKAHEAD_STEPS + LOOKAHEAD_TIMED}

    def step_once():
        i = at["i"]
        eng.step(batches[i], batches[i + 1])
        at["i"] += 1
    profile_step(torch, step_once, label)
    host_ms = None
    if kw.get("lookahead") and not kw.get("stale_ok"):
        emb = model.embedding
        ids = [[c.numpy() for c in batches[i][1]] for i in (0, 1)]
        t0 = time.perf_counter()
        touched = emb.touched_row_keys(ids[0])
        t1 = time.perf_counter()
        stale = emb.prefetch_stale_mask(ids[1], touched)
        t2 = time.perf_counter()
        host_ms = {"touched_row_keys": (t1 - t0) * 1e3,
                   "prefetch_stale_mask": (t2 - t1) * 1e3,
                   "stale_share": float(stale.mean())}
    return losses, digests, times, counts, stats, host_ms


def lookahead_phase(torch, cuda_lookup, counted) -> dict:
    """Phase 18 (see the module docstring). Returns the launch counts by
    path."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator)
    t_phase = time.perf_counter()
    batches = list(InputGenerator(
        SYNTHETIC_MODELS["tiny"], BATCH, alpha=1.05,
        num_batches=LOOKAHEAD_STEPS + LOOKAHEAD_TIMED + 3, seed=0))
    runs = {}
    for label, kw in (("lookahead0", dict(lookahead=0)),
                      ("lookahead1", dict(lookahead=1,
                                          patch_capacity=BATCH))):
        runs[label] = lookahead_run(torch, cuda_lookup, counted, batches,
                                    label, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    (l0, d0, t0_ms, c0, _, _), (l1, d1, t1_ms, c1, st, host_ms) = (
        runs["lookahead0"], runs["lookahead1"])
    check(l0 == l1, f"lookahead: losses {l1} differ from depth 0's {l0}")
    for i, (a, b) in enumerate(zip(d0, d1)):
        check(a == b, f"lookahead: step {i}: the tables or accumulators "
              "differ from depth 0's")
    check(all(map(math.isfinite, l1)), f"non-finite losses {l1}")
    want0 = {"lookup_combine": 4, "segment_sum_sorted": 1,
             "adagrad_rows": 1}
    check(c0 == per_step(want0, LOOKAHEAD_STEPS),
          f"lookahead0 launches {c0}, want {want0} a step")
    check(c1["segment_sum_sorted"] == LOOKAHEAD_STEPS
          and c1["adagrad_rows"] == LOOKAHEAD_STEPS
          and c1["lookup_combine"] >= 4 * LOOKAHEAD_STEPS
          and sum(c1.values()) == c1["lookup_combine"]
          + 2 * LOOKAHEAD_STEPS,
          f"lookahead1 launches {c1}")
    # the stale run: a fresh model, no patch
    ls, _, ts_ms, cs, sts, _ = lookahead_run(
        torch, cuda_lookup, counted, batches, "lookahead1_stale_ok",
        lookahead=1, stale_ok=True)
    check(all(map(math.isfinite, ls)) and sts["patched_steps"] == 0,
          f"lookahead stale_ok: losses {ls}, stats {sts}")
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="main_path", path="lookahead", steps=LOOKAHEAD_STEPS,
         timed_steps=LOOKAHEAD_TIMED, batch=BATCH, losses=l1,
         bit_equal=True,
         step_ms={"lookahead0": t0_ms, "lookahead1": t1_ms,
                  "stale_ok": ts_ms},
         step_median_ms={"lookahead0": statistics.median(t0_ms),
                         "lookahead1": statistics.median(t1_ms),
                         "stale_ok": statistics.median(ts_ms)},
         launches={"lookahead0": c0, "lookahead1": c1, "stale_ok": cs},
         launches_a_step={k: {n: c / LOOKAHEAD_STEPS for n, c in v.items()
                              if c}
                          for k, v in (("lookahead0", c0),
                                       ("lookahead1", c1),
                                       ("stale_ok", cs))},
         patched_samples_a_step=st["patched_samples"] / (
             LOOKAHEAD_STEPS + LOOKAHEAD_TIMED),
         patched_steps=st["patched_steps"],
         fallback_recomputes=st["cold_fills"] + st["patch_overflows"],
         host_ms=host_ms, stats=st, stale_ok_losses=ls, stale_ok_stats=sts,
         stale_ok_max_loss_gap=max(abs(a - b) for a, b in zip(ls, l0)),
         seconds=time.perf_counter() - t_phase, ok=True)
    return {"lookahead0": c0, "lookahead1": c1, "lookahead1_stale_ok": cs}


# ---- 19. observability (A15a) at world 1
OBS_STEPS = 8                # fit steps of the bit-equality pair (the
                             # tier-1 rules want 8 train/step spans)
OBS_PUBLISH_EVERY = 4        # two versions, each through to serving
OBS_PROD_STEPS = 16          # steps a run of the production-route pair
                             # (a fit's first ~4 steps are slower)
OBS_REQUESTS = 4             # served through a MicroBatcher, one a forward
OBS_REQUEST_ROWS = 4096
OBS_SEED = 0
OBS_CONSUMER_SEED = 1
OBS_SPAN_REPS = 5000         # spans timed alone for their host cost
OBS_RULES = os.path.join(REPO, "distributed_embeddings_tpu_torch", "tools",
                         "slo_tier1.json")
# a Prometheus text line: name, optional labels, value
PROM_LINE = re.compile(r'^[a-zA-Z0-9_:]+(\{([a-zA-Z0-9_]+="(\\.|[^"\\])*")'
                       r'(,[a-zA-Z0-9_]+="(\\.|[^"\\])*")*\})? \S+$')


class StepStamps:
    """`fit` callback: after every step it synchronizes and stamps the
    time (the same in every run of phase 19)."""

    def __init__(self, torch):
        self.torch, self.stamps = torch, []

    def on_train_begin(self, model):
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def on_step(self, step, model, loss):
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())

    def plain_ms(self, publish_every=0):
        """Each step's ms, less the steps a run publishing every
        `publish_every` publishes after."""
        return [(self.stamps[s + 1] - self.stamps[s]) * 1e3
                for s in range(len(self.stamps) - 1)
                if not publish_every or (s + 1) % publish_every]


def obs_fit_run(torch, cuda_lookup, counted, batches, model=None,
                state=None, pub_dir=None, registry=None, logdir=None,
                deterministic=True):
    """One `fit` over `batches` (a fresh full Tiny from OBS_SEED, or
    `model` with its optimizer `state`), counts to 0 first; under
    `deterministic_sums` unless `deterministic` is false; with `pub_dir`,
    publishing every OBS_PUBLISH_EVERY steps there through a
    `TableStore`; with `logdir`, inside `utils.profiling.trace(logdir)`.
    Returns (model, optimizer state, history, launches, the step stamps,
    seconds)."""
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, SyntheticModel)
    from distributed_embeddings_tpu_torch.store import TableStore
    from distributed_embeddings_tpu_torch.training import fit
    from distributed_embeddings_tpu_torch.utils import profiling
    if model is None:
        model = SyntheticModel(SYNTHETIC_MODELS["tiny"], device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(OBS_SEED))
    store = None if pub_dir is None else TableStore(model.embedding)
    stamps = StepStamps(torch)
    torch.cuda.synchronize()
    set_counts(cuda_lookup, *counted)
    t0 = time.perf_counter()
    capture = (profiling.trace(logdir) if logdir is not None
               else contextlib.nullcontext())
    det = (deterministic_sums(torch) if deterministic
           else contextlib.nullcontext())
    with det, capture:
        _, state, hist = fit(model, batches, len(batches), "adagrad",
                             lr=TRAIN_LR, opt_state=state, store=store,
                             publish_every=OBS_PUBLISH_EVERY if store
                             else None, publish_dir=pub_dir,
                             registry=registry, log_every=0,
                             callbacks=[stamps])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(cuda_lookup, *counted)
    del store
    return model, state, hist, counts, stamps, seconds


def span_host_us(obs) -> float:
    """µs of host time one empty span costs (registry histogram, flight
    recorder edges, `record_function` and the NVTX range), outside any
    profiler; the recorder is reset after."""
    reg = obs.MetricRegistry()
    with obs.span("warm", reg):
        pass
    t0 = time.perf_counter()
    for _ in range(OBS_SPAN_REPS):
        with obs.span("obs/overhead", reg):
            pass
    us = (time.perf_counter() - t0) / OBS_SPAN_REPS * 1e6
    obs.reset_default_recorder()
    return us


def obs_lineage_ok(rec, versions) -> dict:
    """Each published version's lineage phases in the recorder's order;
    fails unless every one runs commit -> publish -> scan -> apply ->
    serve."""
    want = ["commit", "publish", "scan", "apply", "serve"]
    phases = {v: [] for v in versions}
    for ph, _, _, _, cat, eid, args in rec.events():
        if cat == "version" and eid in phases:
            phases[eid].append((args or {}).get("phase"))
    check(all(p == want for p in phases.values()),
          f"obs: lineage {phases}, want {want} for every version")
    check(rec.lineage_open_versions() == [],
          f"obs: lineage still open {rec.lineage_open_versions()}")
    return phases


def obs_attribute(obs, logdir, reg, what: str) -> dict:
    """`obs.attribution.attribute_logdir` of a capture of `fit`, onto
    `reg`; fails unless the identity holds exactly in integer ns and
    ``train/step`` (with its nested spans) has device time. Returns the
    attribution with ``parse_s``, ``train_step_s`` and
    ``unattributed_dtoh_s`` (the part of the unattributed time that is
    device-to-host copies) added."""
    t0 = time.perf_counter()
    att = obs.attribution.attribute_logdir(logdir, registry=reg)
    att["parse_s"] = time.perf_counter() - t0
    ns = att["ns"]
    check(sum(ns["spans"].values()) + ns["unattributed"] == ns["total"],
          f"obs: {what}: attribution identity broken: {ns}")
    step_ns = sum(v for p, v in ns["spans"].items()
                  if p == "train/step" or p.startswith("train/step/"))
    check(step_ns > 0 and att["op_source"] == "device",
          f"obs: {what}: train/step has {step_ns} ns of device time "
          f"({att['op_source']})")
    att["train_step_s"] = step_ns / 1e9
    att["unattributed_dtoh_s"] = sum(
        sec for n, sec in att["unattributed_top_ops"] if "DtoH" in n)
    return att


def emit_attribution(att: dict, path: str, route: str):
    """The `obs_attribution` line of one capture."""
    emit(phase="obs_attribution", path=path, route=route,
         device_s_by_span=dict(sorted(att["spans"].items(),
                                      key=lambda kv: -kv[1])),
         unattributed_s=att["unattributed_seconds"],
         unattributed_dtoh_s=att["unattributed_dtoh_s"],
         unattributed_other_s=att["unattributed_seconds"]
         - att["unattributed_dtoh_s"],
         unattributed_top_ops=[[n[:80], sec] for n, sec
                               in att["unattributed_top_ops"]],
         ambiguous_s=att["ambiguous_seconds"],
         total_s=att["total_device_seconds"],
         train_step_s=att["train_step_s"],
         coverage_frac=att["coverage_frac"],
         device_ops=att["device_op_count"],
         launch_matched=att["launch_matched"], placement=att["placement"],
         collectives=att["collectives"],
         categories_s=att["categories_seconds"],
         top_ops=[[n[:80], sec] for n, sec in att["top_ops"]],
         span_windows=att["span_window_count"], trace_file=att["trace_file"],
         parse_s=att["parse_s"], ok=True)


def obs_phase(torch, cuda_lookup, counted) -> dict:
    """19: observability (ROADMAP A15a) at full width. Full-size Tiny V3,
    adagrad at TRAIN_LR, batches of BATCH power-law rows (alpha 1.05,
    seed 0).

    The bit-equality pair, under `deterministic_sums`: OBS_STEPS steps of
    ``fit(registry=reg, store=TableStore(layer),
    publish_every=OBS_PUBLISH_EVERY, publish_dir=<temp>)`` inside
    `utils.profiling.trace(logdir)` (launches 4 / 1 / 1 a ``train/step``
    span; its capture attributed by span as the deterministic control,
    `obs_attribute`). A second full Tiny in an
    `InferenceEngine(registry=reg)` polls the stream (every bucket's
    digest the publisher's) and serves OBS_REQUESTS requests of
    OBS_REQUEST_ROWS rows through a `MicroBatcher` on the same registry
    (4 launches a ``serve/predict`` span, outputs equal to the
    publisher's engine's on the same requests). Then: the port's tier-1
    rule file gives no finding; the flight recorder's export balances;
    each published version's lineage runs commit -> publish -> scan ->
    apply -> serve; the JSONL line and the Prometheus dump parse; the
    ``exchange/*`` gauges equal a fresh `exchange_padding_report`. Then
    the same steps from the same seed with ``registry=None``, no profiler
    and no store (it reads the tables and writes none; the snapshot's
    write and read are most of the phase's time): every loss and every
    bucket's and accumulator's digest equal.

    The production pair, on the control's model and state, the route a
    user's `fit` takes (no `deterministic_sums`): OBS_PROD_STEPS steps
    with a registry of their own inside the profiler, then as many with
    neither. The two differ in the telemetry alone, so their step ms
    give its overhead; the first's capture is the step's device time by
    span on the production route, the backward's kernels (launched from
    autograd's own thread) placed through the thread of their forward.
    Launches 4 / 1 / 1 a step in each.

    Printed: each capture's device seconds by span, unattributed (and its
    device-to-host copies apart), ambiguous and total, the placement
    rules, the top device ops; the step ms of all four runs (publishing
    steps left out); one span's host µs and the phase's seconds. Returns
    the launch counts (``obs_fit``, ``obs_serve``,
    ``obs_fit_production``)."""
    from distributed_embeddings_tpu_torch import obs
    from distributed_embeddings_tpu_torch.models.synthetic import (
        SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
    from distributed_embeddings_tpu_torch.serving.batcher import MicroBatcher
    from distributed_embeddings_tpu_torch.serving.engine import (
        InferenceEngine)
    t_phase = time.perf_counter()
    tiny = SYNTHETIC_MODELS["tiny"]
    batches = list(InputGenerator(tiny, BATCH, alpha=1.05,
                                  num_batches=OBS_STEPS, seed=0))
    # the production pair takes them over again
    prod_batches = (batches * -(-OBS_PROD_STEPS // OBS_STEPS))[
        :OBS_PROD_STEPS]
    num, cats, _ = InputGenerator(tiny, BATCH, alpha=1.05, num_batches=1,
                                  seed=1)[0]
    requests = [(num[i * OBS_REQUEST_ROWS:(i + 1) * OBS_REQUEST_ROWS],
                 [c[i * OBS_REQUEST_ROWS:(i + 1) * OBS_REQUEST_ROWS]
                  for c in cats]) for i in range(OBS_REQUESTS)]
    span_us = span_host_us(obs)
    want = {"lookup_combine": 4, "segment_sum_sorted": 1, "adagrad_rows": 1}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs")
    try:
        pub_dir = os.path.join(tmp, "stream")
        logdir = os.path.join(tmp, "profile")
        reg = obs.MetricRegistry()
        obs.reset_default_recorder()
        # the instrumented run: counts to 0, drive, read
        model, state, hist, fit_counts, stamps, fit_s = obs_fit_run(
            torch, cuda_lookup, counted, batches[:OBS_STEPS],
            pub_dir=pub_dir, registry=reg, logdir=logdir)
        digests = lookahead_digests(torch, model, state)
        del state
        snap = reg.snapshot()
        steps = snap["histograms"]["span_seconds{span=train/step}"]["count"]
        check(steps == OBS_STEPS and hist["metrics_snapshot"] == snap
              and "metrics_error" not in hist,
              f"obs: {steps} train/step spans, metrics_error "
              f"{hist.get('metrics_error')}")
        labels = [k for k in snap["histograms"]
                  if k.startswith("span_seconds{span=train/step/update/")]
        check(labels == ["span_seconds{span=train/step/update/pallas+xla}"],
              f"obs: update spans {labels}, want Tiny's two routes "
              "(bucket 0 dense, bucket 1 by rows)")
        check(fit_counts == per_step(want, steps),
              f"obs_fit launches {fit_counts}, want {want} a train/step span")
        check(all(map(math.isfinite, hist["loss"])),
              f"non-finite losses {hist['loss']}")
        versions = [p["version"] for p in hist["published"]]
        check(versions == [1, 2], f"obs: published versions {versions}")
        att = obs_attribute(obs, logdir, reg, "deterministic control")
        # the exchange gauges against a fresh report at the run's batch
        rep = model.embedding.exchange_padding_report(batch=BATCH)
        gauges = reg.snapshot()["gauges"]
        bad = [f for f in obs.instrument.EXCHANGE_GAUGE_FIELDS
               if gauges[f"exchange/{f}"] != rep[f]]
        bad += [f"{f}{{group={gi}}}" for gi, e in enumerate(rep["groups"])
                for f in obs.instrument.EXCHANGE_GROUP_GAUGE_FIELDS
                if gauges[f"exchange/{f}{{bucket={e['bucket']},group={gi}}}"]
                != e[f]]
        check(not bad, f"obs: exchange gauges differ from the report: {bad}")
        # the publisher's engine on the same requests: the reference
        ref_engine = InferenceEngine(model, device="cuda")
        ref_batcher = MicroBatcher(ref_engine, max_batch=OBS_REQUEST_ROWS)
        handles = [ref_batcher.submit(r) for r in requests]
        ref = ref_batcher.flush()
        ref_out = [ref[h].cpu() for h in handles]
        mlp = {k: v.detach().cpu() for k, v in model.mlp.state_dict().items()}
        del model, ref_engine, ref_batcher, ref
        gc.collect()
        torch.cuda.empty_cache()

        # the consumer: a second Tiny polls the stream, then serves
        t0 = time.perf_counter()
        consumer = SyntheticModel(tiny, device="cuda",
                                  generator=torch.Generator(device="cuda")
                                  .manual_seed(OBS_CONSUMER_SEED))
        consumer.mlp.load_state_dict(mlp)
        engine = InferenceEngine(consumer, device="cuda", registry=reg)
        applied = [i["version"] for i in engine.poll_updates(pub_dir)]
        torch.cuda.synchronize()
        poll_s = time.perf_counter() - t0
        check(applied == versions and not engine.degraded_reasons(),
              f"obs: the engine applied {applied}, degraded "
              f"{sorted(engine.degraded_reasons())}")
        got = [table_digest(torch, t) for t in consumer.embedding.tp]
        check(got == digests[:len(got)],
              "obs: the consumer's tables differ from the publisher's")
        batcher = MicroBatcher(engine, max_batch=OBS_REQUEST_ROWS,
                               registry=reg)
        set_counts(cuda_lookup, *counted)
        handles = [batcher.submit(r) for r in requests]
        out = batcher.flush()
        torch.cuda.synchronize()
        serve_counts = read_counts(cuda_lookup, *counted)
        served = [out[h].cpu() for h in handles]
        predicts = reg.snapshot()["histograms"][
            "span_seconds{span=serve/predict}"]["count"]
        check(serve_counts == per_step({"lookup_combine": 4}, predicts)
              and predicts == OBS_REQUESTS,
              f"obs_serve launches {serve_counts} over {predicts} "
              "serve/predict spans, want 4 each")
        check(all(tuple(o.shape) == (OBS_REQUEST_ROWS, 1)
                  and bool(torch.isfinite(o).all())
                  and torch.equal(o, r) for o, r in zip(served, ref_out)),
              "obs: served logits differ from the publisher's engine's")
        del engine, batcher, consumer, out
        gc.collect()
        torch.cuda.empty_cache()

        # the registry's outputs: rules, recorder, lineage, exports
        final = reg.snapshot()
        findings = obs.evaluate_rules(obs.load_rules(OBS_RULES), final)
        check(not findings, f"obs: SLO findings {[f.fid for f in findings]}")
        rec = obs.default_recorder()
        doc = rec.to_chrome_trace()
        depth = {}
        for ev in doc["traceEvents"]:
            if ev["ph"] in "BE":
                depth[ev["tid"]] = depth.get(ev["tid"], 0) + (
                    1 if ev["ph"] == "B" else -1)
                check(depth[ev["tid"]] >= 0, "obs: an E without its B")
        opened = sorted(e["id"] for e in doc["traceEvents"] if e["ph"] == "b")
        closed = sorted(e["id"] for e in doc["traceEvents"] if e["ph"] == "e")
        check(not any(depth.values()) and opened == closed,
              f"obs: the recorder's export does not balance: {depth}, "
              f"{opened} / {closed}")
        trace_path = os.path.join(tmp, "recorder.json")
        rec.export(trace_path)
        with open(trace_path) as f:
            json.load(f)
        lineage = obs_lineage_ok(rec, versions)
        jsonl = os.path.join(tmp, "metrics.jsonl")
        reg.export_jsonl(jsonl, extra={"source": "chip_smoke"}, fsync=True)
        with open(jsonl) as f:
            line = json.loads(f.read().splitlines()[-1])
        prom = reg.to_prometheus()
        bad = [ln for ln in prom.splitlines()
               if not ln.startswith("#") and not PROM_LINE.match(ln)]
        check(line["counters"] == final["counters"] and not bad,
              f"obs: the exports do not parse: {bad[:3]}")
        shutil.rmtree(pub_dir, ignore_errors=True)

        # the control: the same steps, no registry, no profiler (and no
        # store: publishing reads the tables and writes none)
        model, state, chist, ctrl_counts, cstamps, ctrl_s = obs_fit_run(
            torch, cuda_lookup, counted, batches[:OBS_STEPS])
        check(chist["loss"] == hist["loss"],
              f"obs: losses with the registry and profiler {hist['loss']} "
              f"differ from without {chist['loss']}")
        check(lookahead_digests(torch, model, state) == digests,
              "obs: the tables or accumulators differ with the registry "
              "and profiler")
        check(ctrl_counts == fit_counts,
              f"obs: control launches {ctrl_counts} != {fit_counts}")

        # the production pair on the control's model: the telemetry on,
        # then off
        prod_log = os.path.join(tmp, "profile_production")
        preg = obs.MetricRegistry()
        model, state, phist, prod_counts, pstamps, prod_s = obs_fit_run(
            torch, cuda_lookup, counted, prod_batches,
            model=model, state=state, registry=preg, logdir=prod_log,
            deterministic=False)
        model, state, qhist, plain_counts, qstamps, plain_s = obs_fit_run(
            torch, cuda_lookup, counted, prod_batches,
            model=model, state=state, deterministic=False)
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
        for what, h, c in (("production", phist, prod_counts),
                           ("production control", qhist, plain_counts)):
            check(c == per_step(want, OBS_PROD_STEPS),
                  f"obs {what} launches {c}, want {want} a step")
            check(all(map(math.isfinite, h["loss"])),
                  f"obs {what}: non-finite losses {h['loss']}")
        patt = obs_attribute(obs, prod_log, preg, "production")
        check(patt["placement"].get("forward_thread", 0) > 0,
              f"obs: production: no backward kernel placed through its "
              f"forward's thread (placement {patt['placement']})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step_ms = stamps.plain_ms(OBS_PUBLISH_EVERY)
    ctrl_ms = cstamps.plain_ms(OBS_PUBLISH_EVERY)
    prod_ms, plain_ms = pstamps.plain_ms(), qstamps.plain_ms()
    emit_attribution(att, "obs_fit", "deterministic_sums")
    emit_attribution(patt, "obs_fit_production", "production")
    emit(phase="main_path", path="obs", steps=OBS_STEPS, batch=BATCH,
         losses=hist["loss"], bit_equal=True,
         production_steps=OBS_PROD_STEPS,
         production_losses=phist["loss"] + qhist["loss"],
         launches={"obs_fit": fit_counts, "obs_serve": serve_counts,
                   "control": ctrl_counts,
                   "obs_fit_production": prod_counts,
                   "production_control": plain_counts},
         spans={"train/step": steps, "serve/predict": predicts},
         step_ms={"instrumented": step_ms, "control": ctrl_ms,
                  "production_instrumented": prod_ms,
                  "production_control": plain_ms},
         step_median_ms={"instrumented": statistics.median(step_ms),
                         "control": statistics.median(ctrl_ms),
                         "production_instrumented":
                         statistics.median(prod_ms),
                         "production_control": statistics.median(plain_ms)},
         telemetry_overhead_ms=statistics.median(prod_ms)
         - statistics.median(plain_ms),
         span_host_us=span_us, span_host_us_a_step=2 * span_us,
         fit_s={"instrumented": fit_s, "control": ctrl_s,
                "production_instrumented": prod_s,
                "production_control": plain_s},
         poll_s=poll_s, versions=versions,
         lineage={str(v): p for v, p in lineage.items()},
         recorder_events=len(doc["traceEvents"]),
         recorder_dropped=rec.dropped, slo_findings=0,
         prometheus_lines=len(prom.splitlines()),
         gauges={k: v for k, v in final["gauges"].items()
                 if k.startswith(("kernels/", "train/", "device/total",
                                  "device/unattributed", "store/"))},
         counters=final["counters"],
         seconds=time.perf_counter() - t_phase, ok=True)
    return {"obs_fit": fit_counts, "obs_serve": serve_counts,
            "obs_fit_production": prod_counts}


def start_native_build(loader) -> dict:
    """`native.loader.build` in a thread of its own; `finish_native_build`
    joins it."""
    import threading
    out: dict = {}

    def run():
        t0 = time.perf_counter()
        try:
            out["path"] = loader.build()
        except Exception as e:  # noqa: BLE001 - raised when joined
            out["error"] = e
        out["seconds"] = time.perf_counter() - t0
    out["thread"] = threading.Thread(target=run, daemon=True)
    out["thread"].start()
    return out


def finish_native_build(loader, build) -> dict:
    """Join the native build and load the library; prints the `native`
    line (its path, the hash in its name, the flags, the g++ version, the
    build's seconds). Returns that line's fields."""
    build["thread"].join()
    if "error" in build:
        raise SmokeFailure(f"the native host library did not build: "
                           f"{build['error']}")
    loader.load()
    path = build["path"]
    fields = dict(library=os.path.relpath(path, REPO),
                  hash=os.path.basename(path)[len("det_native-"):-3],
                  sources=[os.path.relpath(os.path.join(loader.NATIVE_DIR,
                                                        f), REPO)
                           for f in loader.SOURCES],
                  flags=list(loader.CXX_FLAGS), gxx=loader.gxx_version())
    emit(phase="native", build_s=build["seconds"], **fields)
    return fields


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

    # ---- 2a. the feature ladder: every rung printed, then held; sgd_rows'
    # variants (timed in phases 9 and 10) build in the background meanwhile
    emit(phase="nvcc", release=kernel_build.nvcc_version())
    sgd_builds = start_sgd_rows_builds(kernel_build)
    # the native host library (g++) builds beside the ladder's nvccs
    from distributed_embeddings_tpu_torch.native import loader
    native_build = start_native_build(loader)
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
    native_lib = finish_native_build(loader, native_build)
    # the one-hot kernel's instantiations: registers and spills
    one_hot_usage = {k: u for k, u in kernel_build.ptxas_usage(
        "lookup_combine").items() if "one_hot_kernel" in k}
    check(one_hot_usage, "no one_hot_kernel in lookup_combine's build log")
    one_hot_spills = sorted(k for k, u in one_hot_usage.items()
                            if u["spill_bytes"])
    emit(phase="one_hot_ptxas", kernels=one_hot_usage, spills=one_hot_spills)
    # sgd_rows' instantiations, and those of its variants
    sgd_usage = sgd_rows_usage(kernel_build.ptxas_usage("sparse_apply"))
    check(sgd_usage, "no sgd_rows_kernel in sparse_apply's build log")
    sgd_spills = sorted(k for k, u in sgd_usage.items() if u["spill_bytes"])
    emit(phase="sgd_rows_ptxas", kernels=sgd_usage, spills=sgd_spills,
         variants={tag: sgd_rows_usage(u) for tag, (_, u)
                   in finish_variant_builds(sgd_builds).items()})

    # ---- 3. kernels against their plain versions
    worst = max(kernel_cases(torch, cuda_lookup),
                one_hot_cases(torch, cuda_lookup))
    sparse_worst = sparse_kernel_cases(torch, cuda_sparse, sparse_update)
    sparse_worst["sgd_rows"] = max(sparse_worst["sgd_rows"],
                                   sgd_rows_edge_cases(torch, cuda_sparse))
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
    serve_latency = {}
    for req in requests:
        rows = req[0].shape[0]
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            engine.predict(req)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times[2:])
        serve_latency[rows] = med * 1e3
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
    captured = lookup_args(cap.calls)
    check(len(captured) == 4, f"{len(captured)} groups captured, want 4")
    tiny_worst, totals = tiny_bucket_kernels(torch, cuda_lookup, captured,
                                             rate)
    emit(phase="tiny_kernel_total", hbm_bytes_per_s=rate, **totals)
    # 11a at Tiny's four multi-hot groups, while its buckets live: the
    # mixed-precision forms of the kernel on the same calls
    amp_tiny = amp_kernel_cases(torch, cuda_lookup, captured, rate, "tiny")

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

    # step time, synchronized; the peak from here on is the steps' (the
    # held steps' comparisons above ran on the card too)
    torch.cuda.reset_peak_memory_stats()
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
        if kind == "sgd":
            for b, call in enumerate(cap.calls):
                sgd_rows_sweep(torch, cuda_sparse, call, f"cut_tiny_{b}")
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
    fit_counts, dlrm_kernels, f32_fit = dlrm_fit_phase(
        torch, cuda_lookup, cuda_sparse, counted, rate)
    dlrm_counts.update(fit_counts)
    dlrm_counts["convergence"] = convergence_phase(torch, cuda_lookup,
                                                   counted)

    # ---- 8. world size > 1: W ranks on the card(s), each held against the
    # world-1 trainer; counts to 0 in each rank, drive, read
    world_counts = {}
    for config, world, model_kw, strategy in WORLD_RUNS:
        world_counts[f"world{world}_{config}"] = world_phase(
            torch, config, world, model_kw, strategy)

    # ---- 10. the placement groups at world size > 1: DLRM with dp,
    # column-sliced tp and row-sliced tables on 2 ranks; counts to 0 in
    # each rank, drive, read
    placement_counts, placement_kernels, f32_exchange = placement_phase(
        torch, cuda_lookup, cuda_sparse, counted, serve_latency)
    world_counts[f"world{PLACEMENT_WORLD}_placement"] = placement_counts

    # ---- 11. mixed precision (compute_dtype bfloat16): DLRM against the
    # CPU trainer and its engine against a CPU engine (11b), DLRM x 0.4
    # through `fit` (11c) with the kernel's forms at its shapes (11a) and
    # its engine timed (11d), the placement groups at W = 2 (11e); counts
    # to 0, drive, read in each
    amp_counts = {"dlrm_amp_against_cpu": dlrm_against_cpu_phase(
        torch, cuda_lookup, cuda_sparse, counted, compute_dtype=AMP_DTYPE)}
    fit_amp_counts, amp_dlrm = dlrm_amp_fit_phase(
        torch, cuda_lookup, cuda_sparse, counted, rate, f32_fit)
    amp_counts.update(fit_amp_counts)
    amp_counts[f"world{PLACEMENT_WORLD}_placement_amp"], amp_row = (
        amp_placement_phase(torch, f32_exchange))

    # ---- 12. quantized storage and checkpoints: DLRM x 0.02 at int8 and
    # fp8 (and int8 at bfloat16) and cut Tiny's adagrad at int8 against the
    # CPU (12a); DLRM at the full Criteo-1TB sizes stored int8 through
    # `fit`, its AUC, engine, a held step and a row delta (12b); resume and
    # the global weights (12c); counts to 0, drive, read in each
    quant_counts = quantized_against_cpu_phase(torch, cuda_lookup, counted)
    full_counts, _ = quantized_full_phase(torch, cuda_lookup, counted)
    quant_counts.update(full_counts)
    quant_counts.update(checkpoint_phase(torch, cuda_lookup, counted))

    # ---- 13. the wire formats and hot rows: full Tiny with a hot shard at
    # world 1 against the CPU, its step, profile, fit and engine (13a);
    # at W = 2 over the bf16-sr wire against world 1 (13b); the placement
    # DLRM x 0.02 over the bf16 wire at W = 2 (13c); counts to 0, drive,
    # read in each
    wire_counts = hot_tiny_phase(torch, cuda_lookup, cuda_sparse, counted)
    wire_counts.update(wire_world_phase(torch))

    # ---- 14. host offload: DLRM x 0.02 with its largest tables in host
    # memory against the same model all on the card, f32 and int8 (14a);
    # DLRM at the full Criteo-1TB sizes in float32 with its three largest
    # tables in pinned host memory through `fit`, its AUC and engine (14b);
    # counts to 0, drive, read in each
    offload_counts = offload_hold_phase(torch, cuda_lookup, counted)
    offload_counts.update(offload_full_phase(torch, cuda_lookup, counted))

    # ---- 15. the Criteo example's on-the-fly vocabulary flow at full
    # width: the keys through the C++ map and the numpy twin, 3 adam steps
    # against the CPU, pipelined against serial, --bench_lookup; counts
    # (and the native calls) to 0, drive, read
    vocab_counts = criteo_vocab_phase(torch, cuda_lookup, counted)

    # ---- 16. the table store and the dynamic vocabulary: full Tiny with
    # vocab slack trained through `fit` under a VocabManager while it
    # publishes row deltas a second Tiny on the card consumes bit for bit;
    # the engine over raw keys, the restore, the serial control; counts to
    # 0, drive, read
    # ---- 17. the serving tier across ranks: 2 ranks consume phase 16's
    # stream into full Tiny, cached over its offloaded bucket, held at
    # every version against the publisher's tables and the uncached engine
    store_counts = store_vocab_phase(
        torch, cuda_lookup, counted,
        consume=lambda pub_dir, versions, digests: stream_world_phase(
            torch, pub_dir, versions, digests))
    emit(phase="native", **native_lib, calls_by_path=NATIVE_CALLS)

    # ---- 18. lookahead training at world 1: full Tiny through the
    # pipeline at depth 1 bit-equal to depth 0, profiled both ways, and
    # stale_ok; counts to 0, drive, read in each run
    lookahead_counts = lookahead_phase(torch, cuda_lookup, counted)

    # ---- 19. observability: full Tiny through `fit(registry=)` under the
    # profiler, publishing to an engine on the same registry; device time
    # by span, the rules, the recorder, the lineage; bit-equal to the same
    # steps without; counts to 0, drive, read in each
    obs_counts = obs_phase(torch, cuda_lookup, counted)

    # ---- 7. result lines; the kernels of DLRM's step carry their times
    # at its shapes too (`at_dlrm_fit`), and at a row shard's of the
    # placement phase (`at_placement`); their worst error covers them
    def entry(kname, source, by_path, tot, err):
        at_dlrm = {}
        for key, timed in (("at_dlrm_fit", dlrm_kernels),
                           ("at_placement", placement_kernels)):
            if kname not in timed:
                continue
            d_tot, d_err = timed[kname]
            err = max(err, d_err)
            at_dlrm[key] = {"max_abs_err": d_err, **{
                k: d_tot[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "copy_ms")
                if k in d_tot}}
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
                **({k: tot[k] for k in ("chain_ms", "copy_ms") if k in tot}),
                **at_dlrm}

    paths = {"ladder": ladder_counts, "serve": serve_counts,
             "train_adagrad": train_counts,
             "train_sgd_cut": cut_counts["sgd"],
             "train_adam_cut": cut_counts["adam"],
             "train_fused": fused_counts,
             **{f"train_tiled_{k}": c for k, c in tiled_counts.items()},
             **dense_counts, **dlrm_counts, **world_counts, **amp_counts,
             **quant_counts, **wire_counts, **offload_counts,
             **vocab_counts, **store_counts, **lookahead_counts,
             **obs_counts}

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
    # the bf16 forms of lookup_combine, each timed at the call of the path
    # that runs it (11a): the store form at DLRM x 0.4's, the round-first
    # form at row shard 0's of 11e; ``at_other`` the form at 11a's other
    # calls, whose errors the row's max_abs_err covers
    amp_timed = {"dlrm_fit": amp_dlrm, "tiny": amp_tiny,
                 "row_shard": amp_row}
    for kname, where in (("lookup_combine_bf16", "dlrm_fit"),
                         ("lookup_combine_bf16_round", "row_shard")):
        tot = amp_timed[where][kname]
        row = entry(kname, "lookup_combine.cu", by_path(kname), tot,
                    max(t[kname]["max_abs_err"] for t in amp_timed.values()))
        row.update(f32_ms=tot["f32_ms"], timed_at=where, at_other={
            at: {k: t[kname][k] for k in (
                "ms", "f32_ms", "plain_ms", "bound_ms", "library_ms",
                "max_abs_err")}
            for at, t in amp_timed.items() if at != where})
        kernels.append(row)
    ladder_err = {rung["library"]: rung["max_abs_err"] for rung in matrix}
    for kname, tot in ladder_rows.items():
        kernels.append(entry(kname, f"{kname}.cu", by_path(kname), tot,
                             ladder_err[kname]))
    emit(phase="sorted_lookups_backward",
         max_abs_err=sorted_worst["lookups"], ok=True)
    # every form of lookup_combine shares one library: its one-hot
    # instantiations that spill; and sgd_rows' that spill
    for row in kernels:
        if row["name"].startswith("lookup_combine"):
            row["one_hot_spills"] = one_hot_spills
        if row["name"] == "sgd_rows":
            row["sgd_rows_spills"] = sgd_spills
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
