// The segment walk of sparse_apply.cu's segment_sum_sorted and
// sorted_stream.cu's sgd_stream / adagrad_stream / adam_stream: the sum of
// a segment's contribution rows contribs[perm[j], :] for j ascending over
// [starts[s], starts[s+1]), each column 0 + c[perm[lo]] + ... +
// c[perm[hi-1]], every add __fadd_rn. The order is the contract: the plain
// versions add in it, and the strategies "sort" and "tiled" are pinned bit
// for bit to each other. No FMA, no tree, no partial sums, no atomics on the
// data.
//
// What bounds a walk: bytes (each contribution row read once, through perm),
// and, for a long segment, the chain of dependent adds its order forces: one
// add a row in every column, about 4 cycles, so 66,607 rows take about
// 0.135 ms at 1.98 GHz whatever else the card does. A thread group that
// loads perm[j], then the row it names, then adds, keeps about 4 rows in
// flight behind two dependent trips to device memory (about 1.3 us) and
// walks a long segment some 80x slower than that chain.
//
// So one call makes three CUDA launches on its stream:
//   1. a memset of the scratch's two counters (the scratch the wrapper
//      allocates: the worklist's count, the long pass's next entry);
//   2. the short pass: one thread group a slot (row_rules.cuh's layout); a
//      segment of at most kLongRows rows is summed by its group in
//      registers (`segment_total`); a longer one's slot is appended to the
//      worklist by the group's lane 0 and the group moves on;
//   3. the long pass: a persistent grid, one block a worker (the wrapper
//      passes the SM count); a block takes the next worklist entry (an
//      atomic counter) when its producers reach the end of the segment in
//      hand, so the block with the hottest row takes little else; each
//      segment is summed whole by one block, so neither the worklist's
//      order nor who takes what changes a bit of the result.
// Which segments are long is decided on the device: no host sync, so a
// CUDA graph can capture the call.
//
// The long pass streams a segment through a ring of stages in dynamic
// shared memory (ring_for: 256 rows a stage up to 32 columns, 32 rows at
// 128), each stage one chunk of at most kChunkCols columns stored column
// by column. Producer warps (kProducerWarps) take the ring's slots in
// turn: a producer warp loads the perm entries of its stage's rows (eight
// a lane at most), waits until the slot is free (its `empty` mbarrier),
// issues one 4-byte cp.async an element at the row perm names (a warp's
// copies read whole rows), and ends with `cp.async.mbarrier.arrive.noinc`
// on the slot's `full` mbarrier, which completes when the warp's copies
// have landed. Consumer warps (kConsumerWarps, one thread a column) wait
// on `full`, add the stage's rows in sorted order, four rows a float4
// load, and arrive on `empty`. The layout is the point: a row-major stage
// (16-byte copies) costs the adder one shared load a row and a round of
// barriers every few dozen rows, which on the card cost it about as much
// as the chain itself; a column-major stage of 256 rows spends one load on
// four rows and one round of barriers on 256. Hopper's TMA copies boxes at
// tensor coordinates and has no gather by a list of rows, so the row
// gather by perm is cp.async's job (the feature ladder's dyn_dma rung).
// Every wait traps after 1 s (probe_async.cuh), so a fault fails the
// launch instead of hanging it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_async.cuh"
#include "row_rules.cuh"

namespace segment_walk {

using row_rules::Vec;

// Segments of more rows than this go to the long pass. Chosen on the card
// among 32, 64, 128 and 256 on Tiny's step streams: 32 and 64 were the
// fastest, 256 the slowest.
constexpr int64_t kLongRows = 64;

constexpr int kChunkCols = 128;
constexpr int kConsumerWarps = kChunkCols / 32;
constexpr int kProducerWarps = 8;
constexpr int kLongThreads = 32 * (kConsumerWarps + kProducerWarps);
constexpr int kMaxStageRows = 256;
constexpr int kMaxStages = 8;
constexpr int kSegQueue = 16;
constexpr int64_t kStageBytes = 32 * 1024;
constexpr int64_t kRingBytes = 160 * 1024;

// The long pass's ring for a table `width` columns wide (its widest chunk
// of at most kChunkCols columns): `rows` a stage (a power of two, 32 to
// kMaxStageRows, the most whose stage fits kStageBytes), a stage stored
// column by column, `pitch` = rows + 4 floats a column (so a column's 4
// rows load as one float4 and neighbouring columns start 4 banks apart),
// and `stages` (a power of two, 2 to kMaxStages, the most that fit
// kRingBytes).
struct Ring {
  int rows, pitch, stages, stage_shift;
};

__host__ __device__ inline Ring ring_for(int64_t width) {
  const int64_t cols = width < kChunkCols ? width : kChunkCols;
  Ring r{kMaxStageRows, 0, kMaxStages, 0};
  while (r.rows > 32 && 4 * cols * (r.rows + 4) > kStageBytes) r.rows /= 2;
  r.pitch = r.rows + 4;
  while (r.stages > 2 && 4 * cols * r.pitch * r.stages > kRingBytes)
    r.stages /= 2;
  while ((1 << r.stage_shift) < r.stages) ++r.stage_shift;
  return r;
}

// Dynamic shared memory of the long pass: two mbarriers a stage, two a
// segment queue entry, the queue (slot, lo, hi), a perm buffer of
// kMaxStageRows entries a producer warp, then the ring.
__host__ __device__ inline int smem_bytes(int64_t width) {
  const int64_t cols = width < kChunkCols ? width : kChunkCols;
  const Ring r = ring_for(width);
  return static_cast<int>(16 * r.stages + 40 * kSegQueue +
                          8 * kProducerWarps * kMaxStageRows +
                          4 * cols * r.pitch * r.stages);
}

// The short pass: this thread's columns [c, c + kVec) of a segment's total.
template <int kVec>
__device__ __forceinline__ void segment_total(const float* contribs,
                                              int64_t width,
                                              const int64_t* perm, int64_t lo,
                                              int64_t hi, int64_t c,
                                              float (&acc)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int64_t j = lo; j < hi; ++j) {
    float v[kVec];
    Vec<kVec>::load(contribs + perm[j] * width + c, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
  }
}

// The walk's scratch, int64: the worklist's count (scratch[0], appended
// by the short pass), the long pass's next entry (scratch[1], taken by its
// blocks), then the worklist; the call's memset zeroes the first two.
// The short pass: true when [lo, hi) is longer than kLongRows, after lane 0
// of the group appended `slot` to the worklist.
__device__ __forceinline__ bool defer_long(int64_t lo, int64_t hi, int lane,
                                           int64_t slot, int64_t* scratch) {
  if (hi - lo <= kLongRows) return false;
  if (lane == 0) {
    const unsigned long long at = atomicAdd(
        reinterpret_cast<unsigned long long*>(scratch), 1ull);
    scratch[2 + at] = slot;
  }
  return true;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(probe::smem_addr(bar)) : "memory");
}

// Arrive on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(probe::smem_addr(bar)) : "memory");
}

// A 4-byte cp.async (through L1: a warp's copies read whole rows).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(probe::smem_addr(dst)), "l"(src) : "memory");
}

// One producer warp: the stage's `rows` rows of columns [c0, c0 + cols),
// their sorted positions' perm entries in `wperm`, into `stage`, column c
// at stage + c * pitch. Consecutive lanes copy consecutive columns of a
// row, so a warp reads whole rows; each lane steps through the elements
// without a division.
__device__ __forceinline__ void copy_rows(float* stage, int pitch,
                                          const float* contribs,
                                          int64_t width, int64_t c0, int cols,
                                          const int64_t* wperm, int rows,
                                          int lane) {
  const int total = rows * cols;
  const int drow = 32 / cols;
  const int dcol = 32 % cols;
  int row = lane / cols;
  int col = lane % cols;
  const float* base = contribs + c0;
  for (int e = lane; e < total; e += 32) {
    cp_async4(stage + col * pitch + row, base + wperm[row] * width + col);
    row += drow;
    col += dcol;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
}

// One consumer thread: `acc` plus its column's first `rows` rows of the
// stage (`col`: 16-byte aligned, rows contiguous), in order.
__device__ __forceinline__ float add_rows(const float* col, int rows,
                                          float acc) {
  int r = 0;
  for (; r + 32 <= rows; r += 32) {
#pragma unroll
    for (int q = 0; q < 32; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(col + r + q);
      acc = __fadd_rn(acc, v.x);
      acc = __fadd_rn(acc, v.y);
      acc = __fadd_rn(acc, v.z);
      acc = __fadd_rn(acc, v.w);
    }
  }
  for (; r < rows; ++r) acc = __fadd_rn(acc, col[r]);
  return acc;
}

// The long pass, the body of a kernel launched with kLongThreads threads a
// block and smem_bytes(width) of dynamic shared memory. For each worklist
// slot it calls finish(slot, lo, column, total) once a column, from the
// thread that owns the column. Every warp of a block walks the same
// sequence of stages (k counts them), so the ring's phases agree. Ring slot
// s is always filled by producer warp s % kProducerWarps, in order: when it
// waits for slot s to be free for the u-th time, its own (u-1)-th fill was
// consumed, so the `empty` barrier is at most one phase behind and a parity
// wait cannot mistake an older phase for the awaited one.
template <typename Finish>
__device__ __forceinline__ void long_walk(const float* contribs, int64_t width,
                                          const int64_t* perm,
                                          const int64_t* starts,
                                          int64_t* scratch, Finish finish) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring ring = ring_for(width);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + ring.stages;
  uint64_t* seg_full = empty + ring.stages;
  uint64_t* seg_empty = seg_full + kSegQueue;
  int64_t* segs = reinterpret_cast<int64_t*>(seg_empty + kSegQueue);
  int64_t* perms = segs + 3 * kSegQueue;
  float* stages = reinterpret_cast<float*>(perms + kProducerWarps *
                                           kMaxStageRows);
  const int64_t stage_floats =
      int64_t{ring.pitch} * (width < kChunkCols ? width : kChunkCols);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      probe::mbar_init(full + s, 32);
      probe::mbar_init(empty + s, kConsumerWarps);
    }
    for (int q = 0; q < kSegQueue; ++q) {
      probe::mbar_init(seg_full + q, 1);
      probe::mbar_init(seg_empty + q, kConsumerWarps + kProducerWarps - 1);
    }
    probe::fence_mbar_init();
  }
  __syncthreads();
  const bool consumer = warp < kConsumerWarps;
  const bool lead = warp == kConsumerWarps;
  const uint32_t producer = static_cast<uint32_t>(warp - kConsumerWarps);
  int64_t* wperm = perms + (warp - kConsumerWarps) * kMaxStageRows;
  uint32_t k = 0;
  for (uint32_t m = 0;; ++m) {
    // segment m: lane 0 of the lead producer warp takes the next worklist
    // entry and publishes it in queue entry q; the other warps read it
    const uint32_t q = m & (kSegQueue - 1);
    const uint32_t round = (m / kSegQueue) & 1;
    int64_t* entry = segs + 3 * q;
    if (lead) {
      probe::mbar_wait(seg_empty + q, round ^ 1);
      if (lane == 0) {
        const unsigned long long i = atomicAdd(
            reinterpret_cast<unsigned long long*>(scratch + 1), 1ull);
        const int64_t taken =
            i < static_cast<unsigned long long>(scratch[0]) ? scratch[2 + i]
                                                            : -1;
        entry[0] = taken;
        entry[1] = taken < 0 ? 0 : starts[taken];
        entry[2] = taken < 0 ? 0 : starts[taken + 1];
        mbar_arrive(seg_full + q);
      }
      __syncwarp();
    } else {
      probe::mbar_wait(seg_full + q, round);
    }
    const int64_t slot = entry[0];
    const int64_t lo = entry[1];
    const int64_t hi = entry[2];
    if (!lead) {
      __syncwarp();
      if (lane == 0) mbar_arrive(seg_empty + q);
    }
    if (slot < 0) break;
    for (int64_t c0 = 0; c0 < width; c0 += kChunkCols) {
      const int cols = static_cast<int>(
          width - c0 < kChunkCols ? width - c0 : kChunkCols);
      float acc = 0.f;
      for (int64_t j0 = lo; j0 < hi; j0 += ring.rows, ++k) {
        const int rows = static_cast<int>(
            hi - j0 < ring.rows ? hi - j0 : ring.rows);
        const uint32_t s = k & (ring.stages - 1);
        const uint32_t parity = (k >> ring.stage_shift) & 1;
        float* stage = stages + s * stage_floats;
        if (consumer) {
          probe::mbar_wait(full + s, parity);
          if (threadIdx.x < cols)
            acc = add_rows(stage + threadIdx.x * ring.pitch, rows, acc);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + s);
        } else if (s % kProducerWarps == producer) {
          // the perm loads are in flight while the warp waits for the slot
          int64_t p[kMaxStageRows / 32];
#pragma unroll
          for (int b = 0; b < kMaxStageRows / 32; ++b) {
            const int r = b * 32 + lane;
            p[b] = r < rows ? perm[j0 + r] : 0;
          }
          probe::mbar_wait(empty + s, parity ^ 1);
#pragma unroll
          for (int b = 0; b < kMaxStageRows / 32; ++b)
            if (b * 32 < rows) wperm[b * 32 + lane] = p[b];
          __syncwarp();
          copy_rows(stage, ring.pitch, contribs, width, c0, cols, wperm, rows,
                    lane);
          cp_async_arrive(full + s);
          __syncwarp();
        }
      }
      if (consumer && threadIdx.x < cols)
        finish(slot, lo, c0 + threadIdx.x, acc);
    }
  }
}

// One call: reset the worklist's count, the short pass over n slots
// (short_k(args..., scratch, lane_shift), row_rules.cuh's launch shape), the
// long pass (long_k(args..., scratch) on `workers` blocks), all on `stream`.
// Returns the first CUDA error, or 0; cudaErrorInvalidValue when the grid
// would not fit or workers < 1.
template <typename ShortK, typename LongK, typename... A>
int launch(ShortK short_k, LongK long_k, int64_t n, int64_t width, int vec4,
           int64_t* scratch, int workers, void* stream, A... args) {
  int shift;
  unsigned blocks;
  if (workers < 1 || !row_rules::grid_for(n, width, vec4, &shift, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  short_k<<<blocks, row_rules::kThreads, 0, s>>>(args..., scratch, shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = smem_bytes(width);
  err = cudaFuncSetAttribute(long_k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  long_k<<<workers, kLongThreads, bytes, s>>>(args..., scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segment_walk

// The threshold, for the wrappers' worklist sizing: at most
// n / (kLongRows + 1) segments of n rows are long.
extern "C" int64_t segment_walk_long_rows() {
  return segment_walk::kLongRows;
}
