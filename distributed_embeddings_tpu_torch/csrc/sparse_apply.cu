// Sparse embedding-table updates for Hopper (sm_90a): the duplicate
// aggregation of a gradient stream and the row-wise optimizer updates over
// its deduplicated rows.
//
// segment_sum_sorted:
//   sums[s, :] = sum over j in [starts[s], starts[s+1]) of contribs[perm[j], :]
//   summed in ascending j; slots past the last segment (starts[s] ==
//   starts[s+1] == N) get zeros.
// Replaces no TPU kernel: it is XLA's `segment_sum` inside
// distributed_embeddings_tpu/ops/sparse_update.py `dedup_sum`, written by
// hand because CUDA `index_add_` sums with atomics in an order that changes
// from run to run (the same step would not give the same table twice). It
// also folds in the gather of the contribution rows by `perm`.
// Bound: bytes, about N*(4W + 8) + 4*N*W (read each contribution row and
// its perm/starts entries once, write each slot once), and the chain of
// dependent adds the order forces on the longest segment (about 4 cycles a
// row; segment_walk.cuh).
//
// sgd_rows / adagrad_rows / adam_rows, over the unique rows `rep` that
// dedup_sum produces (one read-modify-write per row, no conflicts, no
// atomics; rows with rep < 0 or rep >= V are skipped without reading their
// sums, the filler contract of pallas_scatter.py), each applying
// row_rules.cuh's rule to its row's slot of `sums` (lazy adam: every valid
// row is updated, even with s == 0).
// Replace, in distributed_embeddings_tpu/ops: pallas_tiled.py
// `_sgd_kernel` / `_adagrad_kernel` / `_adam_kernel` through `_update_call`
// (tiled_{sgd,adagrad,adam}_rows); pallas_scatter.py `_scatter_kernel`
// (scatter_add_sorted_unique is sgd_rows at lr = -1) and `_adagrad_kernel`
// (adagrad_rows_sorted_unique).
// Bound: bytes, about 4*N of rep plus 4*W*U*(1 + 2*(1 + n_state)) over the
// U valid rows (read the sums, read and write the table and each of its
// n_state state arrays: 0 for sgd, 1 for adagrad, 2 for adam).
// The TPU kernels walk every table tile (g_count = n_tiles + n_chunks,
// pallas_tiled.py:305-307) because a one-hot matmul was the TPU's fast
// scatter; here a thread group touches only the rows in `rep`.
//
// Design, as lookup_combine.cu: one thread group per slot, float4 column
// slices, every operation rounded on its own; the layout, the launch shape
// and the row rules are row_rules.cuh's, shared with sorted_stream.cu.
// segment_sum_sorted is segment_walk.cuh's walk, shared with the stream
// kernels: a power-law stream's hottest row is one long segment, whose
// sorted-order sum is a chain of one dependent add a row; segments of at
// most kLongRows rows are summed by their thread group, longer ones are
// deferred to a persistent long pass that streams them through a cp.async
// ring in shared memory, so the chain and the bytes, not the latency of
// each row's load, bound the kernel. One call: a memset of the worklist
// count, the short pass, the long pass (three CUDA launches).

#include "row_rules.cuh"
#include "segment_walk.cuh"

namespace {

using row_rules::AdamHp;
using row_rules::Group;
using row_rules::Vec;
using row_rules::group_of;
using row_rules::kThreads;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
segment_sum_sorted_kernel(const float* __restrict__ contribs, int64_t width,
                          const int64_t* __restrict__ perm,
                          const int64_t* __restrict__ starts, int64_t n,
                          float* __restrict__ sums, int64_t* scratch,
                          int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  const int64_t lo = starts[g.slot];
  const int64_t hi = starts[g.slot + 1];
  if (segment_walk::defer_long(lo, hi, g.lane, g.slot, scratch)) return;
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float acc[kVec];
    segment_walk::segment_total<kVec>(contribs, width, perm, lo, hi, c, acc);
    Vec<kVec>::store(sums + g.slot * width + c, acc);
  }
}

// The long pass: each worklist segment's total, written to its slot.
__global__ void __launch_bounds__(segment_walk::kLongThreads)
segment_sum_sorted_long_kernel(const float* __restrict__ contribs,
                               int64_t width, const int64_t* __restrict__ perm,
                               const int64_t* __restrict__ starts, int64_t n,
                               float* __restrict__ sums,
                               int64_t* scratch) {
  segment_walk::long_walk(
      contribs, width, perm, starts, scratch,
      [=](int64_t slot, int64_t, int64_t col, float total) {
        sums[slot * width + col] = total;
      });
}

// The table row of this group's slot, or -1 for a filler / negative id.
template <typename IdT>
__device__ __forceinline__ int64_t row_of(const IdT* rep, int64_t slot,
                                          int64_t vocab) {
  const int64_t r = static_cast<int64_t>(rep[slot]);
  return (r < 0 || r >= vocab) ? -1 : r;
}

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
sgd_rows_kernel(float* __restrict__ table, int64_t vocab, int64_t width,
                const IdT* __restrict__ rep, const float* __restrict__ sums,
                int64_t n, float neg_lr, int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  const int64_t r = row_of(rep, g.slot, vocab);
  if (r < 0) return;
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float s[kVec];
    Vec<kVec>::load(sums + g.slot * width + c, s);
    row_rules::sgd_row<kVec>(table + r * width + c, s, neg_lr);
  }
}

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
adagrad_rows_kernel(float* __restrict__ table, float* __restrict__ acc,
                    int64_t vocab, int64_t width, const IdT* __restrict__ rep,
                    const float* __restrict__ sums, int64_t n, float neg_lr,
                    float eps, int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  const int64_t r = row_of(rep, g.slot, vocab);
  if (r < 0) return;
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float s[kVec];
    Vec<kVec>::load(sums + g.slot * width + c, s);
    row_rules::adagrad_row<kVec>(table + r * width + c, acc + r * width + c,
                                 s, neg_lr, eps);
  }
}

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
adam_rows_kernel(float* __restrict__ table, float* __restrict__ mu,
                 float* __restrict__ nu, int64_t vocab, int64_t width,
                 const IdT* __restrict__ rep, const float* __restrict__ sums,
                 int64_t n, AdamHp hp, int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  const int64_t r = row_of(rep, g.slot, vocab);
  if (r < 0) return;
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float s[kVec];
    Vec<kVec>::load(sums + g.slot * width + c, s);
    row_rules::adam_row<kVec>(table + r * width + c, mu + r * width + c,
                              nu + r * width + c, s, hp);
  }
}

template <typename IdT>
int sgd_rows(float* table, int64_t vocab, int64_t width, const IdT* rep,
             const float* sums, int64_t n, float neg_lr, int vec4,
             void* stream) {
  ROW_RULES_LAUNCH(sgd_rows_kernel, IdT, n, width, vec4, stream, table, vocab,
                   width, rep, sums, n, neg_lr);
}

template <typename IdT>
int adagrad_rows(float* table, float* acc, int64_t vocab, int64_t width,
                 const IdT* rep, const float* sums, int64_t n, float neg_lr,
                 float eps, int vec4, void* stream) {
  ROW_RULES_LAUNCH(adagrad_rows_kernel, IdT, n, width, vec4, stream, table,
                   acc, vocab, width, rep, sums, n, neg_lr, eps);
}

template <typename IdT>
int adam_rows(float* table, float* mu, float* nu, int64_t vocab,
              int64_t width, const IdT* rep, const float* sums, int64_t n,
              float neg_lr, float b1, float omb1, float b2, float omb2,
              float c1, float c2, float eps, int vec4, void* stream) {
  const AdamHp hp{neg_lr, b1, omb1, b2, omb2, c1, c2, eps};
  ROW_RULES_LAUNCH(adam_rows_kernel, IdT, n, width, vec4, stream, table, mu,
                   nu, vocab, width, rep, sums, n, hp);
}

}  // namespace

// Plain C entry points, bound with ctypes. `vec4` selects float4 access and
// needs width % 4 == 0 and 16-byte aligned float pointers. Each returns
// cudaGetLastError() after its launch; none synchronizes.
// segment_sum_sorted_f32 also takes the walk's scratch (int64, 2 + at least
// n / (kLongRows + 1) entries) and the long pass's block count (the SM
// count), and returns the first error of its three launches.
extern "C" int segment_sum_sorted_f32(const float* contribs, int64_t width,
                                      const int64_t* perm,
                                      const int64_t* starts, int64_t n,
                                      float* sums, int vec4, int64_t* scratch,
                                      int workers, void* stream) {
  if (vec4)
    return segment_walk::launch(segment_sum_sorted_kernel<true>,
                                segment_sum_sorted_long_kernel, n, width,
                                vec4, scratch, workers, stream, contribs,
                                width, perm, starts, n, sums);
  return segment_walk::launch(segment_sum_sorted_kernel<false>,
                              segment_sum_sorted_long_kernel, n, width,
                              vec4, scratch, workers, stream, contribs, width,
                              perm, starts, n, sums);
}

#define ROW_ENTRY_POINTS(suffix, IdT)                                          \
  extern "C" int sgd_rows_f32_##suffix(float* table, int64_t vocab,           \
                                       int64_t width, const IdT* rep,         \
                                       const float* sums, int64_t n,          \
                                       float neg_lr, int vec4, void* stream) {\
    return sgd_rows<IdT>(table, vocab, width, rep, sums, n, neg_lr, vec4,     \
                         stream);                                             \
  }                                                                           \
  extern "C" int adagrad_rows_f32_##suffix(                                   \
      float* table, float* acc, int64_t vocab, int64_t width, const IdT* rep, \
      const float* sums, int64_t n, float neg_lr, float eps, int vec4,        \
      void* stream) {                                                         \
    return adagrad_rows<IdT>(table, acc, vocab, width, rep, sums, n, neg_lr,  \
                             eps, vec4, stream);                              \
  }                                                                           \
  extern "C" int adam_rows_f32_##suffix(                                      \
      float* table, float* mu, float* nu, int64_t vocab, int64_t width,       \
      const IdT* rep, const float* sums, int64_t n, float neg_lr, float b1,   \
      float omb1, float b2, float omb2, float c1, float c2, float eps,        \
      int vec4, void* stream) {                                               \
    return adam_rows<IdT>(table, mu, nu, vocab, width, rep, sums, n, neg_lr,  \
                          b1, omb1, b2, omb2, c1, c2, eps, vec4, stream);     \
  }

ROW_ENTRY_POINTS(i32, int32_t)
ROW_ENTRY_POINTS(i64, int64_t)
