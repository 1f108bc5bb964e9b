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
// Design, as lookup_combine.cu: float4 column slices of a row to a thread
// group of `lanes = min(32, ceil(W / 4))` threads, every operation rounded
// on its own; the layout and the row rules are row_rules.cuh's, shared
// with sorted_stream.cu. adagrad_rows and adam_rows give each slot its own
// group (row_rules.cuh's launch shape).
// sgd_rows walks the slots instead: dedup_sum's `rep` has N slots with its
// U valid rows first and fillers after them (most of the slots on a
// power-law batch), and a valid row's update waits on its `rep` load.
// Each warp walks passes of 32 slots: one `rep` load a lane (the loads of
// kRepAhead passes in flight together), a ballot of the valid ones (32
// fillers cost one load and one ballot), their rows and slots compacted
// in shared memory; then the warp's groups take the valid rows kSgdRows
// at a time, and each thread issues every `sums` load (streaming: read
// once) and every table load of its rows before it adds and stores, so it
// has 2 * kSgdRows loads in flight. A pass is dealt to the G warps in runs
// of the rows a warp's groups take at once (kSgdRows * 32 / lanes, at
// most 32): run q of warp w is run q * G + w, so a valid prefix spreads
// over every warp (at W >= 128 each run is 4 slots), and the rows taken
// at once are neighbouring slots, whose `sums` rows are contiguous. The
// grid is the blocks the card holds at once (the occupancy query times
// the SM count, read once and cached), capped at a warp a run of the
// call's slots. Invalid slots are skipped wherever they lie in `rep`.
// segment_sum_sorted is segment_walk.cuh's walk, shared with the stream
// kernels: a power-law stream's hottest row is one long segment, whose
// sorted-order sum is a chain of one dependent add a row; segments of at
// most kLongRows rows are summed by their thread group, longer ones are
// deferred to a persistent long pass that streams them through a cp.async
// ring in shared memory, so the chain and the bytes, not the latency of
// each row's load, bound the kernel. One call: a memset of the worklist
// count, the short pass, the long pass (three CUDA launches).

#include <algorithm>
#include <atomic>

#include "row_rules.cuh"
#include "segment_walk.cuh"

namespace {

using row_rules::AdamHp;
using row_rules::Group;
using row_rules::Vec;
using row_rules::group_of;
using row_rules::kThreads;

constexpr int kWarps = kThreads / 32;
// valid rows a thread group of sgd_rows takes at once (2 * kSgdRows loads
// in flight a thread), and the passes whose `rep` loads a warp issues
// together
constexpr int kSgdRows = 4;
constexpr int kRepAhead = 4;
static_assert((kSgdRows & (kSgdRows - 1)) == 0,
              "sgd_rows deals a pass in runs of kSgdRows groups' rows: a "
              "power of two, so that runs tile the warp's 32 slots");

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

// A row of `sums` is read once and never again: streaming loads.
__device__ __forceinline__ void load_once(const float* p, float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_once(const float* p, float (&v)[1]) {
  v[0] = __ldcs(p);
}

// sgd on the valid rows of one pass of a warp, held in `rows` / `slots`
// (`count` of them, in lane order): group g takes entries g + i * groups,
// kSgdRows at a time, every load issued before the first add.
template <int kVec>
__device__ __forceinline__ void sgd_pass(float* __restrict__ table,
                                         int64_t width,
                                         const float* __restrict__ sums,
                                         const int64_t* rows,
                                         const int64_t* slots, int count,
                                         int group, int groups, int64_t col0,
                                         int lanes, float neg_lr) {
  for (int first = group; first < count; first += groups * kSgdRows) {
    int64_t t_off[kSgdRows], s_off[kSgdRows];
#pragma unroll
    for (int i = 0; i < kSgdRows; ++i) {
      const int k = first + i * groups;
      if (k < count) {
        t_off[i] = rows[k] * width;
        s_off[i] = slots[k] * width;
      }
    }
    for (int64_t c = col0; c < width;
         c += static_cast<int64_t>(lanes) * kVec) {
      float s[kSgdRows][kVec], t[kSgdRows][kVec];
#pragma unroll
      for (int i = 0; i < kSgdRows; ++i) {
        if (first + i * groups < count) load_once(sums + s_off[i] + c, s[i]);
      }
#pragma unroll
      for (int i = 0; i < kSgdRows; ++i) {
        if (first + i * groups < count) {
          Vec<kVec>::load(table + t_off[i] + c, t[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kSgdRows; ++i) {
        if (first + i * groups >= count) continue;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          t[i][e] = row_rules::sgd_value(t[i][e], s[i][e], neg_lr);
        }
        Vec<kVec>::store(table + t_off[i] + c, t[i]);
      }
    }
  }
}

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
sgd_rows_kernel(float* __restrict__ table, int64_t vocab, int64_t width,
                const IdT* __restrict__ rep, const float* __restrict__ sums,
                int64_t n, float neg_lr, int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  // each warp's valid (row, slot) pairs of a pass, in lane order
  __shared__ int64_t valid_row[kThreads];
  __shared__ int64_t valid_slot[kThreads];
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lane_shift;
  const int groups = 32 >> lane_shift;
  const int group = lane >> lane_shift;
  const int64_t col0 = static_cast<int64_t>(lane & (lanes - 1)) * kVec;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  // a pass is 32 * G slots, dealt to the G warps in runs of the rows the
  // warp's groups take at once (at most 32): run q of warp w is run
  // q * G + w, so a valid prefix spreads over every warp and the rows
  // taken at once are neighbouring slots; this lane's slot of a pass
  // starting at `pass` is pass + own
  const int run = min(32, groups * kSgdRows);
  const int64_t own = (lane / run * warps + warp) * run + lane % run;
  const int64_t pass_slots = 32 * warps;
  int64_t* const rows = valid_row + (threadIdx.x & ~31);
  int64_t* const slots = valid_slot + (threadIdx.x & ~31);
  for (int64_t pass = 0; pass < n; pass += kRepAhead * pass_slots) {
    // the `rep` entries of kRepAhead passes, their loads in flight together
    int64_t r[kRepAhead];
#pragma unroll
    for (int a = 0; a < kRepAhead; ++a) {
      const int64_t slot = pass + a * pass_slots + own;
      r[a] = slot < n ? row_of(rep, slot, vocab) : -1;
    }
#pragma unroll
    for (int a = 0; a < kRepAhead; ++a) {
      const unsigned valid = __ballot_sync(0xffffffffu, r[a] >= 0);
      if (valid == 0) continue;
      if (r[a] >= 0) {
        const int k = __popc(valid & ((1u << lane) - 1));
        rows[k] = r[a];
        slots[k] = pass + a * pass_slots + own;
      }
      __syncwarp();
      sgd_pass<kVec>(table, width, sums, rows, slots, __popc(valid), group,
                     groups, col0, lanes, neg_lr);
      __syncwarp();
    }
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

template <typename IdT, bool kVec4>
int launch_sgd_rows(float* table, int64_t vocab, int64_t width,
                    const IdT* rep, const float* sums, int64_t n,
                    float neg_lr, int lane_shift, void* stream) {
  const auto kernel = sgd_rows_kernel<IdT, kVec4>;
  // The blocks the card holds at once (the occupancy query times the SM
  // count), read at this instantiation's first launch and cached: the
  // cards of one machine are alike, and the number sizes the grid but
  // changes no result.
  static std::atomic<int64_t> resident{0};
  int64_t blocks = resident.load(std::memory_order_relaxed);
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = static_cast<int64_t>(sms) * per_sm;
    resident.store(blocks, std::memory_order_relaxed);
  }
  // no more warps than the call has runs of slots (the kernel's `run`: the
  // rows a warp's groups take at once, at most 32), so a small call's
  // valid rows spread over as many warps as their runs allow
  const int64_t run = std::min(32, kSgdRows << (5 - lane_shift));
  const int64_t needed = (n + run * kWarps - 1) / (run * kWarps);
  if (needed < blocks) blocks = needed;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(table, vocab, width, rep,
                                                sums, n, neg_lr, lane_shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdT>
int sgd_rows(float* table, int64_t vocab, int64_t width, const IdT* rep,
             const float* sums, int64_t n, float neg_lr, int vec4,
             void* stream) {
  int lane_shift;
  unsigned unused;
  if (!row_rules::grid_for(n, width, vec4, &lane_shift, &unused))
    return static_cast<int>(cudaErrorInvalidValue);
  return vec4 ? launch_sgd_rows<IdT, true>(table, vocab, width, rep, sums, n,
                                           neg_lr, lane_shift, stream)
              : launch_sgd_rows<IdT, false>(table, vocab, width, rep, sums, n,
                                            neg_lr, lane_shift, stream);
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
