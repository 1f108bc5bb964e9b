// Sorted-stream embedding kernels for Hopper (sm_90a): the gather over an
// ascending id stream, and the row-wise optimizer updates that aggregate a
// raw (undeduplicated) gradient stream in its sorted order.
//
// gather_sorted, over an ascending key stream sid with its stable sort
// order perm (the stream's position of each sorted position):
//   perm given: out[perm[k], :] = w[perm[k]] * table[sid[k], :]
//   perm null:  out[k, :]       = w[k]       * table[sid[k], :]
// (w == nullptr: no product); rows whose key lies outside [0, V) are
// zeros, whatever the weight. With perm, the weights are in the stream's
// order and so are the rows: the call is the sorted gather, the weight
// permutation before it and the unpermute after it in one pass.
// Replaces distributed_embeddings_tpu/ops/pallas_tiled.py `_gather_kernel`
// (both variants, through `_gather_call`) together with the JAX package's
// unpermute `jnp.take(rows, inv)` (pallas_tiled.py:632 in `tiled_gather`,
// :826 in `_fused_lookup_impl`) and the fused lookup's weight permutation
// (`jnp.take(weights, perm)`, :819): tiled_gather, tiled_embedding_lookup,
// fused_lookup_combine and the dweights gather of `_tiled_lookup_bwd` take
// the perm form; tiled_gather_sorted(_weighted) keep the sorted order. The
// TPU kernel walks (table tile, id chunk) pairs and contracts a one-hot
// slab on the MXU because the TPU's row gather was descriptor-bound, and
// XLA permutes the rows in two more passes; on this card a row gather is a
// plain load, so each sorted position reads its one table row and stores
// it straight at its place in the stream. The product is one rounded
// multiply, as the one-hot contraction's single non-zero term is, so the
// rows are bit-identical to the sorted gather followed by the unpermute.
// Design: one thread group per sorted position, float4 column slices.
// Table reads go in ascending key order (neighbouring groups share a hot
// row in L2) and each group stores one whole output row at perm[k] (at
// W = 8 one 32-byte sector), so the scattered store costs whole sectors,
// never a partial one; its weight read at perm[k] is scattered too. The
// other order (one group per output row, reading sid[inv[i]]) was timed on
// the card and was slower once the inverse it needs is counted (PERF.md).
// No TMA: it has no gather by a list of rows.
// Bound: bytes, 4*W*U table bytes for the U distinct rows the stream reads,
// plus the keys, perm (8*N) and the weights (4*N) once and the 4*N*W
// output once.
//
// sgd_stream / adagrad_stream / adam_stream, over a sorted stream given as
// (sid, perm, starts): segment s covers sorted positions
// [starts[s], starts[s+1]) (empty past the last segment), all with key
// r = sid[starts[s]]. The segment's thread group sums contribs[perm[j], :]
// for j ascending into registers, then applies row_rules.cuh's sgd /
// adagrad / adam rule once to row r, in place (keys outside [0, V) are
// skipped; lazy adam: every row with a valid id in the stream moves, even
// with s == 0).
// Each equals sparse_apply.cu's segment_sum_sorted followed by the matching
// *_rows kernel, bit for bit, without the [N, W] sums array between them.
// Replace pallas_tiled.py `_sgd_kernel` / `_adagrad_kernel` / `_adam_kernel`
// through `_update_call` on raw streams (tiled_sgd, tiled_adagrad,
// tiled_adam; the lookup backward's dense table gradient is sgd_stream at
// lr = -1 over a zero table). The TPU kernels aggregate duplicates inside a
// one-hot matmul over every visited table tile; here one worker (a thread
// group, or a block for a long segment) walks one segment, so no two
// workers touch a row and no atomics are needed: the same step gives the
// same table every time.
// Bound: bytes. The 4*N*W bytes of contributions, the perm and starts
// entries and the segments' keys read once, and 8*W*U*(1 + n_state): the U
// valid rows of the table and of each of its n_state state arrays (0 sgd,
// 1 adagrad, 2 adam) read and written once. Beside it, the chain of
// dependent adds the sorted order forces on the longest segment (about 4
// cycles a row). The walk is segment_walk.cuh's, shared with
// segment_sum_sorted: a segment of at most kLongRows rows is summed by its
// thread group, a longer one (the hottest row of a power-law stream) by a
// block of the persistent long pass, which streams it through a cp.async
// ring in shared memory and applies the rule once, after the total. One
// call: a memset of the worklist count, the short pass, the long pass
// (three CUDA launches).
//
// Design, as lookup_combine.cu and sparse_apply.cu: one thread group per
// output row or segment, float4 column slices, every operation rounded on
// its own (so the plain PyTorch versions, which round per operation, are
// bit-exact yardsticks); the layout, the launch shape and the row rules are
// row_rules.cuh's, shared with sparse_apply.cu's *_rows kernels. Index
// arithmetic is 64-bit.

#include "row_rules.cuh"
#include "segment_walk.cuh"

namespace {

using row_rules::AdamHp;
using row_rules::Group;
using row_rules::Vec;
using row_rules::group_of;
using row_rules::kThreads;

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
gather_sorted_kernel(const float* __restrict__ table, int64_t vocab,
                     int64_t width, const IdT* __restrict__ sid,
                     const float* __restrict__ weights,
                     const int64_t* __restrict__ perm, int64_t n,
                     float* __restrict__ out, int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  // this sorted position's output row o (its weight's too)
  const int64_t o = perm == nullptr ? g.slot : perm[g.slot];
  const int64_t r = static_cast<int64_t>(sid[g.slot]);
  const bool valid = r >= 0 && r < vocab;
  const float w = weights == nullptr ? 1.f : weights[o];
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float v[kVec];
    if (valid) {
      Vec<kVec>::load(table + r * width + c, v);
      if (weights != nullptr) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = __fmul_rn(w, v[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    }
    Vec<kVec>::store(out + o * width + c, v);
  }
}

// The table row of this group's segment, or -1 when the slot holds no
// segment or the segment's key lies outside [0, V). Sets [*lo, *hi).
template <typename IdT>
__device__ __forceinline__ int64_t segment_row(const IdT* sid,
                                               const int64_t* starts,
                                               int64_t slot, int64_t vocab,
                                               int64_t* lo, int64_t* hi) {
  *lo = starts[slot];
  *hi = starts[slot + 1];
  if (*lo >= *hi) return -1;
  const int64_t r = static_cast<int64_t>(sid[*lo]);
  return (r < 0 || r >= vocab) ? -1 : r;
}

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
sgd_stream_kernel(float* __restrict__ table, int64_t vocab, int64_t width,
                  const float* __restrict__ contribs,
                  const IdT* __restrict__ sid,
                  const int64_t* __restrict__ perm,
                  const int64_t* __restrict__ starts, int64_t n, float neg_lr,
                  int64_t* scratch, int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  int64_t lo, hi;
  const int64_t r = segment_row(sid, starts, g.slot, vocab, &lo, &hi);
  if (r < 0) return;
  if (segment_walk::defer_long(lo, hi, g.lane, g.slot, scratch)) return;
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float s[kVec];
    segment_walk::segment_total<kVec>(contribs, width, perm, lo, hi, c, s);
    row_rules::sgd_row<kVec>(table + r * width + c, s, neg_lr);
  }
}

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
adagrad_stream_kernel(float* __restrict__ table, float* __restrict__ acc,
                      int64_t vocab, int64_t width,
                      const float* __restrict__ contribs,
                      const IdT* __restrict__ sid,
                      const int64_t* __restrict__ perm,
                      const int64_t* __restrict__ starts, int64_t n,
                      float neg_lr, float eps, int64_t* scratch,
                      int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  int64_t lo, hi;
  const int64_t r = segment_row(sid, starts, g.slot, vocab, &lo, &hi);
  if (r < 0) return;
  if (segment_walk::defer_long(lo, hi, g.lane, g.slot, scratch)) return;
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float s[kVec];
    segment_walk::segment_total<kVec>(contribs, width, perm, lo, hi, c, s);
    row_rules::adagrad_row<kVec>(table + r * width + c, acc + r * width + c,
                                 s, neg_lr, eps);
  }
}

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
adam_stream_kernel(float* __restrict__ table, float* __restrict__ mu,
                   float* __restrict__ nu, int64_t vocab, int64_t width,
                   const float* __restrict__ contribs,
                   const IdT* __restrict__ sid,
                   const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ starts, int64_t n, AdamHp hp,
                   int64_t* scratch, int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  int64_t lo, hi;
  const int64_t r = segment_row(sid, starts, g.slot, vocab, &lo, &hi);
  if (r < 0) return;
  if (segment_walk::defer_long(lo, hi, g.lane, g.slot, scratch)) return;
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float s[kVec];
    segment_walk::segment_total<kVec>(contribs, width, perm, lo, hi, c, s);
    row_rules::adam_row<kVec>(table + r * width + c, mu + r * width + c,
                              nu + r * width + c, s, hp);
  }
}

// The long passes: each worklist segment's total, then the segment's rule
// once on its row, one column a thread (the short pass queued only
// segments whose key lies in [0, V)). Their names keep `_stream_kernel`.
template <typename IdT>
__global__ void __launch_bounds__(segment_walk::kLongThreads)
sgd_long_stream_kernel(float* __restrict__ table, int64_t vocab,
                       int64_t width, const float* __restrict__ contribs,
                       const IdT* __restrict__ sid,
                       const int64_t* __restrict__ perm,
                       const int64_t* __restrict__ starts, int64_t n,
                       float neg_lr, int64_t* scratch) {
  segment_walk::long_walk(
      contribs, width, perm, starts, scratch,
      [=](int64_t, int64_t lo, int64_t col, float total) {
        const float s[1] = {total};
        row_rules::sgd_row<1>(
            table + static_cast<int64_t>(sid[lo]) * width + col, s, neg_lr);
      });
}

template <typename IdT>
__global__ void __launch_bounds__(segment_walk::kLongThreads)
adagrad_long_stream_kernel(float* __restrict__ table, float* __restrict__ acc,
                           int64_t vocab, int64_t width,
                           const float* __restrict__ contribs,
                           const IdT* __restrict__ sid,
                           const int64_t* __restrict__ perm,
                           const int64_t* __restrict__ starts, int64_t n,
                           float neg_lr, float eps, int64_t* scratch) {
  segment_walk::long_walk(
      contribs, width, perm, starts, scratch,
      [=](int64_t, int64_t lo, int64_t col, float total) {
        const float s[1] = {total};
        const int64_t at = static_cast<int64_t>(sid[lo]) * width + col;
        row_rules::adagrad_row<1>(table + at, acc + at, s, neg_lr, eps);
      });
}

template <typename IdT>
__global__ void __launch_bounds__(segment_walk::kLongThreads)
adam_long_stream_kernel(float* __restrict__ table, float* __restrict__ mu,
                        float* __restrict__ nu, int64_t vocab, int64_t width,
                        const float* __restrict__ contribs,
                        const IdT* __restrict__ sid,
                        const int64_t* __restrict__ perm,
                        const int64_t* __restrict__ starts, int64_t n,
                        AdamHp hp, int64_t* scratch) {
  segment_walk::long_walk(
      contribs, width, perm, starts, scratch,
      [=](int64_t, int64_t lo, int64_t col, float total) {
        const float s[1] = {total};
        const int64_t at = static_cast<int64_t>(sid[lo]) * width + col;
        row_rules::adam_row<1>(table + at, mu + at, nu + at, s, hp);
      });
}

// One stream call: segment_walk::launch of kernel<IdT, vec4> and its long
// pass, returned from the enclosing entry point.
#define STREAM_LAUNCH(name, IdT, n, width, vec4, scratch, workers, stream,   \
                      ...)                                                   \
  return (vec4) ? segment_walk::launch(                                      \
                      name##_stream_kernel<IdT, true>,                       \
                      name##_long_stream_kernel<IdT>, (n), (width),    \
                      (vec4), (scratch), (workers), (stream), __VA_ARGS__)   \
                : segment_walk::launch(                                      \
                      name##_stream_kernel<IdT, false>,                      \
                      name##_long_stream_kernel<IdT>, (n), (width),   \
                      (vec4), (scratch), (workers), (stream), __VA_ARGS__)

}  // namespace

// Plain C entry points, bound with ctypes, one per key type (i32 / i64).
// `vec4` selects float4 access and needs width % 4 == 0 and 16-byte aligned
// float pointers. Each returns cudaGetLastError() after its launch; none
// synchronizes. gather_sorted takes perm or null. The
// stream updates also take the walk's scratch (int64,
// 2 + at least n / (kLongRows + 1) entries) and the long pass's block count
// (the SM count), and return the first error of their three launches.
#define SORTED_STREAM_ENTRY_POINTS(suffix, IdT)                               \
  extern "C" int gather_sorted_f32_##suffix(                                 \
      const float* table, int64_t vocab, int64_t width, const IdT* sid,      \
      const float* weights, const int64_t* perm, int64_t n, float* out,      \
      int vec4, void* stream) {                                              \
    ROW_RULES_LAUNCH(gather_sorted_kernel, IdT, n, width, vec4, stream,      \
                     table, vocab, width, sid, weights, perm, n, out);       \
  }                                                                          \
  extern "C" int sgd_stream_f32_##suffix(                                    \
      float* table, int64_t vocab, int64_t width, const float* contribs,     \
      const IdT* sid, const int64_t* perm, const int64_t* starts, int64_t n, \
      float neg_lr, int vec4, int64_t* scratch, int workers, void* stream) { \
    STREAM_LAUNCH(sgd, IdT, n, width, vec4, scratch, workers, stream, table, \
                  vocab, width, contribs, sid, perm, starts, n, neg_lr);     \
  }                                                                          \
  extern "C" int adagrad_stream_f32_##suffix(                                \
      float* table, float* acc, int64_t vocab, int64_t width,                \
      const float* contribs, const IdT* sid, const int64_t* perm,            \
      const int64_t* starts, int64_t n, float neg_lr, float eps, int vec4,   \
      int64_t* scratch, int workers, void* stream) {                         \
    STREAM_LAUNCH(adagrad, IdT, n, width, vec4, scratch, workers, stream,    \
                  table, acc, vocab, width, contribs, sid, perm, starts, n,  \
                  neg_lr, eps);                                              \
  }                                                                          \
  extern "C" int adam_stream_f32_##suffix(                                   \
      float* table, float* mu, float* nu, int64_t vocab, int64_t width,      \
      const float* contribs, const IdT* sid, const int64_t* perm,            \
      const int64_t* starts, int64_t n, float neg_lr, float b1, float omb1,  \
      float b2, float omb2, float c1, float c2, float eps, int vec4,         \
      int64_t* scratch, int workers, void* stream) {                         \
    const AdamHp hp{neg_lr, b1, omb1, b2, omb2, c1, c2, eps};                \
    STREAM_LAUNCH(adam, IdT, n, width, vec4, scratch, workers, stream,       \
                  table, mu, nu, vocab, width, contribs, sid, perm, starts,  \
                  n, hp);                                                    \
  }

SORTED_STREAM_ENTRY_POINTS(i32, int32_t)
SORTED_STREAM_ENTRY_POINTS(i64, int64_t)
