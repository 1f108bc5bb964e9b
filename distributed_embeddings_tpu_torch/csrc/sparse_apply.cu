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
// its perm/starts entries once, write each slot once).
//
// sgd_rows / adagrad_rows / adam_rows, over the unique rows `rep` that
// dedup_sum produces (one read-modify-write per row, no conflicts, no
// atomics; rows with rep < 0 or rep >= V are skipped without reading their
// sums, the filler contract of pallas_scatter.py):
//   sgd:     table[r] += (-lr) * s
//   adagrad: acc[r] += s*s;  table[r] += ((-lr) * s) * rsqrt(acc[r] + eps)
//   adam:    mu[r] = b1*mu[r] + (1-b1)*s;  nu[r] = b2*nu[r] + (1-b2)*(s*s)
//            table[r] += ((-lr) * (mu[r]/c1)) / (sqrt(nu[r]/c2) + eps)
//            (lazy adam: every valid row is updated, even with s == 0)
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
// Design, as lookup_combine.cu: a group of `lanes = min(32, ceil(W / 4))`
// threads owns one slot (a power of two, so a group never straddles a warp),
// each thread a float4 column slice where W % 4 == 0, looping over column
// chunks past 128. Every product, quotient, root and sum is rounded on its
// own (__fmul_rn, __fdiv_rn, __fsqrt_rn, __fadd_rn): nvcc would otherwise
// contract a*b+c into an FMA and break the rounding seams the JAX package
// pins with `fp_round`, and the plain PyTorch versions round each operation
// separately. rsqrtf is the function PyTorch's CUDA `rsqrt` calls. Known
// hazard (not fixed here): a power-law stream gives its hottest row one long
// segment, which one thread group walks serially.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int kVec>
struct Vec;

template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    *p = v[0];
  }
};

// The slot of this thread's group, its lane, and the group's lane count.
struct Group {
  int64_t slot;
  int lane;
  int lanes;
};

__device__ __forceinline__ Group group_of(int lane_shift) {
  Group g;
  g.lanes = 1 << lane_shift;
  g.slot = static_cast<int64_t>(blockIdx.x) * (kThreads >> lane_shift) +
           (threadIdx.x >> lane_shift);
  g.lane = threadIdx.x & (g.lanes - 1);
  return g;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
segment_sum_sorted_kernel(const float* __restrict__ contribs, int64_t width,
                          const int64_t* __restrict__ perm,
                          const int64_t* __restrict__ starts, int64_t n,
                          float* __restrict__ sums, int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  const int64_t lo = starts[g.slot];
  const int64_t hi = starts[g.slot + 1];
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int64_t j = lo; j < hi; ++j) {
      float v[kVec];
      Vec<kVec>::load(contribs + perm[j] * width + c, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
    }
    Vec<kVec>::store(sums + g.slot * width + c, acc);
  }
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
    float s[kVec], t[kVec];
    Vec<kVec>::load(sums + g.slot * width + c, s);
    Vec<kVec>::load(table + r * width + c, t);
#pragma unroll
    for (int e = 0; e < kVec; ++e) t[e] = __fadd_rn(t[e], __fmul_rn(neg_lr, s[e]));
    Vec<kVec>::store(table + r * width + c, t);
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
    float s[kVec], t[kVec], a[kVec];
    Vec<kVec>::load(sums + g.slot * width + c, s);
    Vec<kVec>::load(acc + r * width + c, a);
    Vec<kVec>::load(table + r * width + c, t);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      a[e] = __fadd_rn(a[e], __fmul_rn(s[e], s[e]));
      const float d =
          __fmul_rn(__fmul_rn(neg_lr, s[e]), rsqrtf(__fadd_rn(a[e], eps)));
      t[e] = __fadd_rn(t[e], d);
    }
    Vec<kVec>::store(acc + r * width + c, a);
    Vec<kVec>::store(table + r * width + c, t);
  }
}

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
adam_rows_kernel(float* __restrict__ table, float* __restrict__ mu,
                 float* __restrict__ nu, int64_t vocab, int64_t width,
                 const IdT* __restrict__ rep, const float* __restrict__ sums,
                 int64_t n, float neg_lr, float b1, float omb1, float b2,
                 float omb2, float c1, float c2, float eps, int lane_shift) {
  constexpr int kVec = kVec4 ? 4 : 1;
  const Group g = group_of(lane_shift);
  if (g.slot >= n) return;
  const int64_t r = row_of(rep, g.slot, vocab);
  if (r < 0) return;
  for (int64_t c = static_cast<int64_t>(g.lane) * kVec; c < width;
       c += static_cast<int64_t>(g.lanes) * kVec) {
    float s[kVec], t[kVec], m[kVec], v[kVec];
    Vec<kVec>::load(sums + g.slot * width + c, s);
    Vec<kVec>::load(mu + r * width + c, m);
    Vec<kVec>::load(nu + r * width + c, v);
    Vec<kVec>::load(table + r * width + c, t);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      m[e] = __fadd_rn(__fmul_rn(b1, m[e]), __fmul_rn(omb1, s[e]));
      v[e] = __fadd_rn(__fmul_rn(b2, v[e]),
                       __fmul_rn(omb2, __fmul_rn(s[e], s[e])));
      const float num = __fmul_rn(neg_lr, __fdiv_rn(m[e], c1));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v[e], c2)), eps);
      t[e] = __fadd_rn(t[e], __fdiv_rn(num, den));
    }
    Vec<kVec>::store(mu + r * width + c, m);
    Vec<kVec>::store(nu + r * width + c, v);
    Vec<kVec>::store(table + r * width + c, t);
  }
}

// Launch shape: lane_shift and block count for n slots of `width` columns.
// Returns false when the grid would not fit.
bool grid_for(int64_t n, int64_t width, int vec4, int* lane_shift,
              unsigned* blocks) {
  const int64_t per_thread = vec4 ? 4 : 1;
  int64_t need = (width + per_thread - 1) / per_thread;
  if (need > 32) need = 32;
  int shift = 0;
  while ((int64_t{1} << shift) < need) ++shift;
  const int64_t per_block = kThreads >> shift;
  const int64_t b = (n + per_block - 1) / per_block;
  if (b > 0x7fffffffLL) return false;
  *lane_shift = shift;
  *blocks = static_cast<unsigned>(b);
  return true;
}

#define SPARSE_LAUNCH(kernel, IdT, n, width, vec4, stream, ...)               \
  {                                                                          \
    int shift_;                                                              \
    unsigned blocks_;                                                        \
    if (!grid_for((n), (width), (vec4), &shift_, &blocks_))                  \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    cudaStream_t s_ = static_cast<cudaStream_t>(stream);                     \
    if (vec4)                                                                \
      kernel<IdT, true><<<blocks_, kThreads, 0, s_>>>(__VA_ARGS__, shift_);  \
    else                                                                     \
      kernel<IdT, false><<<blocks_, kThreads, 0, s_>>>(__VA_ARGS__, shift_); \
    return static_cast<int>(cudaGetLastError());                             \
  }

template <typename IdT>
int sgd_rows(float* table, int64_t vocab, int64_t width, const IdT* rep,
             const float* sums, int64_t n, float neg_lr, int vec4,
             void* stream) {
  SPARSE_LAUNCH(sgd_rows_kernel, IdT, n, width, vec4, stream, table, vocab,
                width, rep, sums, n, neg_lr);
}

template <typename IdT>
int adagrad_rows(float* table, float* acc, int64_t vocab, int64_t width,
                 const IdT* rep, const float* sums, int64_t n, float neg_lr,
                 float eps, int vec4, void* stream) {
  SPARSE_LAUNCH(adagrad_rows_kernel, IdT, n, width, vec4, stream, table, acc,
                vocab, width, rep, sums, n, neg_lr, eps);
}

template <typename IdT>
int adam_rows(float* table, float* mu, float* nu, int64_t vocab,
              int64_t width, const IdT* rep, const float* sums, int64_t n,
              float neg_lr, float b1, float omb1, float b2, float omb2,
              float c1, float c2, float eps, int vec4, void* stream) {
  SPARSE_LAUNCH(adam_rows_kernel, IdT, n, width, vec4, stream, table, mu, nu,
                vocab, width, rep, sums, n, neg_lr, b1, omb1, b2, omb2, c1,
                c2, eps);
}

}  // namespace

// Plain C entry points, bound with ctypes. `vec4` selects float4 access and
// needs width % 4 == 0 and 16-byte aligned float pointers. Each returns
// cudaGetLastError() after its launch; none synchronizes.
extern "C" int segment_sum_sorted_f32(const float* contribs, int64_t width,
                                      const int64_t* perm,
                                      const int64_t* starts, int64_t n,
                                      float* sums, int vec4, void* stream) {
  int shift;
  unsigned blocks;
  if (!grid_for(n, width, vec4, &shift, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    segment_sum_sorted_kernel<true><<<blocks, kThreads, 0, s>>>(
        contribs, width, perm, starts, n, sums, shift);
  else
    segment_sum_sorted_kernel<false><<<blocks, kThreads, 0, s>>>(
        contribs, width, perm, starts, n, sums, shift);
  return static_cast<int>(cudaGetLastError());
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
