// Shared device code of sparse_apply.cu and sorted_stream.cu: the thread
// group layout, the launch shape, and the sgd / adagrad / adam row rules.
// Both routes apply the same rule to a row's total (the deduplicated-row
// kernels to a slot of `sums`, the stream kernels to a segment's total in
// registers), and the strategies "sort" and "tiled" are pinned bit-equal,
// so the arithmetic lives here once. Every product, quotient, root and sum
// is rounded on its own (__fmul_rn, __fdiv_rn, __fsqrt_rn, __fadd_rn):
// nvcc would otherwise contract a*b+c into an FMA and break the rounding
// seams the JAX package pins with `fp_round`, and the plain PyTorch
// versions round each operation separately. rsqrtf is the function
// PyTorch's CUDA `rsqrt` calls.
//
//   sgd:     table[r] += (-lr) * s
//   adagrad: acc[r] += s*s;  table[r] += ((-lr) * s) * rsqrt(acc[r] + eps)
//   adam:    mu[r] = b1*mu[r] + (1-b1)*s;  nu[r] = b2*nu[r] + (1-b2)*(s*s)
//            table[r] += ((-lr) * (mu[r]/c1)) / (sqrt(nu[r]/c2) + eps)
//
// Layout: a group of `lanes = min(32, ceil(W / 4))` threads (a power of
// two, so a group never straddles a warp) owns one slot (an output row, a
// unique row or a segment), each thread a float4 column slice where
// W % 4 == 0, looping over column chunks past 128.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_rules {

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

// Adam's hyperparameters, as the entry points receive them.
struct AdamHp {
  float neg_lr, b1, omb1, b2, omb2, c1, c2, eps;
};

// The sgd rule on one table element `t` and its total `s`.
__device__ __forceinline__ float sgd_value(float t, float s, float neg_lr) {
  return __fadd_rn(t, __fmul_rn(neg_lr, s));
}

// The rules on columns [c, c + kVec) of one row, given the row's total `s`
// of those columns; each reads and writes its row in place.
template <int kVec>
__device__ __forceinline__ void sgd_row(float* table, const float (&s)[kVec],
                                        float neg_lr) {
  float t[kVec];
  Vec<kVec>::load(table, t);
#pragma unroll
  for (int e = 0; e < kVec; ++e) t[e] = sgd_value(t[e], s[e], neg_lr);
  Vec<kVec>::store(table, t);
}

template <int kVec>
__device__ __forceinline__ void adagrad_row(float* table, float* acc,
                                            const float (&s)[kVec],
                                            float neg_lr, float eps) {
  float t[kVec], a[kVec];
  Vec<kVec>::load(acc, a);
  Vec<kVec>::load(table, t);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    a[e] = __fadd_rn(a[e], __fmul_rn(s[e], s[e]));
    const float d =
        __fmul_rn(__fmul_rn(neg_lr, s[e]), rsqrtf(__fadd_rn(a[e], eps)));
    t[e] = __fadd_rn(t[e], d);
  }
  Vec<kVec>::store(acc, a);
  Vec<kVec>::store(table, t);
}

template <int kVec>
__device__ __forceinline__ void adam_row(float* table, float* mu, float* nu,
                                         const float (&s)[kVec],
                                         const AdamHp& h) {
  float t[kVec], m[kVec], v[kVec];
  Vec<kVec>::load(mu, m);
  Vec<kVec>::load(nu, v);
  Vec<kVec>::load(table, t);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    m[e] = __fadd_rn(__fmul_rn(h.b1, m[e]), __fmul_rn(h.omb1, s[e]));
    v[e] = __fadd_rn(__fmul_rn(h.b2, v[e]),
                     __fmul_rn(h.omb2, __fmul_rn(s[e], s[e])));
    const float num = __fmul_rn(h.neg_lr, __fdiv_rn(m[e], h.c1));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v[e], h.c2)), h.eps);
    t[e] = __fadd_rn(t[e], __fdiv_rn(num, den));
  }
  Vec<kVec>::store(mu, m);
  Vec<kVec>::store(nu, v);
  Vec<kVec>::store(table, t);
}

// Launch shape: lane_shift and block count for n slots of `width` columns.
// Returns false when the grid would not fit.
inline bool grid_for(int64_t n, int64_t width, int vec4, int* lane_shift,
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

}  // namespace row_rules

// Launch kernel<IdT, vec4> over n slots of `width` columns on `stream` with
// the given arguments and the lane shift, and return cudaGetLastError()
// from the enclosing entry point (cudaErrorInvalidValue when the grid would
// not fit).
#define ROW_RULES_LAUNCH(kernel, IdT, n, width, vec4, stream, ...)            \
  {                                                                          \
    int shift_;                                                              \
    unsigned blocks_;                                                        \
    if (!row_rules::grid_for((n), (width), (vec4), &shift_, &blocks_))       \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    cudaStream_t s_ = static_cast<cudaStream_t>(stream);                     \
    if (vec4)                                                                \
      kernel<IdT, true><<<blocks_, row_rules::kThreads, 0, s_>>>(            \
          __VA_ARGS__, shift_);                                              \
    else                                                                     \
      kernel<IdT, false><<<blocks_, row_rules::kThreads, 0, s_>>>(           \
          __VA_ARGS__, shift_);                                              \
    return static_cast<int>(cudaGetLastError());                             \
  }
