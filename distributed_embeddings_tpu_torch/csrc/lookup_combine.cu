// Gather-combine embedding lookup for Hopper (sm_90a).
//
//   out[n, :] = sum_k w[n, k] * table[clamp(ids[n, k], 0, V - 1), :]
//
// Replaces the two TPU Pallas kernels behind
// distributed_embeddings_tpu/ops/pallas_lookup.py fused_embedding_lookup:
// `_onehot_kernel` (one-hot matmul on the MXU, V <= 8192) and
// `_dma_gather_kernel` (row DMAs from HBM, V > 8192). Their split by vocab
// size and 128-lane alignment is a fact of the TPU's tiling; on this card one
// kernel serves every vocab size and width.
//
// Bound: memory. Each output row reads K table rows of 4*W bytes at random
// row addresses, plus its K ids and weights, and writes 4*W bytes: about
// N*K*(4W + 8) + 4*N*W bytes against 2*N*K*W flops, far below the card's
// operations-per-byte line.
//
// Design (the original library's CUDA combiner shape): a group of
// `lanes = min(32, ceil(W / 4))` threads (a power of two, so a group never
// straddles a warp) owns one output row; each thread holds a float4 slice of
// the row in registers, the group walks k in order, and neighbouring threads
// read neighbouring 16-byte columns of the gathered row. Narrow tables
// (Tiny's widths 8 and 16) pack 16 or 8 output rows into one warp instead of
// leaving most of a warp-per-row idle. Widths above 128 loop over column
// chunks. The products and sums are rounded separately (no FMA contraction)
// so the result is the plain multiply-then-sum; only the order of the K-term
// sum may differ from a library reduction. Index arithmetic is 64-bit: a row
// offset times W overflows int32 on the larger buckets of the model zoo.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename IdT>
__device__ __forceinline__ int64_t clamp_id(IdT raw, int64_t vocab) {
  int64_t id = static_cast<int64_t>(raw);
  return id < 0 ? 0 : (id >= vocab ? vocab - 1 : id);
}

template <typename IdT, bool kVec4>
__global__ void __launch_bounds__(kThreads)
lookup_combine_kernel(const float* __restrict__ table, int64_t vocab,
                      int64_t width, const IdT* __restrict__ ids,
                      const float* __restrict__ weights, int64_t n_rows,
                      int64_t hot, float* __restrict__ out, int lane_shift) {
  const int lanes = 1 << lane_shift;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * (kThreads >> lane_shift)
                    + (threadIdx.x >> lane_shift);
  if (n >= n_rows) return;
  const int lane = threadIdx.x & (lanes - 1);
  const IdT* row_ids = ids + n * hot;
  const float* row_w = weights == nullptr ? nullptr : weights + n * hot;
  float* out_row = out + n * width;
  constexpr int kVec = kVec4 ? 4 : 1;
  for (int64_t c = static_cast<int64_t>(lane) * kVec; c < width;
       c += static_cast<int64_t>(lanes) * kVec) {
    if (kVec4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int64_t k = 0; k < hot; ++k) {
        const int64_t id = clamp_id(row_ids[k], vocab);
        const float w = row_w == nullptr ? 1.f : row_w[k];
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(table + id * width + c));
        acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
      }
      *reinterpret_cast<float4*>(out_row + c) = acc;
    } else {
      float acc = 0.f;
      for (int64_t k = 0; k < hot; ++k) {
        const int64_t id = clamp_id(row_ids[k], vocab);
        const float w = row_w == nullptr ? 1.f : row_w[k];
        acc = __fadd_rn(acc, __fmul_rn(w, __ldg(table + id * width + c)));
      }
      out_row[c] = acc;
    }
  }
}

template <typename IdT>
int launch(const float* table, int64_t vocab, int64_t width, const IdT* ids,
           const float* weights, int64_t n_rows, int64_t hot, float* out,
           int vec4, void* stream) {
  const int64_t per_thread = vec4 ? 4 : 1;
  int64_t need = (width + per_thread - 1) / per_thread;
  if (need > 32) need = 32;
  int lane_shift = 0;
  while ((int64_t{1} << lane_shift) < need) ++lane_shift;
  const int64_t rows_per_block = kThreads >> lane_shift;
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    lookup_combine_kernel<IdT, true><<<static_cast<unsigned>(blocks), kThreads,
                                       0, s>>>(
        table, vocab, width, ids, weights, n_rows, hot, out, lane_shift);
  } else {
    lookup_combine_kernel<IdT, false><<<static_cast<unsigned>(blocks),
                                        kThreads, 0, s>>>(
        table, vocab, width, ids, weights, n_rows, hot, out, lane_shift);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. `weights` may be null (all ones);
// `vec4` selects float4 loads and needs width % 4 == 0 and 16-byte aligned
// table and out pointers. Each returns cudaGetLastError() after the launch.
extern "C" int lookup_combine_f32_i32(const float* table, int64_t vocab,
                                      int64_t width, const int32_t* ids,
                                      const float* weights, int64_t n_rows,
                                      int64_t hot, float* out, int vec4,
                                      void* stream) {
  return launch<int32_t>(table, vocab, width, ids, weights, n_rows, hot, out,
                         vec4, stream);
}

extern "C" int lookup_combine_f32_i64(const float* table, int64_t vocab,
                                      int64_t width, const int64_t* ids,
                                      const float* weights, int64_t n_rows,
                                      int64_t hot, float* out, int vec4,
                                      void* stream) {
  return launch<int64_t>(table, vocab, width, ids, weights, n_rows, hot, out,
                         vec4, stream);
}
