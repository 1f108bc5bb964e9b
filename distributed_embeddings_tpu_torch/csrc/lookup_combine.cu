// Gather-combine embedding lookup for Hopper (sm_90a).
//
//   out[n, :] = sum_k w[n, k] * table[clamp(ids[n, k], 0, V - 1), :]
//
// Replaces the two TPU Pallas kernels behind
// distributed_embeddings_tpu/ops/pallas_lookup.py fused_embedding_lookup:
// `_onehot_kernel` (one-hot matmul on the MXU, V <= 8192) and
// `_dma_gather_kernel` (row DMAs from HBM, V > 8192). Their split by vocab
// size and 128-lane alignment is a fact of the TPU's tiling; on this card
// every vocab size and width takes the same kernel, and the split is by
// hotness: one kernel for one-hot ids (K == 1), one for the rest.
//
// Bound: memory. Each output row reads K table rows of 4*W bytes at random
// row addresses, plus its K ids and weights, and writes W outputs (4*W bytes
// of float32, 2*W of bf16 or f16): about N*K*(4W + 8) + 4*N*W bytes against
// 2*N*K*W flops, far below the card's operations-per-byte line.
//
// Two kernels compute it, both on the same thread layout: a group of
// `lanes = min(32, ceil(W / 4))` threads (a power of two, so a group never
// straddles a warp) owns an output row; each thread holds a float4 slice of
// the row in registers, and neighbouring threads read neighbouring 16-byte
// columns of the gathered row. Narrow tables (Tiny's widths 8 and 16) pack
// 16 or 8 groups into one warp instead of leaving most of a warp-per-row
// idle. Widths above 128 loop over column chunks; widths that are not a
// multiple of 4 take a scalar path. The products and sums are rounded
// separately (no FMA contraction), so the result is the plain
// multiply-then-sum in ascending k. Index arithmetic is 64-bit: a row
// offset times W overflows int32 on the larger buckets of the model zoo.
//
// The multi-hot kernel (K != 1, `lookup_combine_kernel`; the original
// library's CUDA combiner shape): a group owns one output row for its
// whole life and walks k in order; one block of groups a batch of rows.
//
// The one-hot kernel (K == 1, `one_hot_kernel`): a gather, whose time is
// the latency of its dependent loads (the id, then the table row) when a
// thread has one row in flight. So a group takes kOneHotRows rows a batch:
// it loads all their ids and weights, then issues all their table-row
// loads, and only then multiplies and stores, so each thread has
// kOneHotRows independent loads in flight. The grid is the blocks the card
// holds at once (the occupancy query times the SM count, read once and
// cached), capped by the batches the call has; each block walks batches in
// a grid-stride loop. Rows past the end issue no load and no store. Each
// output is written once and not read again, so it is stored streaming
// (`__stcs`), which keeps it from pushing table rows out of L2.
//
// Mixed precision: the table stays float32 and the sum is float32; the
// store is templated on the output type (float, __nv_bfloat16, __half),
// rounded once to nearest even as XLA's convert rounds. Two forms:
//   store form (`round_in` 0): the float32 combine, then the rounded store:
//     the TPU kernel followed by `.astype(compute_dtype)`;
//   round-first form (`round_in` 1): each row element and each weight is
//     rounded to the output type before the float32 multiply-add. The
//     product of two bf16 (or f16) values is exact in float32, so this is
//     an einsum of rounded operands with float32 accumulation and one
//     rounding at the end: XLA's lookup route (gather, cast, combine),
//     up to the order of the K-term sum.
// The vec4 store writes 4 outputs at once: 16 bytes of float, 8 of bf16 or
// f16, so the output must be aligned to 4 * sizeof(output).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>

namespace {

constexpr int kThreads = 256;
// rows a group of the one-hot kernel takes a batch: loads in flight a thread
constexpr int kOneHotRows = 4;

// The bits of `v` as a T of the same size (what a streaming store takes).
template <typename T, typename V>
__device__ __forceinline__ T bits(V v) {
  static_assert(sizeof(T) == sizeof(V), "bits: sizes differ");
  T t;
  memcpy(&t, &v, sizeof(T));
  return t;
}

// The output type: `cast` is the rounded store, `round` a float32 value
// rounded to the type and back (the round-first form's operands);
// `store4` / `stream` / `stream4` store the cast values, the last two
// streaming.
template <typename OutT>
struct Out;

template <>
struct Out<float> {
  static __device__ __forceinline__ float cast(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store4(float* p, float4 a) {
    *reinterpret_cast<float4*>(p) = a;
  }
  // streaming stores (`__stcs`) of the same values
  static __device__ __forceinline__ void stream(float* p, float v) {
    __stcs(p, v);
  }
  static __device__ __forceinline__ void stream4(float* p, float4 a) {
    __stcs(reinterpret_cast<float4*>(p), a);
  }
};

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 cast(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a) {
    *reinterpret_cast<Bf16x4*>(p) =
        Bf16x4{__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w)};
  }
  static __device__ __forceinline__ void stream(__nv_bfloat16* p, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p), bits<unsigned short>(cast(v)));
  }
  static __device__ __forceinline__ void stream4(__nv_bfloat16* p, float4 a) {
    __stcs(reinterpret_cast<uint2*>(p),
           bits<uint2>(Bf16x4{__floats2bfloat162_rn(a.x, a.y),
                              __floats2bfloat162_rn(a.z, a.w)}));
  }
};

struct alignas(8) Halfx4 {
  __half2 lo, hi;
};

template <>
struct Out<__half> {
  static __device__ __forceinline__ __half cast(float v) {
    return __float2half_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ __forceinline__ void store4(__half* p, float4 a) {
    *reinterpret_cast<Halfx4*>(p) =
        Halfx4{__floats2half2_rn(a.x, a.y), __floats2half2_rn(a.z, a.w)};
  }
  static __device__ __forceinline__ void stream(__half* p, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p), bits<unsigned short>(cast(v)));
  }
  static __device__ __forceinline__ void stream4(__half* p, float4 a) {
    __stcs(reinterpret_cast<uint2*>(p),
           bits<uint2>(Halfx4{__floats2half2_rn(a.x, a.y),
                              __floats2half2_rn(a.z, a.w)}));
  }
};

template <typename IdT>
__device__ __forceinline__ int64_t clamp_id(IdT raw, int64_t vocab) {
  int64_t id = static_cast<int64_t>(raw);
  return id < 0 ? 0 : (id >= vocab ? vocab - 1 : id);
}

template <typename IdT, typename OutT, bool kVec4, bool kRoundIn>
__global__ void __launch_bounds__(kThreads)
lookup_combine_kernel(const float* __restrict__ table, int64_t vocab,
                      int64_t width, const IdT* __restrict__ ids,
                      const float* __restrict__ weights, int64_t n_rows,
                      int64_t hot, OutT* __restrict__ out, int lane_shift) {
  using O = Out<OutT>;
  const int lanes = 1 << lane_shift;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * (kThreads >> lane_shift)
                    + (threadIdx.x >> lane_shift);
  if (n >= n_rows) return;
  const int lane = threadIdx.x & (lanes - 1);
  const IdT* row_ids = ids + n * hot;
  const float* row_w = weights == nullptr ? nullptr : weights + n * hot;
  OutT* out_row = out + n * width;
  constexpr int kVec = kVec4 ? 4 : 1;
  for (int64_t c = static_cast<int64_t>(lane) * kVec; c < width;
       c += static_cast<int64_t>(lanes) * kVec) {
    if (kVec4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int64_t k = 0; k < hot; ++k) {
        const int64_t id = clamp_id(row_ids[k], vocab);
        float w = row_w == nullptr ? 1.f : row_w[k];
        float4 v =
            __ldg(reinterpret_cast<const float4*>(table + id * width + c));
        if (kRoundIn) {
          w = O::round(w);
          v.x = O::round(v.x);
          v.y = O::round(v.y);
          v.z = O::round(v.z);
          v.w = O::round(v.w);
        }
        acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
      }
      O::store4(out_row + c, acc);
    } else {
      float acc = 0.f;
      for (int64_t k = 0; k < hot; ++k) {
        const int64_t id = clamp_id(row_ids[k], vocab);
        float w = row_w == nullptr ? 1.f : row_w[k];
        float v = __ldg(table + id * width + c);
        if (kRoundIn) {
          w = O::round(w);
          v = O::round(v);
        }
        acc = __fadd_rn(acc, __fmul_rn(w, v));
      }
      out_row[c] = O::cast(acc);
    }
  }
}

// K == 1: out[n] = round_out(0 + w[n] * table[clamp(ids[n]), :]). A batch
// is kOneHotRows * groups rows (groups: the block's groups); row r of group
// g is batch_start + r * groups + g, so for each r the block's groups hold
// neighbouring rows (coalesced id loads and stores at narrow widths). Each
// group loads its rows' ids and weights, then every row's table slice,
// then multiplies, adds to 0 and stores: the multi-hot kernel's arithmetic
// at k = 0.
template <typename IdT, typename OutT, bool kVec4, bool kRoundIn>
__global__ void __launch_bounds__(kThreads)
one_hot_kernel(const float* __restrict__ table, int64_t vocab, int64_t width,
               const IdT* __restrict__ ids, const float* __restrict__ weights,
               int64_t n_rows, OutT* __restrict__ out, int lane_shift) {
  using O = Out<OutT>;
  constexpr int kVec = kVec4 ? 4 : 1;
  const int lanes = 1 << lane_shift;
  const int64_t groups = kThreads >> lane_shift;
  const int64_t group = threadIdx.x >> lane_shift;
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t batch = groups * kOneHotRows;
  for (int64_t start = static_cast<int64_t>(blockIdx.x) * batch + group;
       start < n_rows; start += static_cast<int64_t>(gridDim.x) * batch) {
    int64_t offset[kOneHotRows];  // the row's table offset, id * width
    float w[kOneHotRows];
#pragma unroll
    for (int r = 0; r < kOneHotRows; ++r) {
      const int64_t n = start + r * groups;
      offset[r] = 0;
      w[r] = 1.f;
      if (n < n_rows) {
        offset[r] = clamp_id(ids[n], vocab) * width;
        if (weights != nullptr) w[r] = weights[n];
        if (kRoundIn) w[r] = O::round(w[r]);
      }
    }
    for (int64_t c = static_cast<int64_t>(lane) * kVec; c < width;
         c += static_cast<int64_t>(lanes) * kVec) {
      if (kVec4) {
        float4 v[kOneHotRows];
#pragma unroll
        for (int r = 0; r < kOneHotRows; ++r) {
          if (start + r * groups < n_rows) {
            v[r] = __ldg(reinterpret_cast<const float4*>(table + offset[r]
                                                         + c));
          }
        }
#pragma unroll
        for (int r = 0; r < kOneHotRows; ++r) {
          const int64_t n = start + r * groups;
          if (n >= n_rows) continue;
          float4 x = v[r];
          if (kRoundIn) {
            x.x = O::round(x.x);
            x.y = O::round(x.y);
            x.z = O::round(x.z);
            x.w = O::round(x.w);
          }
          float4 acc;
          acc.x = __fadd_rn(0.f, __fmul_rn(w[r], x.x));
          acc.y = __fadd_rn(0.f, __fmul_rn(w[r], x.y));
          acc.z = __fadd_rn(0.f, __fmul_rn(w[r], x.z));
          acc.w = __fadd_rn(0.f, __fmul_rn(w[r], x.w));
          O::stream4(out + n * width + c, acc);
        }
      } else {
        float v[kOneHotRows];
#pragma unroll
        for (int r = 0; r < kOneHotRows; ++r) {
          if (start + r * groups < n_rows) v[r] = __ldg(table + offset[r] + c);
        }
#pragma unroll
        for (int r = 0; r < kOneHotRows; ++r) {
          const int64_t n = start + r * groups;
          if (n >= n_rows) continue;
          const float x = kRoundIn ? O::round(v[r]) : v[r];
          O::stream(out + n * width + c, __fadd_rn(0.f, __fmul_rn(w[r], x)));
        }
      }
    }
  }
}

template <typename IdT, typename OutT, bool kVec4, bool kRoundIn>
int launch_one_hot(const float* table, int64_t vocab, int64_t width,
                   const IdT* ids, const float* weights, int64_t n_rows,
                   OutT* out, int lane_shift, void* stream) {
  const auto kernel = one_hot_kernel<IdT, OutT, kVec4, kRoundIn>;
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
  const int64_t batch = (kThreads >> lane_shift) * kOneHotRows;
  const int64_t batches = (n_rows + batch - 1) / batch;
  if (batches < blocks) blocks = batches;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      table, vocab, width, ids, weights, n_rows, out, lane_shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdT, typename OutT, bool kRoundIn>
int launch(const float* table, int64_t vocab, int64_t width, const IdT* ids,
           const float* weights, int64_t n_rows, int64_t hot, OutT* out,
           int vec4, void* stream) {
  const int64_t per_thread = vec4 ? 4 : 1;
  int64_t need = (width + per_thread - 1) / per_thread;
  if (need > 32) need = 32;
  int lane_shift = 0;
  while ((int64_t{1} << lane_shift) < need) ++lane_shift;
  if (hot == 1) {
    return vec4 ? launch_one_hot<IdT, OutT, true, kRoundIn>(
                      table, vocab, width, ids, weights, n_rows, out,
                      lane_shift, stream)
                : launch_one_hot<IdT, OutT, false, kRoundIn>(
                      table, vocab, width, ids, weights, n_rows, out,
                      lane_shift, stream);
  }
  const int64_t rows_per_block = kThreads >> lane_shift;
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    lookup_combine_kernel<IdT, OutT, true, kRoundIn>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            table, vocab, width, ids, weights, n_rows, hot, out, lane_shift);
  } else {
    lookup_combine_kernel<IdT, OutT, false, kRoundIn>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            table, vocab, width, ids, weights, n_rows, hot, out, lane_shift);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes: lookup_combine_<out>[_round]_<ids>
// for out f32 / bf16 / f16 (the store form; `_round`: the round-first form)
// and ids int32 / int64. `weights` may be null (all ones); `vec4` selects
// float4 loads and 4-wide stores and needs width % 4 == 0, a 16-byte aligned
// table and an output aligned to 4 outputs. Each returns cudaGetLastError()
// after the launch.
#define LOOKUP_COMBINE_ENTRY(NAME, IdT, OutT, ROUND_IN)                      \
  extern "C" int NAME(const float* table, int64_t vocab, int64_t width,      \
                      const IdT* ids, const float* weights, int64_t n_rows,  \
                      int64_t hot, void* out, int vec4, void* stream) {      \
    return launch<IdT, OutT, ROUND_IN>(table, vocab, width, ids, weights,    \
                                       n_rows, hot, static_cast<OutT*>(out), \
                                       vec4, stream);                        \
  }

LOOKUP_COMBINE_ENTRY(lookup_combine_f32_i32, int32_t, float, false)
LOOKUP_COMBINE_ENTRY(lookup_combine_f32_i64, int64_t, float, false)
LOOKUP_COMBINE_ENTRY(lookup_combine_bf16_i32, int32_t, __nv_bfloat16, false)
LOOKUP_COMBINE_ENTRY(lookup_combine_bf16_i64, int64_t, __nv_bfloat16, false)
LOOKUP_COMBINE_ENTRY(lookup_combine_bf16_round_i32, int32_t, __nv_bfloat16,
                     true)
LOOKUP_COMBINE_ENTRY(lookup_combine_bf16_round_i64, int64_t, __nv_bfloat16,
                     true)
LOOKUP_COMBINE_ENTRY(lookup_combine_f16_i32, int32_t, __half, false)
LOOKUP_COMBINE_ENTRY(lookup_combine_f16_i64, int64_t, __half, false)
LOOKUP_COMBINE_ENTRY(lookup_combine_f16_round_i32, int32_t, __half, true)
LOOKUP_COMBINE_ENTRY(lookup_combine_f16_round_i64, int64_t, __half, true)
