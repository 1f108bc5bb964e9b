// Hopper async-copy helpers of the feature ladder's TMA and mbarrier rungs
// (probe_anyspace.cu, probe_dma.cu, probe_prefetch.cu, probe_loop_dma.cu).
//
// Device side: mbarrier init / expect_tx / a bounded parity wait, and the
// 2-D TMA tensor load. Host side: a 2-D float32 tensor map over the rows of
// a row-major table, encoded by libcuda's `cuTensorMapEncodeTiled`, looked
// up at run time through the CUDA runtime (the libraries link no libcuda).
// A CUresult other than CUDA_SUCCESS comes back as its negative, a runtime
// error as its cudaError_t, so the caller tells the two apart and ignores
// neither.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace probe {

// A wait that outlasts this ends the kernel with a trap: a wrong expect_tx
// count or a copy that never lands shows as a failed launch, not a hang.
constexpr uint64_t kWaitLimitNs = 1000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread: the barrier expects `count` arrivals; the fence makes the
// initialised barrier visible to the async proxy (the copy engines).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and add `bytes` to the transaction count the phase waits for
// (under 2^20 per phase).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase with parity `parity` has completed (a fresh barrier
// is in phase 0), or trap after kWaitLimitNs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint64_t start = global_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (global_ns() - start > kWaitLimitNs) __trap();
  }
}

// TMA: the box of `map` at (column c0, row c1) into shared `dst` (128-byte
// aligned), completing `bar`'s transaction count by the box's bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int32_t c0,
                                            int32_t c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 2-D tensor map over float32 [rows, cols] (row-major, 16-byte aligned
// base, cols % 4 == 0) whose box is `box_rows` whole rows (each box side at
// most 256 elements). Returns 0, a cudaError_t, or -CUresult.
inline int encode_rows_map(CUtensorMap* map, const float* base, uint64_t rows,
                           uint64_t cols, uint32_t box_rows) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return static_cast<int>(cudaErrorSymbolNotFound);
    }
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};  // innermost first
  const cuuint64_t strides[1] = {cols * sizeof(float)};  // bytes, dim 1
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols), box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -static_cast<int>(res);
}

}  // namespace probe
