// Feature ladder, rung 3: out = t[0:256] through one bulk asynchronous copy
// into shared memory, completed on an mbarrier.
//
// Replaces tools/tpu_mosaic_probe.py `rung_dma` (:62, pallas_call :70): one
// explicit HBM -> VMEM `make_async_copy` of t[0:256] on a DMA semaphore,
// started and waited, then VMEM -> out.
//
// Bound: launch overhead (256 KB moved, 0.08 us at 3.35 TB/s).
//
// Features: `cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes`
// of the contiguous 128 KB slab (no tensor map); the mbarrier life cycle
// (`mbarrier.init`, `fence.mbarrier_init.release.cluster`,
// `arrive.expect_tx` of the slab's bytes, `try_wait.parity` on phase 0);
// 128 KB of dynamic shared memory after the opt-in.

#include "probe_async.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kRows = 256;
constexpr int kThreads = 256;
constexpr int kSlab = kRows * kCols;
constexpr uint32_t kSlabBytes = kSlab * 4;  // 128 KB, under 2^20

__global__ void __launch_bounds__(kThreads)
dma_kernel(const float* __restrict__ table, float* __restrict__ out) {
  extern __shared__ __align__(128) float slab[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    probe::mbar_init(&bar, 1);
    probe::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    probe::mbar_expect_tx(&bar, kSlabBytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(probe::smem_addr(slab)), "l"(table), "r"(kSlabBytes),
           "r"(probe::smem_addr(&bar))
        : "memory");
  }
  probe::mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < kSlab; i += kThreads) out[i] = slab[i];
}

}  // namespace

// out [256, 128] = table[0:256] for float32 `table` [rows >= 256, 128]
// (16-byte aligned). Returns cudaGetLastError() after the launch, or the
// opt-in's error.
extern "C" int probe_dma_f32(const float* table, float* out, void* stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlabBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dma_kernel<<<1, kThreads, kSlabBytes, static_cast<cudaStream_t>(stream)>>>(
      table, out);
  return static_cast<int>(cudaGetLastError());
}
