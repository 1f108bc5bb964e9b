// Feature ladder, rung 4: out[0] = t[idx[0]], a row chosen at run time,
// copied by cp.async.
//
// Replaces tools/tpu_mosaic_probe.py `rung_dyn_dma` (:80, pallas_call :90):
// an async copy of t.at[row] with the row read from SMEM.
//
// Bound: launch overhead (one 512-byte row read and written).
//
// Feature: `cp.async.cg.shared.global` (LDGSTS) at a runtime row with a
// 64-bit offset. The block reads idx[0] from device memory itself; each of
// 32 threads copies 16 bytes of the row into shared memory,
// `commit_group` / `wait_group 0`, a barrier, and each thread writes columns
// other threads copied. A row outside [0, rows) traps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;
constexpr int kThreads = kCols / 4;  // 16 bytes each

__global__ void __launch_bounds__(kThreads)
dyn_dma_kernel(const int32_t* __restrict__ idx, const float* __restrict__ table,
               int64_t rows, float* __restrict__ out) {
  __shared__ __align__(16) float row_buf[kCols];
  const int64_t row = idx[0];
  if (row < 0 || row >= rows) __trap();
  const float* src = table + row * kCols + threadIdx.x * 4;
  const uint32_t dst = static_cast<uint32_t>(
      __cvta_generic_to_shared(row_buf + threadIdx.x * 4));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(src) : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  for (int c = threadIdx.x; c < kCols; c += kThreads) out[c] = row_buf[c];
}

}  // namespace

// out [1, 128] = table[idx[0]] for int32 `idx` and float32 `table`
// [rows, 128] (16-byte aligned). Returns cudaGetLastError() after the
// launch.
extern "C" int probe_dyn_dma_f32(const int32_t* idx, const float* table,
                                 int64_t rows, float* out, void* stream) {
  dyn_dma_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, table, rows, out);
  return static_cast<int>(cudaGetLastError());
}
