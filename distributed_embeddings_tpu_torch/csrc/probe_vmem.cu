// Feature ladder, rung 1 (the control): out = 2 * x through static shared
// memory.
//
// Replaces tools/tpu_mosaic_probe.py `rung_vmem` (:37, pallas_call :42),
// the TPU ladder's control: an elementwise kernel on a block in VMEM.
//
// Bound: launch overhead. The rung moves 256 KB ([256, 128] float32 read
// and written), 0.08 us at 3.35 TB/s, against a few us to launch.
//
// Feature: none beyond a plain kernel. A block of 256 threads stages 32 rows
// of 128 columns (16 KB) in static shared memory, then each thread writes
// elements another thread loaded, so the barrier between the two matters.
// The file refuses to build for a target without the `a` features: a wrong
// -gencode (sm_90 for sm_90a) fails here, at the control, and not inside a
// later wgmma kernel.

#if defined(__CUDA_ARCH__) && !defined(__CUDA_ARCH_FEAT_SM90_ALL)
#error "the feature ladder is built for sm_90a (-gencode arch=compute_90a,code=sm_90a)"
#endif

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;
constexpr int kTileRows = 32;
constexpr int kThreads = 256;
constexpr int kTile = kTileRows * kCols;

__global__ void __launch_bounds__(kThreads)
vmem_kernel(const float* __restrict__ x, int64_t rows, float* __restrict__ out) {
  __shared__ float tile[kTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t end = rows * kCols;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    tile[i] = base + i < end ? x[base + i] : 0.f;
  }
  __syncthreads();
  // thread t writes what thread t ^ 1 loaded
  for (int i = threadIdx.x ^ 1; i < kTile; i += kThreads) {
    if (base + i < end) out[base + i] = __fmul_rn(2.f, tile[i]);
  }
}

}  // namespace

// out = 2 * x for float32 [rows, 128]. Returns cudaGetLastError() after the
// launch.
extern "C" int probe_vmem_f32(const float* x, int64_t rows, float* out,
                              void* stream) {
  const int64_t blocks = (rows + kTileRows - 1) / kTileRows;
  if (blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vmem_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, rows, out);
  return static_cast<int>(cudaGetLastError());
}
