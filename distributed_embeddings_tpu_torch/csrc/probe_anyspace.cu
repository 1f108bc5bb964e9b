// Feature ladder, rung 2: a table left in device memory, described by a TMA
// tensor map that the kernel takes as a parameter but does not use; shared
// memory above 48 KB; out = zeros.
//
// Replaces tools/tpu_mosaic_probe.py `rung_anyspace` (:47, pallas_call :53):
// the table stays in HBM (memory space ANY) and a copy descriptor over
// t[0:256] is built but never started; the output is zeros, staged through
// a [256, 128] VMEM scratch.
//
// Bound: launch overhead (128 KB written, 0.04 us at 3.35 TB/s; the table
// is not read).
//
// Features: the host encodes a 2-D tensor map over the [V, 128] table (box
// 256 rows x 128 columns) with libcuda's `cuTensorMapEncodeTiled`, looked
// up at run time (probe_async.cuh), and passes it as a
// `const __grid_constant__ CUtensorMap`; the kernel opts in to 128 KB of
// dynamic shared memory, zeroes it and copies it out.

#include "probe_async.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kBoxRows = 256;
constexpr int kThreads = 256;
constexpr int kScratch = kBoxRows * kCols;
constexpr int kScratchBytes = kScratch * 4;  // 128 KB: needs the opt-in

__global__ void __launch_bounds__(kThreads)
anyspace_kernel(const __grid_constant__ CUtensorMap table_map,
                float* __restrict__ out) {
  extern __shared__ __align__(128) float scratch[];
  for (int i = threadIdx.x; i < kScratch; i += kThreads) scratch[i] = 0.f;
  __syncthreads();
  // thread t copies out what thread t ^ 1 zeroed
  for (int i = threadIdx.x ^ 1; i < kScratch; i += kThreads) {
    out[i] = scratch[i];
  }
}

}  // namespace

// out [256, 128] = zeros; `table` float32 [rows, 128] (rows >= 256, 16-byte
// aligned) is only described. Returns 0, a cudaError_t (the opt-in, the
// launch) or -CUresult (the encoding).
extern "C" int probe_anyspace_f32(const float* table, int64_t rows, float* out,
                                  void* stream) {
  CUtensorMap map;
  const int enc = probe::encode_rows_map(&map, table,
                                         static_cast<uint64_t>(rows), kCols,
                                         kBoxRows);
  if (enc != 0) return enc;
  // set once: a CUDA graph capture may replay the launch later
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        anyspace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kScratchBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  anyspace_kernel<<<1, kThreads, kScratchBytes,
                    static_cast<cudaStream_t>(stream)>>>(map, out);
  return static_cast<int>(cudaGetLastError());
}
