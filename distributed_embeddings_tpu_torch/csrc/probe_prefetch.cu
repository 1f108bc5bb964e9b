// Feature ladder, rung 5: out[i] = t[ids[i]], block i loading its own index
// and the row through a TMA tensor load at that runtime coordinate.
//
// Replaces tools/tpu_mosaic_probe.py `rung_prefetch` (:101, pallas_call
// :119): scalar-prefetched ids in SMEM drive, per grid step, an async copy
// of row ids[program_id] into VMEM and an output block map.
//
// Bound: launch overhead (4 rows of 512 bytes read and written).
//
// Feature: `cp.async.bulk.tensor.2d` (box 1 row x 128 columns) at the
// runtime row coordinate ids[i], onto an mbarrier expecting the box's 512
// bytes. On this card a block loads its own indices: no scalar prefetch.
// A row outside [0, rows) traps.

#include "probe_async.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kThreads = kCols;
constexpr uint32_t kRowBytes = kCols * 4;

__global__ void __launch_bounds__(kThreads)
prefetch_kernel(const __grid_constant__ CUtensorMap table_map,
                const int32_t* __restrict__ ids, int64_t rows,
                float* __restrict__ out) {
  __shared__ __align__(128) float row_buf[kCols];
  __shared__ __align__(8) uint64_t bar;
  const int32_t row = ids[blockIdx.x];
  if (row < 0 || row >= rows) __trap();
  if (threadIdx.x == 0) {
    probe::mbar_init(&bar, 1);
    probe::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    probe::mbar_expect_tx(&bar, kRowBytes);
    probe::tma_load_2d(row_buf, &table_map, &bar, 0, row);
  }
  probe::mbar_wait(&bar, 0);
  out[static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x] =
      row_buf[threadIdx.x];
}

}  // namespace

// out [n, 128] = table[ids] for int32 `ids` [n] and float32 `table`
// [rows < 2^31, 128] (16-byte aligned). Returns 0, a cudaError_t or
// -CUresult (the encoding).
extern "C" int probe_prefetch_f32(const int32_t* ids, int64_t n,
                                  const float* table, int64_t rows, float* out,
                                  void* stream) {
  if (n < 1 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int enc = probe::encode_rows_map(&map, table,
                                         static_cast<uint64_t>(rows), kCols, 1);
  if (enc != 0) return enc;
  prefetch_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(map, ids, rows, out);
  return static_cast<int>(cudaGetLastError());
}
