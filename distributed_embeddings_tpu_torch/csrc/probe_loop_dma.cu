// Feature ladder, rung 6: out[0] = sum_{j < n} t[idx[j]] with n (<= 8) TMA
// row loads in flight at once, each on its own mbarrier.
//
// Replaces tools/tpu_mosaic_probe.py `rung_loop_dma` (:125, pallas_call
// :148): a fori_loop starts 8 row copies on 8 DMA semaphores, a second loop
// waits for each, and the rows are summed.
//
// Bound: launch overhead (8 rows of 512 bytes read, one written).
//
// Features: several copies in flight and a ring of barriers, the shape of a
// pipelined producer. One thread initialises the n barriers, fences, and
// issues n `cp.async.bulk.tensor.2d` loads (box 1 x 128) into n shared
// slots; then every thread waits on barrier j in turn (phase 0, each
// barrier used once) and adds slot j to its column, j ascending, with
// `__fadd_rn` (slot 0 is the start, so the sum is the plain
// rows[0] + rows[1] + ... in that order). A row outside [0, rows) traps.

#include "probe_async.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kSlots = 8;
constexpr int kThreads = kCols;
constexpr uint32_t kRowBytes = kCols * 4;

__global__ void __launch_bounds__(kThreads)
loop_dma_kernel(const __grid_constant__ CUtensorMap table_map,
                const int32_t* __restrict__ idx, int n, int64_t rows,
                float* __restrict__ out) {
  __shared__ __align__(128) float slots[kSlots][kCols];
  __shared__ __align__(8) uint64_t bars[kSlots];
  if (threadIdx.x == 0) {
    for (int j = 0; j < n; ++j) probe::mbar_init(&bars[j], 1);
    probe::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < n; ++j) {
      const int32_t row = idx[j];
      if (row < 0 || row >= rows) __trap();
      probe::mbar_expect_tx(&bars[j], kRowBytes);
      probe::tma_load_2d(slots[j], &table_map, &bars[j], 0, row);
    }
  }
  probe::mbar_wait(&bars[0], 0);
  float acc = slots[0][threadIdx.x];
  for (int j = 1; j < n; ++j) {
    probe::mbar_wait(&bars[j], 0);
    acc = __fadd_rn(acc, slots[j][threadIdx.x]);
  }
  out[threadIdx.x] = acc;
}

}  // namespace

// out [1, 128] = sum over j of table[idx[j]] for int32 `idx` [n], 1 <= n <=
// 8, and float32 `table` [rows < 2^31, 128] (16-byte aligned). Returns 0, a
// cudaError_t or -CUresult (the encoding).
extern "C" int probe_loop_dma_f32(const int32_t* idx, int n, const float* table,
                                  int64_t rows, float* out, void* stream) {
  if (n < 1 || n > kSlots) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int enc = probe::encode_rows_map(&map, table,
                                         static_cast<uint64_t>(rows), kCols, 1);
  if (enc != 0) return enc;
  loop_dma_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      map, idx, n, rows, out);
  return static_cast<int>(cudaGetLastError());
}
