// Feature ladder, rung 7: index-driven tile addressing, an accumulator
// carried across steps, and an in-place output.
//
// Replaces tools/tpu_mosaic_probe.py `rung_blockspec_gather` (:179,
// pallas_call :222): scalar-prefetched `tof` / `cof` drive the BlockSpec
// index maps of the id chunk, the table tile and a revisited output tile
// over a sequential grid; a VMEM scratch carries one-hot row counts times
// `hp` from step to step; the output is aliased to the table.
//
// Bound: launch overhead (two 128-id chunks and one 8 x 128 tile read, the
// tile written).
//
// Design: the TPU's sequential grid becomes a loop in one block. Step g
// reads tof[g] and cof[g] from device memory, counts with shared-memory
// atomics how often each row r of tile tof[g] occurs in id chunk cof[g]
// (integers: the order of the atomics cannot change them), and adds
// count * hp to the carried accumulator, rounded as the TPU kernel rounds
// (acc = acc + count * hp, per step). After the last step the block writes
// table + acc into the rows of tile tof[last], in place: as on the TPU, the
// output tile of the last step is the only one written, and every other row
// keeps its bits. A tile or chunk index out of range traps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 2;    // grid steps, and id chunks
constexpr int kChunk = 128;  // ids per chunk
constexpr int kTile = 8;     // rows per tile
constexpr int kTiles = 4;    // tiles of the table
constexpr int kCols = 128;   // row width

__global__ void __launch_bounds__(kThreads)
blockspec_gather_kernel(const int32_t* __restrict__ tof,
                        const int32_t* __restrict__ cof,
                        const int32_t* __restrict__ ids,
                        const float* __restrict__ hp,
                        float* __restrict__ table) {
  __shared__ int counts[kTile];
  __shared__ float acc[kTile];
  const float h = hp[0];
  if (threadIdx.x < kTile) acc[threadIdx.x] = 0.f;
  for (int g = 0; g < kSteps; ++g) {
    const int t = tof[g];
    const int c = cof[g];
    if (t < 0 || t >= kTiles || c < 0 || c >= kSteps) __trap();
    if (threadIdx.x < kTile) counts[threadIdx.x] = 0;
    __syncthreads();
    for (int k = threadIdx.x; k < kChunk; k += kThreads) {
      const int64_t local = static_cast<int64_t>(ids[c * kChunk + k]) -
                            static_cast<int64_t>(t) * kTile;
      if (local >= 0 && local < kTile) atomicAdd(&counts[local], 1);
    }
    __syncthreads();
    if (threadIdx.x < kTile) {
      acc[threadIdx.x] = __fadd_rn(
          acc[threadIdx.x],
          __fmul_rn(static_cast<float>(counts[threadIdx.x]), h));
    }
    __syncthreads();
  }
  float* out = table + static_cast<int64_t>(tof[kSteps - 1]) * kTile * kCols;
  for (int i = threadIdx.x; i < kTile * kCols; i += kThreads) {
    out[i] = __fadd_rn(out[i], acc[i / kCols]);
  }
}

}  // namespace

// In place on float32 `table` [32, 128] (4 tiles of 8 rows): the rows of
// tile tof[1] gain sum over g < 2 of (count of each row of tile tof[g] in
// ids[cof[g]]) * hp[0]. int32 tof, cof [2], ids [2, 128]; float32 hp [1].
// Returns cudaGetLastError() after the launch.
extern "C" int probe_blockspec_gather_f32(const int32_t* tof,
                                          const int32_t* cof,
                                          const int32_t* ids, const float* hp,
                                          float* table, void* stream) {
  blockspec_gather_kernel<<<1, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      tof, cof, ids, hp, table);
  return static_cast<int>(cudaGetLastError());
}
