// Helpers shared by the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace presto {

// Read element i of an integer column stored in `size` bytes per element
// (1: int8, 2: int16, 4: int32), widened to int32, so columns are read in
// their stored width and no widening copy runs before a kernel. `size` is
// uniform across the grid. The three candidate loads are predicated, each
// into its own register: a switch would compile to an indirect branch per
// load, and predicated loads into one register would each wait for the
// previous one to land (a predicated-off instruction still waits on its
// destination), either way one memory round trip per column. Here all of
// a row's loads are in flight at once.
__device__ __forceinline__ int32_t load_int(const void* p, int size, int64_t i) {
  int32_t b = 0;
  int32_t h = 0;
  int32_t w = 0;
  if (size == 1) b = static_cast<const int8_t*>(p)[i];
  if (size == 2) h = static_cast<const int16_t*>(p)[i];
  if (size == 4) w = static_cast<const int32_t*>(p)[i];
  return b | h | w;  // at most one is nonzero
}

// Sum `slots` per-thread partials laid out [slot][copies] in shared
// memory and add each nonzero total to out[slot] with one 64-bit atomic.
// One warp per slot: each lane sums a strided share of the copies, then
// the warp combines them with shuffles. Call after a barrier.
__device__ __forceinline__ void flush_slots(const unsigned long long* sm, int slots,
                                            int copies, unsigned long long* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int s = warp; s < slots; s += warps) {
    unsigned long long t = 0;
    for (int c = lane; c < copies; c += 32) t += sm[s * copies + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
    if (lane == 0 && t != 0) atomicAdd(&out[s], t);
  }
}

// Blocks for a grid-stride loop over n rows: enough to give every thread
// `rows` rows, at most as many as can be resident on the device at once.
template <typename Kernel>
inline int grid_blocks(Kernel kernel, int64_t n, int threads, int smem, int rows) {
  int dev = 0;
  int sms = 1;
  int per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (per_sm < 1) per_sm = 1;
  const int64_t rows_per_block = static_cast<int64_t>(threads) * rows;
  const int64_t want = (n + rows_per_block - 1) / rows_per_block;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace presto
