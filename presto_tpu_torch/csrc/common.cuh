// Helpers shared by the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

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

// SMs of the current device, asked once a device.
inline int sm_count() {
  static std::mutex mu;
  static std::map<int, int> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(dev);
  if (it != cache.end()) return it->second;
  int sms = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cache[dev] = sms;
  return sms;
}

// Blocks for a grid-stride loop over n rows: enough to give every thread
// `rows` rows, at most as many as can be resident on the device at once.
// The first launch of a (device, kernel, threads, smem) asks the device
// and caches the answer, so later launches cost a map lookup and no CUDA
// runtime query. (It sets no attribute, unlike resident_blocks: raising
// the dynamic shared memory of a kernel that has static shared memory is
// refused, and the error would surface at the next launch.)
template <typename Kernel>
inline int grid_blocks(Kernel kernel, int64_t n, int threads, int smem, int rows) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>, int> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(dev, reinterpret_cast<const void*>(kernel), threads, smem);
  int most = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) {
      most = it->second;
    } else {
      int per_sm = 1;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
      most = sm_count() * (per_sm < 1 ? 1 : per_sm);
      cache[key] = most;
    }
  }
  const int64_t rows_per_block = static_cast<int64_t>(threads) * rows;
  const int64_t want = (n + rows_per_block - 1) / rows_per_block;
  return static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
}

// Resident blocks of `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory on the whole current device (SMs x blocks per
// SM). The first launch of a (kernel, smem) asks the device, lets the
// kernel take up to the card's whole opt-in shared memory a block, and
// caches the answer, so later launches cost a map lookup and no CUDA
// runtime query.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(dev, reinterpret_cast<const void*>(kernel), smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int sms = 1;
  int per_sm = 1;
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int blocks = sms * (per_sm < 1 ? 1 : per_sm);
  cache[key] = blocks;
  return blocks;
}

// ---------------------------------------------------------------------------
// Hopper's 1-D bulk copies (global -> shared) into a ring of stages,
// each stage with an mbarrier that counts the bytes landed.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (the bulk
// copies) before any use; then a __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive once and expect `bytes` more bytes of bulk copies this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16) from 16-byte-aligned global `src` to
// 16-byte-aligned shared `dst`; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The ring's bookkeeping, kept alike by the producer and the consumers:
// a block's staged tiles take the stages in turn. `parity` is the phase
// of the stage's barriers for this use, `reuse` whether the stage held
// an earlier tile. Advanced once a tile, with no division.
struct RingPos {
  int stage = 0;
  uint32_t parity = 0;
  bool reuse = false;

  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      parity ^= 1u;
      reuse = true;
    }
  }
};

// The contiguous run of tiles [first, last) of this block, in 32-bit
// arithmetic (a block's count of tiles fits; a 64-bit division would
// cost a call on the path of every launch).
__device__ __forceinline__ void block_tiles(int64_t tiles, int64_t& first, int64_t& last) {
  const int all = static_cast<int>(tiles);
  const int b = static_cast<int>(blockIdx.x);
  const int blocks = static_cast<int>(gridDim.x);
  const int q = all / blocks;
  const int r = all % blocks;
  first = static_cast<int64_t>(b) * q + (b < r ? b : r);
  last = first + q + (b < r ? 1 : 0);
}

}  // namespace presto
