// Exact per-group integer sums and mask counts in one pass.
//
// Replaces presto_tpu/ops/pallas_groupby.py::fused_lane_sums (Pallas body
// `_kernel`). Inputs: k int32 value columns (dead rows already zeroed,
// each at most 31 bits by declaration), m byte masks, and int32 group ids
// where any id outside [0, G) is trash. Outputs: int64 sums[G][k], counts[G][m] and a flag
// that is set when some row's |value| exceeds its declared bits.
//
// Bound on the H100: the bytes read. At the Q1 pipeline's shapes (4
// values, 5 masks, int32 gid) that is 25 bytes a row, read once at
// 3.35 TB/s; the work is a handful of integer operations a row.
//
// Design, against that bound:
// - A grid-stride loop reads every column once. For each column a thread
//   loads kRows rows before it uses any of them, so kRows independent
//   loads a thread are in flight; the column loops run to the run-time k
//   and m only, so a row costs instructions for the columns it has.
// - Partial sums are int64 in shared memory, laid out [slot][copy] with
//   slot = g*(k+m)+j. When every thread fits a private copy
//   (G*(k+m)*8 bytes a thread within the shared-memory budget) a thread
//   updates its own copy with a plain add; otherwise threads share the
//   copies that fit and update them with shared-memory atomics.
// - After the loop, one warp per slot sums the block's copies and makes
//   one 64-bit atomicAdd into the caller-zeroed output.
// No 8-bit lanes or 2^23-row majors are needed: int64 is native here.

#include "common.cuh"

namespace {

constexpr int kMaxValues = 16;
constexpr int kMaxMasks = 16;
constexpr int kSlotLimit = 1024;
constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows a thread loads per column and iteration
constexpr int kSmemBudget = 112 * 1024;  // two blocks fit on one SM

struct LaneArgs {
  const int32_t* value[kMaxValues];
  int bits[kMaxValues];
  const uint8_t* mask[kMaxMasks];
};

__device__ __forceinline__ void slot_add(unsigned long long* p, long long v, bool priv) {
  if (priv) {
    *p += static_cast<unsigned long long>(v);
  } else {
    atomicAdd(p, static_cast<unsigned long long>(v));
  }
}

__global__ void __launch_bounds__(kThreads)
lane_sums_kernel(LaneArgs a, int k, int m, const int32_t* gid, int groups,
                 int64_t n, int copies, unsigned long long* out) {
  extern __shared__ unsigned long long sm[];  // [slots][copies]
  const int width = k + m;
  const int slots = groups * width;
  for (int s = threadIdx.x; s < slots * copies; s += blockDim.x) sm[s] = 0;
  __syncthreads();

  const int copy = threadIdx.x % copies;
  const bool priv = copies == static_cast<int>(blockDim.x);
  int bad = 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * kRows;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x * kRows + threadIdx.x;
       base < n; base += step) {
    // rows past the end re-read the last row (no branch around the
    // loads) and are dropped as trash
    int64_t r[kRows];
    unsigned long long* row[kRows];
    bool in[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * blockDim.x;
      r[u] = i < n ? i : n - 1;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int32_t g = gid[r[u]];
      in[u] = base + static_cast<int64_t>(u) * blockDim.x < n && g >= 0 && g < groups;
      row[u] = sm + static_cast<int64_t>(in[u] ? g : 0) * width * copies + copy;
    }
    for (int j = 0; j < k; ++j) {
      const int32_t* col = a.value[j];
      const int b = a.bits[j];
      int32_t x[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) x[u] = col[r[u]];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const long long v = x[u];
        const long long mag = v < 0 ? -v : v;
        if (b < 31 && (mag >> b) != 0) bad = 1;
        if (in[u] && v != 0) slot_add(row[u] + j * copies, v, priv);
      }
    }
    for (int j = 0; j < m; ++j) {
      const uint8_t* col = a.mask[j];
      uint8_t x[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) x[u] = col[r[u]];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (in[u] && x[u] != 0) slot_add(row[u] + (k + j) * copies, 1, priv);
      }
    }
  }

  const int any_bad = __syncthreads_or(bad);  // also the barrier for `sm`
  presto::flush_slots(sm, slots, copies, out);
  if (threadIdx.x == 0 && any_bad) atomicAdd(&out[slots], 1ull);
}

}  // namespace

// Launch on `stream`. `out`: int64[G*(k+m) + 1], zeroed by the caller;
// out[g*(k+m) + j] is value j's sum (j < k) or mask (j-k)'s count in
// group g, out[G*(k+m)] is nonzero when a declared bound was violated.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments beyond the kernel's limits (checked first in Python).
extern "C" int lane_sums_launch(const void* const* values, const int* bits, int k,
                                const void* const* masks, int m, const void* gid,
                                int groups, long long n, long long* out, void* stream) {
  const int slots = groups * (k + m);
  if (k < 0 || k > kMaxValues || m < 0 || m > kMaxMasks || groups < 1 ||
      slots > kSlotLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaneArgs a = {};
  for (int j = 0; j < k; ++j) {
    a.value[j] = static_cast<const int32_t*>(values[j]);
    a.bits[j] = bits[j];
  }
  for (int j = 0; j < m; ++j) a.mask[j] = static_cast<const uint8_t*>(masks[j]);

  const int slot_bytes = (slots > 0 ? slots : 1) * 8;
  int copies = kSmemBudget / slot_bytes;
  if (copies > kThreads) copies = kThreads;
  if (copies < 1) copies = 1;
  const int smem = slot_bytes * copies;
  cudaFuncSetAttribute(lane_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int blocks = presto::grid_blocks(lane_sums_kernel, n, kThreads, smem, kRows);
  lane_sums_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, k, m, static_cast<const int32_t*>(gid), groups, n, copies,
      reinterpret_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lane_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
