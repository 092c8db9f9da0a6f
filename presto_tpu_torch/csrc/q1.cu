// TPC-H Q1 leaf fragment in one pass over lineitem.
//
// Replaces presto_tpu/ops/pallas_q1.py::q1_step (Pallas body `_kernel`).
// Per live row with l_shipdate <= 1998-09-02 it forms gid = rf*2 + ls,
// dp = ep*(100 - disc), charge = (dp*(100 + tax) + 50) / 100, and adds
// qty, ep, dp, charge, disc and 1 to the row's group (6 groups).
//
// Bound on the H100: the bytes read. The 7 narrow columns plus `live`
// are 13 bytes a row (int16 shipdate/qty, int8 flags/disc/tax, int32
// price, bool live), read once at 3.35 TB/s. The arithmetic is a few
// integer operations a row, far below the card's integer rate.
//
// Design, against that bound:
// - A grid-stride loop reads each column in its stored width (no widening
//   pass before the kernel); the connector's narrow layout has its own
//   instantiation with fixed-width loads. Each thread loads kRows rows
//   of every column before it uses any of them, so many independent
//   loads are in flight; the grid fills the device at its occupancy.
// - Partial sums are int64 in shared memory, one private copy per thread
//   laid out [slot][thread] (no atomics, no bank conflicts beyond the
//   two wavefronts of a 64-bit access). A row updates only the 6 slots
//   of its own group.
// - After the loop, one warp per slot sums the block's copies with
//   shuffles and makes one 64-bit atomicAdd into the caller-zeroed
//   output. Integer addition is associative, so results are
//   bit-identical from run to run.
// The TPU kernel's 8-bit lanes, int32 majors and f32-reciprocal divmod
// are not needed: int64 is native here, and truncating division equals
// the TPU kernel's floor on the non-negative domain its guard admits.
//
// Guard (value_overflow) fires on exactly the TPU kernel's rows: a
// contributing row with qty outside [0, 2^13), ep outside [0, 2^24),
// disc outside [0, 100], tax outside [0, 27], rf outside [0, 2] or ls
// outside [0, 1].

#include "common.cuh"

namespace {

constexpr int kGroups = 6;
constexpr int kSums = 6;  // qty, ep, dp, charge, disc, count
constexpr int kSlots = kGroups * kSums;
constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread loads before it uses any of them
constexpr int kSmem = kSlots * kThreads * 8;
constexpr int kCols = 8;
constexpr int32_t kCutoff = 10471;  // date '1998-12-01' - interval '90' day

// column order: shipdate, returnflag, linestatus, quantity,
// extendedprice, discount, tax, live
struct Q1Cols {
  const void* p[kCols];
  int size[kCols];
};

// Element size of column k in the layout TpchConnector's narrowed schema
// gives the 8 columns: int16 shipdate and quantity, int32 price, and
// one-byte flags, discount, tax and live.
__host__ __device__ constexpr int narrow_size(int k) {
  return k == 4 ? 4 : (k == 0 || k == 3) ? 2 : 1;
}

// kNarrow: the columns have the narrow layout above, so every load is one
// fixed-width instruction; otherwise widths are read from `c.size` (the
// same arithmetic, with three predicated candidate loads per column).
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads)
q1_kernel(Q1Cols c, int64_t n, unsigned long long* out) {
  extern __shared__ unsigned long long sm[];  // [kSlots][kThreads]
  for (int s = threadIdx.x; s < kSlots * kThreads; s += kThreads) sm[s] = 0;
  __syncthreads();
  unsigned long long* mine = sm + threadIdx.x;
  int bad = 0;

  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kRows;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kRows + threadIdx.x;
       base < n; base += step) {
    int32_t v[kRows][kCols];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      // rows past the end re-read the last row (no branch around the
      // loads) and are dropped through `live`
      const int64_t i = base + static_cast<int64_t>(u) * kThreads;
      const int64_t r = i < n ? i : n - 1;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        v[u][k] = presto::load_int(c.p[k], kNarrow ? narrow_size(k) : c.size[k], r);
      }
      if (i >= n) v[u][7] = 0;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int32_t ship = v[u][0], rf = v[u][1], ls = v[u][2], live = v[u][7];
      if (live == 0 || ship > kCutoff) continue;
      const int64_t qty = v[u][3], ep = v[u][4], disc = v[u][5], tax = v[u][6];
      const int64_t gid = static_cast<int64_t>(rf) * 2 + ls;
      const int64_t dp = ep * (100 - disc);
      const int64_t ch = (dp * (100 + tax) + 50) / 100;
      bad |= ((qty >> 13) != 0) | ((ep >> 24) != 0) | (disc < 0) | (disc > 100) |
             (tax < 0) | (tax > 27) | (rf < 0) | (rf > 2) | (ls < 0) | (ls > 1);
      if (gid >= 0 && gid < kGroups) {
        unsigned long long* slot = mine + static_cast<int>(gid) * kSums * kThreads;
        slot[0 * kThreads] += static_cast<unsigned long long>(qty);
        slot[1 * kThreads] += static_cast<unsigned long long>(ep);
        slot[2 * kThreads] += static_cast<unsigned long long>(dp);
        slot[3 * kThreads] += static_cast<unsigned long long>(ch);
        slot[4 * kThreads] += static_cast<unsigned long long>(disc);
        slot[5 * kThreads] += 1ull;
      }
    }
  }

  const int any_bad = __syncthreads_or(bad);  // also the barrier for `sm`
  presto::flush_slots(sm, kSlots, kThreads, out);
  if (threadIdx.x == 0 && any_bad) atomicAdd(&out[kSlots], 1ull);
}

}  // namespace

// Launch on `stream`. `ptrs`/`sizes`: the 8 columns in Q1Cols order and
// their element sizes; `out`: int64[kSlots + 1], zeroed by the caller.
// Returns cudaGetLastError() after the launch.
extern "C" int q1_step_launch(const void* const* ptrs, const int* sizes,
                              long long n, long long* out, void* stream) {
  Q1Cols c;
  bool narrow = true;
  for (int k = 0; k < kCols; ++k) {
    c.p[k] = ptrs[k];
    c.size[k] = sizes[k];
    narrow = narrow && sizes[k] == narrow_size(k);
  }
  auto kernel = narrow ? q1_kernel<true> : q1_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  const int blocks = presto::grid_blocks(kernel, n, kThreads, kSmem, kRows);
  kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      c, n, reinterpret_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* q1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
