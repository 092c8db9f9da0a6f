// Fused leaf aggregation of one batch: the scan -> filter -> partial
// aggregate fragment of a LeafAggSpec in one pass.
//
// Replaces presto_tpu/ops/pallas_agg.py::_pallas_step (Pallas body
// `_kernel`, reached through `agg_step`). Per row: the closed-interval
// filters over the spec's columns and the batch's `live` mask; the group
// id gid = sum_i (c_i - lo_i) * stride_i; per value a 1- or 2-term
// product (c0 + c1*col)(c0' + c1'*col') in int64; per group the sums,
// mins, maxes and the count of rows that pass. value_overflow is set by
// any passing row outside a declared guard interval and by any passing
// sum value whose |value| is at or above 2^bits (bits < 63).
//
// Bound on the H100: the bytes read. TPC-H Q6 reads 4 narrow columns and
// `live` (10 bytes a row); the work is a few integer operations a row,
// far below the card's integer rate.
//
// Design, against that bound:
// - The spec travels as a kernel parameter, laid out per column (filter,
//   guard and key multiplier, and a bit mask of the key columns), so every
//   test indexes a register array with a compile-time index. Filters are
//   tested without a branch; guards and keys only on rows that pass.
// - Two instances. The narrow one takes the shape of TPC-H Q6 and the SSB
//   Q1 flight: at most 4 columns of at most 4 bytes (the connector's
//   narrow storage) and at most 1 value. It reads each column as the
//   aligned 32-bit word that holds the row's element: one load whatever
//   the width, whose value is not needed until the row is tested, and
//   whose byte offset is fixed for all of a thread's rows. A ring of R
//   rows per thread keeps R rows' loads in flight while it tests the
//   oldest (the ring is unrolled, so it stays in registers). Rows are
//   tested in int32; the launcher clamps the bounds to int32 exactly.
//   The generic instance takes every other spec (up to 32 columns and 32
//   values, any width): it reads rows element by element and tests them
//   in int64.
// - A thread keeps the running sums, mins, maxes and count of the group
//   its last rows fell in, in registers, and folds them into the block's
//   [groups x (values + 1)] int64 table in shared memory (shared-memory
//   atomics) only when the group changes. A keyless fragment (Q6, the SSB
//   Q1 flight) folds once per warp, after a shuffle reduction; 512 groups
//   of 33 slots fit in 135 KB (dynamic shared memory, opted in above
//   48 KB).
// - After the loop each block adds its table into the output with one
//   global atomic per nonempty slot (int64 atomicAdd, atomicMin,
//   atomicMax). The output starts at each slot's identity (the caller
//   writes it). Integer sums are exact and associative, so results are
//   bit-identical from run to run.
// The TPU kernel's 8-bit lanes, 2^23-row majors, 1024-slot output tile,
// block-size rule and compile probe have no counterpart: int64 is native
// here, and the kernel takes min/max values, bits > 31 and any capacity.

#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kMaxValues = 32;
constexpr int kMaxGroups = 512;
constexpr int kThreads = 256;

enum Op : int { kSum = 0, kMin = 1, kMax = 2 };

struct Term {
  long long c0;
  long long c1;
  unsigned int sel;  // bit k set: the term's column is column k (0: constant)
};

struct LeafSpec {
  const void* col[kMaxCols];
  int size[kMaxCols];  // bytes per element: 1, 2, 4 or 8
  long long flo[kMaxCols], fhi[kMaxCols];  // filter interval
  long long glo[kMaxCols], ghi[kMaxCols];  // guard interval
  long long kmul[kMaxCols];  // gid += c * kmul
  unsigned int kmask;  // key columns
  Term a[kMaxValues], b[kMaxValues];
  int op[kMaxValues];
  int has_b[kMaxValues];
  int bits[kMaxValues];
  const unsigned char* live;
  long long gbase;  // gid = gbase + sum c * kmul
  int ncols, nvalues, groups;
};

// Element i of an integer column of 1, 2, 4 or 8 bytes, as int64.
__device__ __forceinline__ long long load_wide(const void* p, int size, int64_t i) {
  long long b = 0, h = 0, w = 0, d = 0;
  if (size == 1) b = static_cast<const int8_t*>(p)[i];
  if (size == 2) h = static_cast<const int16_t*>(p)[i];
  if (size == 4) w = static_cast<const int32_t*>(p)[i];
  if (size == 8) d = static_cast<const long long*>(p)[i];
  return b | h | w | d;  // at most one is nonzero
}

// The aligned 32-bit word that holds element r of a column of `size`
// (1, 2 or 4) bytes at `base`: one load, whatever the width. The wrapper
// guarantees that every such word lies inside the column's allocation.
__device__ __forceinline__ unsigned int load_word(const void* base, int size, int64_t r) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base) + static_cast<uintptr_t>(r) * size;
  // through the read-only path as a global load (the address came from an
  // integer, which the compiler would otherwise load as a generic one)
  return __ldg(reinterpret_cast<const unsigned int*>(a & ~static_cast<uintptr_t>(3)));
}

// The element in `word` at byte `shift / 8` of `bits` bits, sign-extended.
__device__ __forceinline__ int extract(unsigned int word, int bits, int shift) {
  return static_cast<int>(word << (32 - bits - shift)) >> (32 - bits);
}

// Two's-complement wrapping arithmetic, as int64 tensors compute it.
__device__ __forceinline__ long long wadd(long long x, long long y) {
  return static_cast<long long>(static_cast<unsigned long long>(x) +
                                static_cast<unsigned long long>(y));
}
__device__ __forceinline__ long long wmul(long long x, long long y) {
  return static_cast<long long>(static_cast<unsigned long long>(x) *
                                static_cast<unsigned long long>(y));
}

__device__ __forceinline__ long long identity(int op) {
  return op == kMin ? LLONG_MAX : (op == kMax ? LLONG_MIN : 0);
}

// Fold x into slot p of a table by the value's op (shared or global).
__device__ __forceinline__ void fold(long long* p, int op, long long x) {
  if (op == kSum) {
    if (x != 0) atomicAdd(reinterpret_cast<unsigned long long*>(p),
                          static_cast<unsigned long long>(x));
  } else if (op == kMin) {
    if (x != LLONG_MAX) atomicMin(p, x);
  } else {
    if (x != LLONG_MIN) atomicMax(p, x);
  }
}

// The running state of one thread: the sums, mins, maxes and count of
// the group its last passing rows fell in.
template <int NV>
struct Run {
  long long acc[NV];
  long long n;
  long long g;  // -1: none yet
};

template <int NV>
__device__ __forceinline__ void flush(const LeafSpec& s, Run<NV>& run, long long* sm,
                                      int width) {
  long long* slot = sm + run.g * width;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j < s.nvalues) {
      fold(slot + j, s.op[j], run.acc[j]);
      run.acc[j] = identity(s.op[j]);
    }
  }
  fold(slot + s.nvalues, kSum, run.n);
  run.n = 0;
}

// Test one row (its column values `v`), and fold a passing one into the
// running state.
template <typename T, int NC, int NV>
__device__ __forceinline__ void process(const LeafSpec& s, const T (&v)[NC], bool live,
                                        Run<NV>& run, int& bad, long long* sm, int width) {
  // filters without a branch (a column without one has the type's full
  // range); the row's guard and key terms only once it passes
  bool pass = live;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k < s.ncols) {
      pass = pass & (v[k] >= static_cast<T>(s.flo[k])) & (v[k] <= static_cast<T>(s.fhi[k]));
    }
  }
  if (!pass) return;
  long long gid = s.gbase;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k < s.ncols) {
      const T c = v[k];
      bad |= (c < static_cast<T>(s.glo[k])) | (c > static_cast<T>(s.ghi[k]));
      if ((s.kmask >> k) & 1u) gid = wadd(gid, wmul(c, s.kmul[k]));
    }
  }
  const bool in = gid >= 0 && gid < s.groups;
  if (in && gid != run.g) {
    if (run.g >= 0) flush(s, run, sm, width);
    run.g = gid;
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j < s.nvalues) {
      // each term's column, picked by a bit test per column: a compare of
      // k with a column index would fold into one indexed read of the row
      // and move the row to local memory
      long long xa = 0, xb = 0;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        xa = (s.a[j].sel >> k) & 1u ? static_cast<long long>(v[k]) : xa;
        xb = (s.b[j].sel >> k) & 1u ? static_cast<long long>(v[k]) : xb;
      }
      long long x = wadd(s.a[j].c0, wmul(s.a[j].c1, xa));
      if (s.has_b[j]) x = wmul(x, wadd(s.b[j].c0, wmul(s.b[j].c1, xb)));
      if (s.op[j] == kSum && s.bits[j] < 63) {
        const unsigned long long mag = x < 0 ? 0ull - static_cast<unsigned long long>(x)
                                             : static_cast<unsigned long long>(x);
        bad |= (mag >> s.bits[j]) != 0;
      }
      if (in) {
        if (s.op[j] == kSum) {
          run.acc[j] = wadd(run.acc[j], x);
        } else if (s.op[j] == kMin) {
          run.acc[j] = x < run.acc[j] ? x : run.acc[j];
        } else {
          run.acc[j] = x > run.acc[j] ? x : run.acc[j];
        }
      }
    }
  }
  if (in) run.n += 1;
}

// The words of row i (columns, then `live`) into `words`; a row at or
// past the end loads nothing (it tests as dead).
template <int NC>
__device__ __forceinline__ void load_words(const LeafSpec& s, int64_t i, int64_t n,
                                           unsigned int (&words)[NC + 1]) {
  const bool in = i < n;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    words[k] = in && k < s.ncols ? load_word(s.col[k], s.size[k], i) : 0u;
  }
  words[NC] = in ? load_word(s.live, 1, i) : 0u;
}

// Where each column's element sits in its word for the rows of this
// thread: the grid's stride is a multiple of 4 rows, so the byte offset
// within the word is the same for all of them.
template <int NC>
__device__ __forceinline__ void word_shifts(const LeafSpec& s, int64_t row,
                                            int (&shift)[NC + 1]) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int size = k < s.ncols ? s.size[k] : 1;
    const uintptr_t a = reinterpret_cast<uintptr_t>(s.col[k]) + static_cast<uintptr_t>(row) * size;
    shift[k] = 8 * static_cast<int>(a & 3);
  }
  shift[NC] = 8 * static_cast<int>((reinterpret_cast<uintptr_t>(s.live) + row) & 3);
}

// Lanes of a warp whose running states share one group (or have none)
// combine them with shuffles, and one lane folds the result; otherwise
// each lane folds its own.
template <int NV>
__device__ __forceinline__ void flush_warp(const LeafSpec& s, Run<NV>& run, long long* sm,
                                           int width) {
  const unsigned int all = 0xffffffffu;
  const int g = static_cast<int>(run.g);
  const int gmax = __reduce_max_sync(all, g);
  if (__all_sync(all, g == gmax || g < 0)) {
    if (gmax < 0) return;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j < s.nvalues) {
        long long x = run.acc[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const long long y = __shfl_xor_sync(all, x, off);
          x = s.op[j] == kSum ? wadd(x, y) : (s.op[j] == kMin ? (y < x ? y : x)
                                                              : (y > x ? y : x));
        }
        run.acc[j] = x;
      }
    }
    long long c = run.n;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(all, c, off);
    run.n = c;
    run.g = gmax;
    if ((threadIdx.x & 31) == 0) flush(s, run, sm, width);
  } else if (run.g >= 0) {
    flush(s, run, sm, width);
  }
}

// kNarrow: every column is at most 4 bytes (rows are read as whole words
// through a ring of R rows and tested in int32); otherwise rows are read
// element by element and tested in int64. NC and NV bound the spec's
// columns and values (the loops over them are unrolled).
template <bool kNarrow, int NC, int NV, int R>
__global__ void __launch_bounds__(kThreads)
leaf_agg_kernel(const LeafSpec s, int64_t n, long long* out) {
  extern __shared__ long long sm[];  // [groups][nvalues + 1]
  const int width = s.nvalues + 1;
  const int slots = s.groups * width;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const int j = i % width;
    sm[i] = j < s.nvalues ? identity(s.op[j]) : 0;
  }
  __syncthreads();

  Run<NV> run;
#pragma unroll
  for (int j = 0; j < NV; ++j) run.acc[j] = j < s.nvalues ? identity(s.op[j]) : 0;
  run.n = 0;
  run.g = -1;
  int bad = 0;

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kNarrow) {
    // slot u of the ring holds the words of row `row + u * stride`; once
    // its row is tested, the slot loads the row R strides further on.
    unsigned int ring[R][NC + 1];
    int shift[NC + 1];
    word_shifts<NC>(s, row, shift);
#pragma unroll
    for (int u = 0; u < R; ++u) load_words<NC>(s, row + u * stride, n, ring[u]);
    for (; row < n; row += R * stride) {
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int64_t i = row + u * stride;
        int v[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          v[k] = k < s.ncols ? extract(ring[u][k], 8 * s.size[k], shift[k]) : 0;
        }
        const bool live = ((ring[u][NC] >> shift[NC]) & 0xffu) != 0;
        process<int, NC, NV>(s, v, live, run, bad, sm, width);
        load_words<NC>(s, i + R * stride, n, ring[u]);
      }
    }
  } else {
    for (; row < n; row += stride) {
      long long v[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) v[k] = k < s.ncols ? load_wide(s.col[k], s.size[k], row) : 0;
      process<long long, NC, NV>(s, v, s.live[row] != 0, run, bad, sm, width);
    }
  }
  flush_warp(s, run, sm, width);

  const int any_bad = __syncthreads_or(bad);  // also the barrier for `sm`
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const int j = i % width;
    fold(out + i, j < s.nvalues ? s.op[j] : kSum, sm[i]);
  }
  if (threadIdx.x == 0 && any_bad) {
    atomicAdd(reinterpret_cast<unsigned long long*>(out + slots), 1ull);
  }
}

template <bool kNarrow, int NC, int NV, int R>
int launch(const LeafSpec& s, int64_t n, long long* out, cudaStream_t stream) {
  auto kernel = leaf_agg_kernel<kNarrow, NC, NV, R>;
  const int smem = s.groups * (s.nvalues + 1) * static_cast<int>(sizeof(long long));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int blocks = presto::grid_blocks(kernel, n, kThreads, smem, R);
  kernel<<<blocks, kThreads, smem, stream>>>(s, n, out);
  return static_cast<int>(cudaGetLastError());
}

// [lo, hi] as the same test on int32 values: exact, since every value of
// a column of at most 4 bytes lies in the int32 range (an empty interval
// becomes [1, 0]).
void clamp_int32(long long& lo, long long& hi) {
  if (lo > INT_MAX || hi < INT_MIN || lo > hi) {
    lo = 1;
    hi = 0;
  } else {
    lo = lo < INT_MIN ? INT_MIN : lo;
    hi = hi > INT_MAX ? INT_MAX : hi;
  }
}

}  // namespace

// Launch on `stream`. Columns: `cols`/`sizes` (ncols <= 32). `colp`:
// [ncols][6] int64 per column: filter lo, filter hi, guard lo, guard hi,
// key multiplier, and (in row 0 only, slot 5) the gid base; a filter or
// guard of (INT64_MIN, INT64_MAX) and a multiplier of 0 mean none.
// `valp`: [nvalues][9] int64 per value: op (0 sum, 1 min, 2 max), has_b,
// bits, a.col, a.c0, a.c1, b.col, b.c0, b.c1 (nvalues <= 32). `live`:
// bool [n]. `out`: int64[groups * (nvalues + 1) + 1], set by the caller
// to each slot's identity (0, or the int64 extremes for min and max):
// out[g * (nvalues + 1) + j] is value j of group g, then the group's
// count, and the last slot is nonzero when value_overflow is set.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments beyond the kernel's limits (checked first in Python).
extern "C" int leaf_agg_launch(const void* const* cols, const int* sizes, int ncols,
                               const long long* colp, const long long* valp,
                               int nvalues, int groups, const void* live, long long n,
                               long long* out, void* stream) {
  if (ncols < 0 || ncols > kMaxCols || nvalues < 0 || nvalues > kMaxValues ||
      groups < 1 || groups > kMaxGroups || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LeafSpec s = {};
  // the shape of Q6 and the SSB Q1 flight: rows read as words, tested in int32
  bool narrow = ncols <= 4 && nvalues <= 1;
  for (int k = 0; k < ncols; ++k) {
    if (sizes[k] != 1 && sizes[k] != 2 && sizes[k] != 4 && sizes[k] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    narrow = narrow && sizes[k] <= 4;
    s.col[k] = cols[k];
    s.size[k] = sizes[k];
    s.flo[k] = colp[6 * k + 0];
    s.fhi[k] = colp[6 * k + 1];
    s.glo[k] = colp[6 * k + 2];
    s.ghi[k] = colp[6 * k + 3];
    s.kmul[k] = colp[6 * k + 4];
    if (s.kmul[k] != 0) s.kmask |= 1u << k;
  }
  if (narrow) {
    for (int k = 0; k < ncols; ++k) {
      clamp_int32(s.flo[k], s.fhi[k]);
      clamp_int32(s.glo[k], s.ghi[k]);
    }
  }
  s.gbase = ncols > 0 ? colp[5] : 0;
  for (int j = 0; j < nvalues; ++j) {
    const long long* p = valp + 9 * j;
    if (p[0] < kSum || p[0] > kMax || p[3] >= ncols || p[6] >= ncols) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    s.op[j] = static_cast<int>(p[0]);
    s.has_b[j] = static_cast<int>(p[1]);
    s.bits[j] = static_cast<int>(p[2]);
    s.a[j] = Term{p[4], p[5], p[3] < 0 ? 0u : 1u << p[3]};
    s.b[j] = Term{p[7], p[8], p[6] < 0 ? 0u : 1u << p[6]};
  }
  s.live = static_cast<const unsigned char*>(live);
  s.ncols = ncols;
  s.nvalues = nvalues;
  s.groups = groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (narrow) return launch<true, 4, 1, 4>(s, n, out, st);
  return launch<false, kMaxCols, kMaxValues, 1>(s, n, out, st);
}

extern "C" const char* leaf_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
