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
// What held the first design back: one 32-bit load, with its own 64-bit
// address arithmetic, per row per column, then a shift and sign
// extension and two compares per filter: some 80-100 instructions a row,
// so the instruction rate and not the bytes bounded it (about 2.4x its
// memory bound resident); and its grid of one ring fill per block
// ended a 2^20-row split in up to 2048 same-address global atomics.
//
// Design, against that bound (the "staged" instance):
// - It takes the shape of TPC-H Q6 and the SSB Q1 flight: at most 4
//   columns of at most 4 bytes (the connector's narrow storage) and at
//   most 1 value, any number of groups.
// - A persistent grid (at most the blocks the card holds at once), each
//   block walking a contiguous run of tiles of 2048 rows. One producer
//   thread brings each column's tile (one contiguous run of bytes) and
//   `live` into a ring of 2 stages in shared memory with Hopper's 1-D
//   bulk copy (cp.async.bulk, one mbarrier a stage counting the bytes):
//   the next tile's loads are in flight whatever the consumers do, and no
//   address arithmetic is spent per row. The ring is kept small (45 KB a
//   block for Q6, the list and table included) so 4 blocks, 16 consumer
//   warps, share an SM, a limit set by registers (96 a thread): the
//   consumers' latency, not the copies, was what a deeper ring with fewer
//   blocks exposed.
// - Each consumer thread (128 a block) takes 16 consecutive rows of a
//   tile and reads each filtered column as 16-byte words (1 for a 1-byte
//   column, 2 for 2 bytes, 4 for 4). It tests the filter interval on the
//   packed lanes, 4 or 2 rows an instruction, as the unsigned range test
//   (x - lo) <=u (hi - lo) with the SIMD-in-word intrinsics (__vsub4 /
//   __vcmpleu4, __vsub2 / __vcmpleu2), and `live` the same way. The
//   result is a 16-bit pass mask. A column without a filter is never read
//   packed.
// - A warp then lists its passing rows (about 2 % in Q6) in shared memory
//   and all its lanes fold them at once: only they read their elements,
//   test the guards and form the gid and the int64 value product.
// - A thread keeps the running sums, mins, maxes and count of the group
//   its last rows fell in, in registers, and folds them into the block's
//   [groups x (values + 1)] int64 table in shared memory only when the
//   group changes; at the end each warp combines lanes of one group by
//   shuffles first. Each block then adds its table into the output with
//   one global atomic per nonempty slot: one per slot per resident block.
// - The ragged last tile, and every tile of a launch whose columns do not
//   all start 16-byte aligned (a view; the "direct" instance), are read
//   with plain loads, row by row, by the same consumer code: a thread
//   then takes every 128th row of the tile, so a warp's lanes load
//   adjacent rows.
// The "generic" instance takes every other spec (up to 32 columns and 32
// values, 8-byte columns, min/max over several values): a grid-stride
// loop that reads rows element by element and tests them in int64, with
// the same running-group fold.
// The TPU kernel's 8-bit lanes, 2^23-row majors, 1024-slot output tile,
// block-size rule and compile probe have no counterpart: int64 is native
// here, and the kernel takes min/max values, bits > 31 and any capacity.

#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kMaxCols = 32;
constexpr int kMaxValues = 32;
constexpr int kMaxGroups = 512;
constexpr int kThreads = 256;  // the generic instance
constexpr int kConsumers = 128;  // the staged instance: consumer threads
constexpr int kStagedThreads = kConsumers + 32;  // and one producer warp
constexpr int kTile = kConsumers * 16;  // rows a tile: 16 a consumer thread
constexpr int kNarrowCols = 4;
constexpr int kStages = 2;  // a small ring: more blocks, and warps, on an SM
constexpr int kBarrierBytes = 128;
constexpr int kListBytes = kConsumers / 32 * 512 * 2;  // a warp's passing rows

// Instances, in the order of cuda_agg.INSTANCES.
enum Instance : int { kStaged = 0, kDirect = 1, kGeneric = 2, kInstances = 3 };

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

// The staged instance's packed filters and shared-memory layout.
struct Staging {
  unsigned int lo[kNarrowCols + 1];     // per lane, replicated across the word
  unsigned int range[kNarrowCols + 1];  // hi - lo, replicated likewise
  unsigned int off[kNarrowCols + 1];    // column k's bytes in a stage (`live` last)
  unsigned int test;                    // bit k: column k has a filter to test
  int never;                            // some filter is empty: no row passes
  int staged;                           // full tiles come through the ring
  unsigned int stage_bytes;
  unsigned int table_bytes;             // a multiple of 128
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

// Fold one row that passed the filters (its column values `v`) into the
// running state: its guard tests, gid and values.
template <typename T, int NC, int NV>
__device__ __forceinline__ void accept(const LeafSpec& s, const T (&v)[NC], Run<NV>& run,
                                       int& bad, long long* sm, int width) {
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

// The block's table at each slot's identity, and a thread's empty run.
template <int NV>
__device__ __forceinline__ void start(const LeafSpec& s, long long* sm, Run<NV>& run) {
  const int width = s.nvalues + 1;
  for (int i = threadIdx.x; i < s.groups * width; i += blockDim.x) {
    const int j = i % width;
    sm[i] = j < s.nvalues ? identity(s.op[j]) : 0;
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) run.acc[j] = j < s.nvalues ? identity(s.op[j]) : 0;
  run.n = 0;
  run.g = -1;
}

// After the rows: each warp's runs into the table, then the table into
// the output with one global atomic per nonempty slot, and the flag.
template <int NV>
__device__ __forceinline__ void finish(const LeafSpec& s, Run<NV>& run, int bad,
                                       long long* sm, long long* out) {
  const int width = s.nvalues + 1;
  const int slots = s.groups * width;
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

// ---------------------------------------------------------------------------
// the generic instance
// ---------------------------------------------------------------------------

template <int NC, int NV>
__global__ void __launch_bounds__(kThreads)
leaf_agg_kernel(const LeafSpec s, int64_t n, long long* out) {
  extern __shared__ long long sm[];  // [groups][nvalues + 1]
  const int width = s.nvalues + 1;
  Run<NV> run;
  start(s, sm, run);
  __syncthreads();
  int bad = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    long long v[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) v[k] = k < s.ncols ? load_wide(s.col[k], s.size[k], row) : 0;
    // filters without a branch (a column without one has the full range)
    bool pass = s.live[row] != 0;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (k < s.ncols) pass = pass & (v[k] >= s.flo[k]) & (v[k] <= s.fhi[k]);
    }
    if (pass) accept<long long, NC, NV>(s, v, run, bad, sm, width);
  }
  finish(s, run, bad, sm, out);
}

// ---------------------------------------------------------------------------
// the staged instance
// ---------------------------------------------------------------------------

// 4 rows of 1-byte lanes: bit e set where lane e lies in [lo, lo + range].
__device__ __forceinline__ uint32_t lanes4(uint32_t x, uint32_t lo, uint32_t range) {
  const uint32_t e = __vcmpleu4(__vsub4(x, lo), range);  // 0xff per passing lane
  return ((e & 0x80808080u) * 0x00204081u) >> 28;  // the lanes' top bits, gathered
}

// 2 rows of 2-byte lanes, likewise.
__device__ __forceinline__ uint32_t lanes2(uint32_t x, uint32_t lo, uint32_t range) {
  const uint32_t e = __vcmpleu2(__vsub2(x, lo), range);  // 0xffff per passing lane
  return ((e >> 15) & 1u) | ((e >> 30) & 2u);
}

__device__ __forceinline__ uint32_t lane1(uint32_t x, uint32_t lo, uint32_t range) {
  return (x - lo) <= range ? 1u : 0u;
}

// The 16 rows of a column of `size` bytes at p (16-byte aligned, shared
// memory) tested against [lo, lo + range] in the column's width: bit u of
// the result is row u.
__device__ __forceinline__ uint32_t test16(const unsigned char* p, int size, uint32_t lo,
                                           uint32_t range) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint32_t m = 0;
  if (size == 1) {
    const uint4 w = q[0];
    m = lanes4(w.x, lo, range) | (lanes4(w.y, lo, range) << 4) |
        (lanes4(w.z, lo, range) << 8) | (lanes4(w.w, lo, range) << 12);
  } else if (size == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 w = q[h];
      m |= (lanes2(w.x, lo, range) | (lanes2(w.y, lo, range) << 2) |
            (lanes2(w.z, lo, range) << 4) | (lanes2(w.w, lo, range) << 6))
           << (8 * h);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint4 w = q[h];
      m |= (lane1(w.x, lo, range) | (lane1(w.y, lo, range) << 1) |
            (lane1(w.z, lo, range) << 2) | (lane1(w.w, lo, range) << 3))
           << (4 * h);
    }
  }
  return m;
}

// A thread's row u of a tile of `rows` rows read directly: row
// ct + kConsumers * u, clamped to the tile's last row so that every load
// is unconditional (the caller masks the rows that do not exist).
__device__ __forceinline__ int direct_row(int ct, int u, int rows) {
  const int r = ct + kConsumers * u;
  return r < rows ? r : rows - 1;
}

// A thread's 16 direct rows of a column of `size` bytes at p (global
// memory), tested against [lo, hi]: bit u of the result is row u. The
// 16 loads depend on no branch and on each other, so they are issued
// together.
__device__ __forceinline__ uint32_t test_rows(const unsigned char* p, int size, int ct,
                                              int rows, long long lo, long long hi) {
  int c[16];
  if (size == 1) {
    const int8_t* q = reinterpret_cast<const int8_t*>(p);
#pragma unroll
    for (int u = 0; u < 16; ++u) c[u] = q[direct_row(ct, u, rows)];
  } else if (size == 2) {
    const int16_t* q = reinterpret_cast<const int16_t*>(p);
#pragma unroll
    for (int u = 0; u < 16; ++u) c[u] = q[direct_row(ct, u, rows)];
  } else {
    const int32_t* q = reinterpret_cast<const int32_t*>(p);
#pragma unroll
    for (int u = 0; u < 16; ++u) c[u] = q[direct_row(ct, u, rows)];
  }
  uint32_t m = 0;
#pragma unroll
  for (int u = 0; u < 16; ++u) m |= static_cast<uint32_t>((c[u] >= lo) & (c[u] <= hi)) << u;
  return m;
}

// The same rows of `live`: bit u set where the byte is nonzero.
__device__ __forceinline__ uint32_t live_rows(const unsigned char* p, int ct, int rows) {
  unsigned char c[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) c[u] = p[direct_row(ct, u, rows)];
  uint32_t m = 0;
#pragma unroll
  for (int u = 0; u < 16; ++u) m |= static_cast<uint32_t>(c[u] != 0) << u;
  return m;
}

template <int NC, int NV>
__global__ void __launch_bounds__(kStagedThreads)
leaf_staged_kernel(const LeafSpec s, const Staging z, int64_t n, long long* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  long long* sm = reinterpret_cast<long long*>(smem);  // [groups][nvalues + 1]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + z.table_bytes);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + z.table_bytes + kBarrierBytes;
  // each consumer warp's passing rows of a tile, after the ring
  unsigned short* lists =
      reinterpret_cast<unsigned short*>(ring + (z.staged ? kStages * z.stage_bytes : 0));
  const int width = s.nvalues + 1;
  Run<NV> run;
  start(s, sm, run);
  if (threadIdx.x == 0 && z.staged) {
    for (int i = 0; i < kStages; ++i) {
      presto::mbar_init(&full[i], 1);
      presto::mbar_init(&empty[i], kConsumers / 32);
    }
    presto::mbar_init_fence();
  }
  __syncthreads();

  int bad = 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  int64_t first, last;
  presto::block_tiles(tiles, first, last);
  const int64_t staged_end = z.staged ? n / kTile : 0;  // full tiles only
  const int64_t ring_last = last < staged_end ? last : staged_end;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {  // the producer
      presto::RingPos p;
      for (int64_t t = first; t < ring_last; ++t, p.next(kStages)) {
        if (p.reuse) presto::mbar_wait(&empty[p.stage], p.parity ^ 1u);
        presto::mbar_expect_tx(&full[p.stage], z.stage_bytes);
        unsigned char* st = ring + static_cast<size_t>(p.stage) * z.stage_bytes;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          if (k < s.ncols) {
            const int w = s.size[k];
            presto::bulk_load(st + z.off[k],
                              static_cast<const unsigned char*>(s.col[k]) + t * kTile * w,
                              static_cast<uint32_t>(kTile * w), &full[p.stage]);
          }
        }
        presto::bulk_load(st + z.off[kNarrowCols], s.live + t * kTile, kTile, &full[p.stage]);
      }
    }
    __syncwarp();
  } else {
    const int ct = threadIdx.x;
    const int lane = ct & 31;
    unsigned short* list = lists + (ct >> 5) * 512;
    presto::RingPos p;
    for (int64_t t = first; t < last; ++t) {
      const bool from_ring = t < ring_last;
      // the tile's first row of each column (`live` last), and the rows
      // of the thread's 16 that pass every filter: 16 consecutive rows
      // from a stage, every kConsumers-th row read directly (a warp's
      // lanes load adjacent rows)
      const unsigned char* row0[NC + 1];
      uint32_t pass = 0;
      if (from_ring) {
        presto::mbar_wait(&full[p.stage], p.parity);
        const unsigned char* st = ring + static_cast<size_t>(p.stage) * z.stage_bytes;
#pragma unroll
        for (int k = 0; k < NC; ++k) row0[k] = st + z.off[k];
        row0[NC] = st + z.off[kNarrowCols];
        pass = z.never ? 0u : test16(row0[NC] + 16 * ct, 1, z.lo[kNarrowCols],
                                     z.range[kNarrowCols]);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          if (k < s.ncols && ((z.test >> k) & 1u)) {
            pass &= test16(row0[k] + 16 * ct * s.size[k], s.size[k], z.lo[k], z.range[k]);
          }
        }
      } else {
        const int64_t t0 = t * kTile;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          row0[k] = k < s.ncols ? static_cast<const unsigned char*>(s.col[k]) + t0 * s.size[k]
                                : nullptr;
        }
        row0[NC] = s.live + t0;
        // the thread's rows ct + kConsumers * u that exist (`have` of
        // them), each column's 16 loads in flight at once
        const int rows = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
        const int have = ct < rows ? (rows - ct + kConsumers - 1) / kConsumers : 0;
        pass = z.never ? 0u : ((1u << have) - 1u) & live_rows(row0[NC], ct, rows);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          if (k < s.ncols && ((z.test >> k) & 1u)) {
            pass &= test_rows(row0[k], s.size[k], ct, rows, s.flo[k], s.fhi[k]);
          }
        }
      }
      // the warp's passing rows into its list (a prefix sum of the lanes'
      // counts), then folded by all its lanes at once: one pass over the
      // list, not one per passing row of its busiest lane
      const int count = __popc(pass);
      int end = count;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, end, o);
        if (lane >= o) end += y;
      }
      const int total = __shfl_sync(0xffffffffu, end, 31);
      if (total > 0) {
        // bit u of `pass` is tile row 16 * ct + u from a stage, ct + kConsumers * u direct
        const int first_row = from_ring ? 16 * ct : ct;
        const int step = from_ring ? 1 : kConsumers;
        for (int i = end - count; pass != 0; ++i) {
          list[i] = static_cast<unsigned short>(first_row + step * (__ffs(pass) - 1));
          pass &= pass - 1;
        }
        __syncwarp();
        for (int i = lane; i < total; i += 32) {
          const int r = list[i];
          int v[NC];
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            v[k] = k < s.ncols ? presto::load_int(row0[k], s.size[k], r) : 0;
          }
          accept<int, NC, NV>(s, v, run, bad, sm, width);
        }
        __syncwarp();
      }
      if (from_ring) {
        __syncwarp();
        if ((ct & 31) == 0) presto::mbar_arrive(&empty[p.stage]);
        p.next(kStages);
      }
    }
  }
  finish(s, run, bad, sm, out);
}

int launch_generic(const LeafSpec& s, int64_t n, long long* out, cudaStream_t stream) {
  auto kernel = leaf_agg_kernel<kMaxCols, kMaxValues>;
  const int smem = s.groups * (s.nvalues + 1) * static_cast<int>(sizeof(long long));
  const int most = presto::resident_blocks(kernel, kThreads, smem);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < most ? want : most);
  kernel<<<blocks, kThreads, smem, stream>>>(s, n, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_staged(const LeafSpec& s, const Staging& z, int64_t n, long long* out,
                  cudaStream_t stream) {
  auto kernel = leaf_staged_kernel<kNarrowCols, 1>;
  const int smem = static_cast<int>(z.table_bytes) + kBarrierBytes + kListBytes +
                   (z.staged ? kStages * static_cast<int>(z.stage_bytes) : 0);
  const int most = presto::resident_blocks(kernel, kStagedThreads, smem);
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int blocks = static_cast<int>(tiles < most ? tiles : most);
  kernel<<<blocks, kStagedThreads, smem, stream>>>(s, z, n, out);
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

// Column k's filter as the packed test of the staged instance: [lo, hi]
// cut to the range of its `size` bytes; none where that is the whole
// range, `never` where it is empty.
void pack_filter(Staging& z, int k, int size, long long lo, long long hi) {
  const int bits = 8 * size;
  const long long tmin = -(1ll << (bits - 1));
  const long long tmax = (1ll << (bits - 1)) - 1;
  lo = lo < tmin ? tmin : lo;
  hi = hi > tmax ? tmax : hi;
  if (lo > hi) {
    z.never = 1;
    return;
  }
  if (lo == tmin && hi == tmax) return;
  const unsigned int mask = bits == 32 ? 0xffffffffu : (1u << bits) - 1u;
  const unsigned int l = static_cast<unsigned int>(lo) & mask;
  const unsigned int r = static_cast<unsigned int>(hi - lo) & mask;
  const unsigned int rep = size == 1 ? 0x01010101u : (size == 2 ? 0x00010001u : 1u);
  z.lo[k] = l * rep;
  z.range[k] = r * rep;
  z.test |= 1u << k;
}

}  // namespace

// Launch instance `instance` (cuda_agg.INSTANCES: 0 staged, 1 direct, 2
// generic) on `stream`. Columns: `cols`/`sizes` (ncols <= 32). `colp`:
// [ncols][6] int64 per column: filter lo, filter hi, guard lo, guard hi,
// key multiplier, and (in row 0 only, slot 5) the gid base; a filter or
// guard of (INT64_MIN, INT64_MAX) and a multiplier of 0 mean none.
// `valp`: [nvalues][9] int64 per value: op (0 sum, 1 min, 2 max), has_b,
// bits, a.col, a.c0, a.c1, b.col, b.c0, b.c1 (nvalues <= 32). `live`:
// bool [n]. `out`: int64[groups * (nvalues + 1) + 1], set by the caller
// to each slot's identity (0, or the int64 extremes for min and max):
// out[g * (nvalues + 1) + j] is value j of group g, then the group's
// count, and the last slot is nonzero when value_overflow is set. The
// staged and direct instances take at most 4 columns of at most 4 bytes
// and at most 1 value; the staged one also needs every column and `live`
// to start 16-byte aligned. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments beyond the kernel's limits or an
// instance that does not take them (checked first in Python).
extern "C" int leaf_agg_launch(const void* const* cols, const int* sizes, int ncols,
                               const long long* colp, const long long* valp,
                               int nvalues, int groups, const void* live, long long n,
                               long long* out, int instance, void* stream) {
  if (ncols < 0 || ncols > kMaxCols || nvalues < 0 || nvalues > kMaxValues ||
      groups < 1 || groups > kMaxGroups || n < 1 || instance < 0 || instance >= kInstances) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LeafSpec s = {};
  bool narrow = ncols <= kNarrowCols && nvalues <= 1;
  uintptr_t align = reinterpret_cast<uintptr_t>(live);
  for (int k = 0; k < ncols; ++k) {
    if (sizes[k] != 1 && sizes[k] != 2 && sizes[k] != 4 && sizes[k] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    narrow = narrow && sizes[k] <= 4;
    align |= reinterpret_cast<uintptr_t>(cols[k]);
    s.col[k] = cols[k];
    s.size[k] = sizes[k];
    s.flo[k] = colp[6 * k + 0];
    s.fhi[k] = colp[6 * k + 1];
    s.glo[k] = colp[6 * k + 2];
    s.ghi[k] = colp[6 * k + 3];
    s.kmul[k] = colp[6 * k + 4];
    if (s.kmul[k] != 0) s.kmask |= 1u << k;
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
  if (instance == kGeneric) return launch_generic(s, n, out, st);
  if (!narrow || (instance == kStaged && (align & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  // rows are tested in int32: the bounds clamped to it exactly
  Staging z = {};
  int row_bytes = 1;
  for (int k = 0; k < ncols; ++k) {
    clamp_int32(s.flo[k], s.fhi[k]);
    clamp_int32(s.glo[k], s.ghi[k]);
    pack_filter(z, k, s.size[k], s.flo[k], s.fhi[k]);
    z.off[k] = static_cast<unsigned int>(kTile * (row_bytes - 1));
    row_bytes += s.size[k];
  }
  z.off[kNarrowCols] = static_cast<unsigned int>(kTile * (row_bytes - 1));
  z.lo[kNarrowCols] = 0x01010101u;  // `live`: a byte in [1, 255]
  z.range[kNarrowCols] = 0xfefefefeu;
  z.staged = instance == kStaged;
  z.stage_bytes = static_cast<unsigned int>(kTile * row_bytes);
  z.table_bytes = static_cast<unsigned int>(
      (groups * (nvalues + 1) * static_cast<int>(sizeof(long long)) + 127) / 128 * 128);
  return launch_staged(s, z, n, out, st);
}

extern "C" const char* leaf_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
