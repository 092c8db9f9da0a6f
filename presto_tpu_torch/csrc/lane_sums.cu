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
// What held the first design back: each thread loaded one column at a
// time and waited out a DRAM round trip per column (10 a row at Q1's
// shapes), and its per-thread int64 tables took 110 KB of shared memory,
// which capped an SM at 16 warps to hide that latency.
//
// Design, against that bound:
// - A persistent grid (at most the blocks the card holds at once), each
//   block walking a contiguous run of tiles of 2048 rows. One producer
//   thread brings each tile's gid, values and masks into a ring of up to
//   4 stages in shared memory with Hopper's 1-D bulk copy (cp.async.bulk,
//   one mbarrier a stage counting the bytes): every column of the next
//   tiles is in flight at once, whatever the consumers are doing, and no
//   thread spends registers on it.
// - Each consumer thread (128 a block) takes 16 consecutive rows of a
//   tile: 16-byte shared loads (4 for a 4-byte column, in an order
//   rotated by lane pair so a quarter warp touches all 32 banks; 1 for a
//   byte mask, tested for nonzero 4 bytes an instruction).
// - Partial sums are int64 in shared memory, laid out [slot][copy] with
//   slot = g*(k+m)+j. Up to kPrivateSlots slots (Q1: 54, the counts-only
//   Q4 and LIKE shapes: 5-10), every consumer thread has its own copy
//   (64 KB at most) and adds with a plain load and store. The main path's
//   (k, m) are template instances that hold all of a thread's 16 rows of
//   every column in registers and update a row's k + m slots together:
//   their loads overlap, and only the next row waits on this row's
//   stores (a loop column by column waits out one shared-memory round
//   trip per row and column). The counts-only shapes over at most 8
//   groups (Q4's priority count, `q_like_phone`) count a thread's rows in
//   registers instead, a byte lane per group, and touch the table once
//   at the end. Wider tables share fewer copies (64 KB in all) through
//   shared-memory atomics.
// - After the loop, one warp per slot sums the block's copies and makes
//   one 64-bit atomicAdd into the caller-zeroed output: one per slot per
//   resident block.
// - The ragged last tile, and every tile of a launch whose columns do
//   not all start 16-byte aligned (a view) or whose ring of 2 stages
//   does not fit beside its table (about 9 values or more), are read
//   with plain global loads (the "direct" instance), by the same
//   consumer code: a thread then takes every 128th row of the tile, so
//   a warp's lanes load adjacent rows.
// - The compiled shapes are those the main path sends: 4 values and 5
//   masks (the Q1 pipeline) and counts of 1 mask (Q4, `q_like_phone`);
//   any other shape takes the instance with run-time (k, m).
// No 8-bit lanes or 2^23-row majors are needed: int64 is native here.

#include "common.cuh"

namespace {

constexpr int kMaxValues = 16;
constexpr int kMaxMasks = 16;
constexpr int kSlotLimit = 1024;
constexpr int kConsumers = 128;             // consumer threads (4 warps)
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kTile = kConsumers * 16;      // rows a tile: 16 a consumer thread
constexpr int kMaxStages = 4;
constexpr int kPrivateSlots = 64;           // per-thread tables up to 64 KB
constexpr int kSharedTableBytes = 64 * 1024;
constexpr int kSmemBudget = 220 * 1024;     // of the 227 KB a block may take
constexpr int kBarrierBytes = 128;

// Instances, in the order of cuda_groupby.INSTANCES.
enum Instance : int {
  kStagedK4M5 = 0,  // the Q1 pipeline: 4 values, 5 masks
  kStagedK0M1 = 1,  // counts only, 1 mask: Q4 and q_like_phone
  kStaged = 2,      // any (k, m) with a private table
  kStagedShared = 3,
  kDirect = 4,
  kInstances = 5,
};

struct LaneArgs {
  const int32_t* value[kMaxValues];
  int bits[kMaxValues];
  const uint8_t* mask[kMaxMasks];
  const int32_t* gid;
  long long n;
  int k, m, groups;
  int copies;            // table copies
  int staged;            // full tiles come through the ring
  int stages;
  unsigned int stage_bytes;
  unsigned int table_bytes;  // a multiple of 128: the barriers, then the ring, follow
};

// A thread's 16 rows of an int32 column into x. From a stage: 16
// consecutive rows in 4 16-byte loads, chunk q of x taking chunk
// (q + rot) & 3 of the rows. Direct: rows col[kConsumers * u] (a warp's
// lanes read adjacent rows), those at or past `left` as `pad`.
__device__ __forceinline__ void rows_i32(int32_t (&x)[16], const unsigned char* stage,
                                         const int32_t* col, int64_t left, int rot,
                                         int32_t pad) {
  if (stage != nullptr) {
    const int4* p = reinterpret_cast<const int4*>(stage);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 w = p[(q + rot) & 3];
      x[4 * q + 0] = w.x;
      x[4 * q + 1] = w.y;
      x[4 * q + 2] = w.z;
      x[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 16; ++u) x[u] = kConsumers * u < left ? col[kConsumers * u] : pad;
  }
}

// The nonzero test of a thread's 16 mask bytes as 4 words of 0/1 bytes,
// in the row order of rows_i32.
__device__ __forceinline__ void rows_nz(uint32_t (&w)[4], const unsigned char* stage,
                                        const uint8_t* col, int64_t left, int rot) {
  if (stage != nullptr) {
    const uint4 v = *reinterpret_cast<const uint4*>(stage);
    uint32_t a = v.x, b = v.y, c = v.z, d = v.w;
    if (rot & 1) {
      const uint32_t t = a;
      a = b;
      b = c;
      c = d;
      d = t;
    }
    if (rot & 2) {
      uint32_t t = a;
      a = c;
      c = t;
      t = b;
      b = d;
      d = t;
    }
    w[0] = a;
    w[1] = b;
    w[2] = c;
    w[3] = d;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t x = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = 4 * q + e;
        x |= (kConsumers * u < left ? static_cast<uint32_t>(col[kConsumers * u]) : 0u)
             << (8 * e);
      }
      w[q] = x;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = __vcmpne4(w[q], 0u) & 0x01010101u;
}

// Whether some |x[u]| is at or above 2^bits (bits < 31; 31 bounds
// nothing an int32 holds).
__device__ __forceinline__ int out_of_bounds(const int32_t (&x)[16], int bits) {
  const uint32_t high = bits < 31 ? ~0u << bits : 0u;
  uint32_t any = 0;
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const uint32_t mag = x[u] < 0 ? 0u - static_cast<uint32_t>(x[u]) : static_cast<uint32_t>(x[u]);
    any |= mag & high;
  }
  return any != 0;
}

template <bool kPrivate>
__device__ __forceinline__ void slot_add(unsigned long long* p, long long v) {
  if (kPrivate) {
    *p += static_cast<unsigned long long>(v);
  } else if (v != 0) {
    atomicAdd(p, static_cast<unsigned long long>(v));
  }
}

// K, M: the value and mask counts when fixed at compile time (-1: read
// from the arguments). kPrivate: one table copy per consumer thread.
template <int K, int M, bool kPrivate>
__global__ void __launch_bounds__(kThreads) lane_sums_kernel(const LaneArgs a,
                                                             unsigned long long* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k = K >= 0 ? K : a.k;
  const int m = M >= 0 ? M : a.m;
  const int width = k + m;
  const int slots = a.groups * width;
  const int copies = kPrivate ? kConsumers : a.copies;
  unsigned long long* table = reinterpret_cast<unsigned long long*>(smem);  // [slots][copies]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.table_bytes);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + a.table_bytes + kBarrierBytes;
  for (int i = threadIdx.x; i < slots * copies; i += blockDim.x) table[i] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      presto::mbar_init(&full[s], 1);
      presto::mbar_init(&empty[s], kConsumers / 32);
    }
    presto::mbar_init_fence();
  }
  __syncthreads();

  const int64_t tiles = (a.n + kTile - 1) / kTile;
  int64_t first, last;
  presto::block_tiles(tiles, first, last);
  const int64_t staged_end = a.staged ? a.n / kTile : 0;  // full tiles only
  const int64_t ring_last = last < staged_end ? last : staged_end;
  // stage layout: gid, the values, the masks (each a multiple of 16 bytes)
  const unsigned int mask_off = static_cast<unsigned int>(kTile) * 4 * (1 + k);
  int bad = 0;

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {  // the producer
      presto::RingPos p;
      for (int64_t t = first; t < ring_last; ++t, p.next(a.stages)) {
        if (p.reuse) presto::mbar_wait(&empty[p.stage], p.parity ^ 1u);
        presto::mbar_expect_tx(&full[p.stage], a.stage_bytes);
        unsigned char* st = ring + static_cast<size_t>(p.stage) * a.stage_bytes;
        const int64_t r0 = t * kTile;
        presto::bulk_load(st, a.gid + r0, kTile * 4, &full[p.stage]);
#pragma unroll
        for (int j = 0; j < (K >= 0 ? K : kMaxValues); ++j) {
          if (j < k) presto::bulk_load(st + kTile * 4 * (1 + j), a.value[j] + r0, kTile * 4,
                                       &full[p.stage]);
        }
#pragma unroll
        for (int j = 0; j < (M >= 0 ? M : kMaxMasks); ++j) {
          if (j < m) presto::bulk_load(st + mask_off + kTile * j, a.mask[j] + r0, kTile,
                                       &full[p.stage]);
        }
      }
    }
    __syncwarp();
  } else {
    const int ct = threadIdx.x;
    const int copy = kPrivate ? ct : ct % copies;
    const int rot = (ct >> 1) & 3;
    // counts only over at most 8 groups (Q4's and the LIKE query's 5):
    // each thread counts in registers and adds them to its table copy once
    constexpr bool kCounts = K == 0 && M > 0 && kPrivate;
    uint32_t acc[kCounts ? 8 : 1][kCounts ? M : 1] = {};
    presto::RingPos p;
    for (int64_t t = first; t < last; ++t) {
      const bool from_ring = t < ring_last;
      const unsigned char* st = nullptr;
      if (from_ring) {
        presto::mbar_wait(&full[p.stage], p.parity);
        st = ring + static_cast<size_t>(p.stage) * a.stage_bytes;
      }
      // a thread's rows: 16 consecutive ones from a stage, every
      // kConsumers-th one read directly (coalesced across the warp)
      const int64_t r0 = t * kTile + (from_ring ? 16 * ct : ct);
      const int64_t left = a.n - r0;  // direct rows at or past it do not exist
      const int rr = from_ring ? rot : 0;
      int32_t g[16];
      rows_i32(g, st != nullptr ? st + 64 * ct : nullptr, a.gid + r0, left, rr, -1);
      unsigned int in = 0;
      int base[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const bool i_ = static_cast<unsigned int>(g[u]) < static_cast<unsigned int>(a.groups);
        in |= static_cast<unsigned int>(i_) << u;
        base[u] = (i_ ? g[u] : 0) * width * copies + copy;
      }
      if (kCounts && a.groups <= 8) {
        if constexpr (kCounts) {
          // a byte-lane counter per group (4 a word) for the thread's 16
          // rows, then into the 32-bit counts: no shared memory on the way
#pragma unroll
          for (int j = 0; j < M; ++j) {
            uint32_t w[4];
            rows_nz(w, st != nullptr ? st + mask_off + kTile * j + 16 * ct : nullptr,
                    a.mask[j] + r0, left, rr);
            uint32_t lo = 0, hi = 0;
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              const uint32_t one = ((in >> u) & (w[u >> 2] >> (8 * (u & 3)))) & 1u;
              const uint32_t lane = one << (8 * (g[u] & 3));
              lo += g[u] < 4 ? lane : 0u;
              hi += g[u] >= 4 ? lane : 0u;
            }
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[q][j] += ((q < 4 ? lo : hi) >> (8 * (q & 3))) & 0xffu;
          }
        }
      } else if constexpr (K >= 0 && M >= 0 && kPrivate) {
        // a compiled shape: every column's 16 rows in registers, then row
        // by row all of the row's slots at once (distinct addresses: the
        // loads overlap, and only the next row's wait on this row's stores)
        int32_t x[K > 0 ? K : 1][16];
        uint32_t w[M > 0 ? M : 1][4];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          rows_i32(x[j], st != nullptr ? st + kTile * 4 * (1 + j) + 64 * ct : nullptr,
                   a.value[j] + r0, left, rr, 0);
          bad |= out_of_bounds(x[j], a.bits[j]);
        }
#pragma unroll
        for (int j = 0; j < M; ++j) {
          rows_nz(w[j], st != nullptr ? st + mask_off + kTile * j + 16 * ct : nullptr,
                  a.mask[j] + r0, left, rr);
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if ((in >> u) & 1u) {
            unsigned long long* row = table + base[u];
            unsigned long long cur[K + M];
#pragma unroll
            for (int j = 0; j < K + M; ++j) cur[j] = row[j * copies];
#pragma unroll
            for (int j = 0; j < K; ++j) cur[j] += static_cast<unsigned long long>(
                                            static_cast<long long>(x[j][u]));
#pragma unroll
            for (int j = 0; j < M; ++j) cur[K + j] += (w[j][u >> 2] >> (8 * (u & 3))) & 1u;
#pragma unroll
            for (int j = 0; j < K + M; ++j) row[j * copies] = cur[j];
          }
        }
      } else {
        // any shape: column by column
        for (int j = 0; j < k; ++j) {
          int32_t x[16];
          rows_i32(x, st != nullptr ? st + kTile * 4 * (1 + j) + 64 * ct : nullptr,
                   a.value[j] + r0, left, rr, 0);
          bad |= out_of_bounds(x, a.bits[j]);
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            if ((in >> u) & 1u) slot_add<kPrivate>(table + base[u] + j * copies, x[u]);
          }
        }
        for (int j = 0; j < m; ++j) {
          uint32_t w[4];
          rows_nz(w, st != nullptr ? st + mask_off + kTile * j + 16 * ct : nullptr,
                  a.mask[j] + r0, left, rr);
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            if ((in >> u) & 1u) {
              slot_add<kPrivate>(table + base[u] + (k + j) * copies,
                                 (w[u >> 2] >> (8 * (u & 3))) & 1u);
            }
          }
        }
      }
      if (from_ring) {
        __syncwarp();
        if ((ct & 31) == 0) presto::mbar_arrive(&empty[p.stage]);
        p.next(a.stages);
      }
    }
    if constexpr (kCounts) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q < a.groups && a.groups <= 8) {
#pragma unroll
          for (int j = 0; j < M; ++j) table[(q * width + j) * copies + copy] += acc[q][j];
        }
      }
    }
  }

  const int any_bad = __syncthreads_or(bad);  // also the barrier for the table
  presto::flush_slots(table, slots, copies, out);
  if (threadIdx.x == 0 && any_bad) atomicAdd(&out[slots], 1ull);
}

template <int K, int M, bool kPrivate>
int launch(LaneArgs& a, unsigned long long* out, cudaStream_t stream) {
  auto kernel = lane_sums_kernel<K, M, kPrivate>;
  const int smem = static_cast<int>(a.table_bytes) + kBarrierBytes +
                   (a.staged ? a.stages * static_cast<int>(a.stage_bytes) : 0);
  const int64_t tiles = (a.n + kTile - 1) / kTile;
  const int most = presto::resident_blocks(kernel, kThreads, smem);
  const int blocks = static_cast<int>(tiles < most ? tiles : most);
  kernel<<<blocks, kThreads, smem, stream>>>(a, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch instance `instance` (cuda_groupby.INSTANCES) on `stream`.
// `out`: int64[G*(k+m) + 1], zeroed by the caller; out[g*(k+m) + j] is
// value j's sum (j < k) or mask (j-k)'s count in group g, out[G*(k+m)]
// is nonzero when a declared bound was violated. A staged instance
// needs every column to start 16-byte aligned and its ring of at least
// 2 stages to fit beside the table. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments beyond the kernel's
// limits or an instance that does not fit them (checked first in Python).
extern "C" int lane_sums_launch(const void* const* values, const int* bits, int k,
                                const void* const* masks, int m, const void* gid,
                                int groups, long long n, long long* out, int instance,
                                void* stream) {
  const int slots = groups * (k + m);
  if (k < 0 || k > kMaxValues || m < 0 || m > kMaxMasks || groups < 1 ||
      slots > kSlotLimit || n < 1 || instance < 0 || instance >= kInstances) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaneArgs a = {};
  uintptr_t align = reinterpret_cast<uintptr_t>(gid);
  for (int j = 0; j < k; ++j) {
    a.value[j] = static_cast<const int32_t*>(values[j]);
    a.bits[j] = bits[j];
    align |= reinterpret_cast<uintptr_t>(values[j]);
  }
  for (int j = 0; j < m; ++j) {
    a.mask[j] = static_cast<const uint8_t*>(masks[j]);
    align |= reinterpret_cast<uintptr_t>(masks[j]);
  }
  a.gid = static_cast<const int32_t*>(gid);
  a.n = n;
  a.k = k;
  a.m = m;
  a.groups = groups;

  const bool priv = slots <= kPrivateSlots;
  const int slot_bytes = (slots > 0 ? slots : 1) * 8;
  int copies = priv ? kConsumers : kSharedTableBytes / slot_bytes;
  copies = copies > kConsumers ? kConsumers : (copies < 1 ? 1 : copies);
  a.copies = copies;
  a.table_bytes = static_cast<unsigned int>((slot_bytes * copies + 127) / 128 * 128);
  a.stage_bytes = static_cast<unsigned int>(kTile) * (4 + 4 * k + m);
  int stages = (kSmemBudget - static_cast<int>(a.table_bytes) - kBarrierBytes) /
               static_cast<int>(a.stage_bytes);
  stages = stages > kMaxStages ? kMaxStages : stages;
  a.staged = instance != kDirect;
  a.stages = a.staged ? stages : 0;
  const bool fits = stages >= 2 && (align & 15) == 0;
  const bool shape = instance == kStagedK4M5   ? (k == 4 && m == 5 && priv)
                     : instance == kStagedK0M1 ? (k == 0 && m == 1 && priv)
                     : instance == kStaged     ? priv
                     : instance == kStagedShared ? !priv
                                                 : true;
  if (!shape || (a.staged && !fits)) return static_cast<int>(cudaErrorInvalidValue);

  unsigned long long* o = reinterpret_cast<unsigned long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (instance) {
    case kStagedK4M5: return launch<4, 5, true>(a, o, st);
    case kStagedK0M1: return launch<0, 1, true>(a, o, st);
    case kStaged: return launch<-1, -1, true>(a, o, st);
    case kStagedShared: return launch<-1, -1, false>(a, o, st);
    default:
      return priv ? launch<-1, -1, true>(a, o, st) : launch<-1, -1, false>(a, o, st);
  }
}

extern "C" const char* lane_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
