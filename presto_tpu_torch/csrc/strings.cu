// String predicates over fixed-width byte rows: SQL LIKE with '%' and the
// prefix test.
//
// Replaces presto_tpu/ops/pallas_strings.py::like_mask_pallas (Pallas body
// `_like_kernel`) and ::starts_with_pallas (`_prefix_kernel`). Rows are
// [n, W] uint8, zero-padded on the right (a zero byte never appears in
// content); the result is a bool per row over EVERY row (dead rows are not
// masked). The logical length of a row is its count of nonzero bytes.
//
// LIKE. The pattern is split on '%' on the host (ops/cuda_strings.py):
//   ''          rows of length 0
//   only '%'    every row
//   no '%'      the row equals the literal zero-padded to W (a literal
//               longer than W matches no row)
//   segments    a leading segment (pattern does not start with '%') is
//               compared at offset 0; each interior segment at its greedy
//               EARLIEST occurrence at or after the running position; the
//               last segment of an end-anchored pattern only as the suffix
//               at the logical length, at or after the running position
//               ('%1' matches '...011'). A segment longer than W matches no
//               row.
// This is the algorithm of presto_tpu/ops/strings.py::like_mask.
//
// Bound on the H100: the bytes moved, n * (W + 1) (each row read once, one
// bool written); at 3.35 TB/s a 1.5M-row 79-byte column is about 36 us.
// Matching does a handful of integer operations and one shared-memory
// table load a byte, about as long again, so the copy has to overlap it.
// It does, and the matching sets the time: on an H100 at 700 W SF1
// o_comment takes about 0.065 ms from a warm L2 and 0.066 from a cold one
// (the inner loop is 34 instructions and 5 shared-memory loads a word).
//
// What held the first design back: one block per tile of 256 rows read
// its whole tile, waited at a barrier, then matched, so no block's copy
// overlapped its own matching; it scattered each 16-byte load into shared
// memory a byte at a time (with a 64-bit division per vector); and its
// matcher walked a row byte by byte with a data-dependent exit, testing
// each position's first byte and re-reading the pattern from global
// memory in the innermost loop.
//
// Design:
// - A persistent grid (at most the blocks the card holds at once), each
//   block walking a contiguous run of tiles of T rows (256, fewer only for
//   rows too wide for 2 stages of shared memory; T a multiple of 16, so a
//   tile is T * W bytes, a multiple of 16). One producer thread brings
//   each tile into a ring of 2-4 stages with Hopper's 1-D bulk copy
//   (cp.async.bulk, one mbarrier a stage counting the bytes), while 256
//   consumer threads match the tile before, one row each. The first
//   tiles' copies start before the block stages its program. The rows keep
//   the column's unpadded layout (a padded one would cost the bulk copy
//   its contiguity, and a 2-D tensor copy needs a row stride that is a
//   multiple of 16 bytes): a thread reads its row 4 bytes at a time as a
//   funnel shift of two aligned words. A warp's lanes, W bytes apart,
//   meet some bank conflicts there; a version whose lanes took rows 4
//   apart (for an odd W their starts fall in 32 different banks) ran no
//   faster on SF1 o_comment, so the plain order stayed (the row words are
//   a fifth of the shared-memory loads).
// - A base that is not 16-byte aligned (a view) takes the direct
//   instance, as does the ragged last tile of the staged one: the
//   consumers copy the tile with aligned 16-byte loads into shared memory
//   at the base's offset modulo 16 (contiguous stores, no scatter), then
//   match it with the same code.
// - The program (ops/cuda_strings.py::like_kernel_program) is copied into
//   shared memory once a block; nothing of the pattern is read from global
//   memory while matching.
// - The matchers. Shift-And (the main path's patterns, and every pattern
//   with at most 4 interior segments of at most 64 bytes and anchored
//   segments of at most 256): the leading segment is compared a word at a
//   time, then one automaton walks the row's bytes from its end over the
//   interior segments in turn: D = ((D << 1) | 1) & mask[segment][byte],
//   the segment found when bit len - 1 of D is set (its earliest end, so
//   its earliest start: the greedy rule), the next segment searched from
//   the byte after it. 32-bit masks take segments of up to 32 bytes, 64-bit
//   ones up to 64. A byte costs a byte extract, one shared-memory table
//   load and three or four integer operations, with no branch but the
//   rare "found" one: no warp splits per position. A word's four table
//   loads are issued together and its four steps run with no branch
//   between them (a first version branched after each step, so the
//   compiler issued each table load after the branch before it and the
//   loads ran one after another); a segment found inside the word, which
//   moves the automaton to the next table, sends the word back through a
//   byte-at-a-time path. The row's next word is loaded while this one is
//   matched, so no load waits on a step. The trailing segment is compared
//   a word at a time at the logical length, which is one popcount a word.
//   Any other pattern
//   takes the bytes matcher: the earlier kernel's byte-by-byte matcher
//   (earliest occurrence, first-byte filter), its program in shared memory
//   when it fits (16 KB).
// The TPU kernel's int32 widening of the bytes, its [tile, 1] column
// vectors and its fully unrolled per-pattern program have no counterpart:
// the pattern is data here, not code.
//
// Prefix. out[i] = the first L bytes of row i equal the prefix (1 <= L <=
// W; the empty and the too-long prefix are answered in Python).
//
// Bound on the H100: the bytes moved, n * (L + 1) (each row's L prefix
// bytes read once, one bool written); at 3.35 TB/s the main path's
// 131,072-row, 55-byte `part` split with 'forest' (L = 6) is 0.27 us, SF1
// o_comment (1.5M rows of 79 bytes) with a 6-byte prefix 3.1 us. Two
// floors lie above it. Sectors: rows are W >= 32 bytes apart, so each
// row's window brings in whole 32-byte sectors of its own, on average
// 1 + (L - 1) / 32 of them: about 4.8 MB (1.4 us) for the part split and
// 56 MB (17 us) for o_comment (chip_smoke.py counts the sectors of the
// run's own data). One wave: at 131,072 rows every thread's loads make one
// trip to device memory after the launch, which on this card is about
// 2.5 us for the one-wave probe kernels of the same row count.
//
// What held the first design back: a thread a row walked the
// prefix byte by byte, `ok = row[j] == prefix[j]` while ok, so it issued
// each byte's load only after the compare before it (L dependent trips to
// device memory for a matching row) and re-read the prefix from device
// memory at every step; a warp split wherever its rows first differed.
//
// Design:
// - The prefix rides in the launch's parameters, as up to 16 little-endian
//   32-bit words (64 bytes; ops/cuda_strings.py::prefix_kernel_program
//   lays them out), so the compare reads the constant bank, never device
//   memory. A longer prefix takes the second path of the same kernel
//   (template word count 0): the block stages the prefix's words in shared
//   memory once, then compares from there.
// - A thread tests one row i. It reads the aligned 32-bit words that hold
//   bytes [s, s + L) of the buffer, s = i * W plus the base's offset
//   modulo 4: ceil(L / 4) words always and one more only when the window
//   reaches into it, at most ceil(L / 4) + 1. With the prefix in the
//   parameters the word count is a template argument (1-16), so every load
//   is issued before any compare. Then each row word is a funnel shift of
//   two loaded words into the row's alignment, XORed with the prefix word,
//   the last one masked to the prefix's bytes in it, and the differences
//   are ORed: one branch-free boolean a row, no early exit, no divergence.
//   Two and four rows a thread (with one packed store of their booleans)
//   were tried and measured slower on both timed shapes (PERF.md).
// - Memory safety (compute-sanitizer does not run on that machine, so by
//   construction): only aligned words that contain a byte of the row's
//   window [s, s + L) are read, and such a word lies in the same aligned
//   4-byte block as a byte of the tensor, so it never reaches past the
//   tensor's storage.
// - Views: a base that is not 4-byte aligned goes through the same shifts
//   (the kernel reads words from the base rounded down to 4 bytes and adds
//   the offset to s); there is no separate instance.

#include <cstring>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kConsumers = 256;            // matching threads: a row each a tile
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxStages = 4;
constexpr int kRingTarget = 48 * 1024;     // ring bytes a block aims for (2-4 stages)
constexpr int kSmemBudget = 200 * 1024;    // a block's shared memory at most
constexpr int kBarrierBytes = 128;
constexpr int kPadBytes = 32;              // past the ring: a matcher's reads overrun a row
constexpr int kMaxStagedProgram = 16 * 1024;
constexpr int kPrefixThreads = 128;
constexpr int kParamWords = 16;                // a prefix of up to 64 bytes rides in the parameters
constexpr int kMaxStagedPrefix = 48 * 1024;    // bytes of a longer one, in shared memory

// Shift-And program header (ops/cuda_strings.py::like_kernel_program)
enum Header : int {
  kNeedLen = 0,   // the logical length a row must have, or -1
  kEvery = 1,     // every row matches
  kStartLen = 2,  // bytes of the leading segment (0: none)
  kEndLen = 3,    // bytes of the trailing segment (0: none)
  kInterior = 4,  // interior segments (at most 4)
  kLens = 5,      // their lengths
  kStartAt = 9,   // word offsets of the leading bytes, trailing bytes, tables
  kEndAt = 10,
  kTablesAt = 11,
};

// the bytes matcher's program modes (ops/cuda_strings.py::like_program)
enum Mode { kEmpty = 0, kAll = 1, kEqual = 2, kSegments = 3 };

// matchers and instances, in cuda_strings.LIKE_INSTANCES's order: a
// matcher, plus 3 for the direct instances
enum Matcher : int { kShift32 = 0, kShift64 = 1, kBytes = 2 };

struct LikeArgs {
  const uint8_t* data;
  long long n;
  bool* out;
  const uint32_t* prog;      // the program in device memory
  int prog_words;
  unsigned int prog_bytes;   // its room in shared memory (a multiple of 16; 0: not staged)
  int width;
  int tile_rows;
  unsigned int tile_bytes;   // tile_rows * width, a multiple of 16
  int stages;                // ring stages (0: every tile direct)
};

// ---------------------------------------------------------------------------
// A row in shared memory: `base` 4-byte aligned, the row at byte `off`.
// ---------------------------------------------------------------------------

// the 4 bytes at byte offset `at` of the tile (any alignment), little-endian
__device__ __forceinline__ uint32_t bytes4(const uint32_t* base, int at) {
  const int w = at >> 2;
  return __funnelshift_r(base[w], base[w + 1], (at & 3) * 8);
}

// nonzero bytes of a word
__device__ __forceinline__ int nonzero4(uint32_t x) {
  const uint32_t t = ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x;
  return __popc(t & 0x80808080u);
}

// the first k (0..3) bytes of a word
__device__ __forceinline__ uint32_t low_bytes(uint32_t x, int k) {
  return k == 0 ? 0u : x & (0xffffffffu >> (32 - 8 * k));
}

// The logical length: the count of the row's nonzero bytes.
__device__ __forceinline__ int row_length(const uint32_t* base, int off, int width) {
  int length = 0;
  int c = 0;
  for (; c + 4 <= width; c += 4) length += nonzero4(bytes4(base, off + c));
  if (c < width) length += nonzero4(low_bytes(bytes4(base, off + c), width - c));
  return length;
}

// Whether the `len` bytes at byte `at` of the tile equal `seg` (words,
// zero-padded), a word at a time, with no early exit.
__device__ __forceinline__ bool equal_words(const uint32_t* base, int at, const uint32_t* seg,
                                            int len) {
  uint32_t diff = 0;
  int q = 0;
  for (; 4 * q + 4 <= len; ++q) diff |= bytes4(base, at + 4 * q) ^ seg[q];
  if (4 * q < len) diff |= low_bytes(bytes4(base, at + 4 * q) ^ seg[q], len - 4 * q);
  return diff == 0;
}

// The automaton over a row's interior segments: its state `d`, the
// current segment's table `m` and found bit `hi` (0 once every interior
// segment is found), and the byte after the last segment found (`pos`).
template <typename T>
struct Automaton {
  T d = 0;
  T hi;
  const T* m;
  int seg = 0;
  int pos;

  // the segment ended at byte c: search the next one from c + 1
  __device__ __forceinline__ void found(int c, const int32_t* lens, int nint) {
    ++seg;
    pos = c + 1;
    d = 0;
    const bool more = seg < nint;
    hi = more ? T(1) << (lens[seg] - 1) : T(0);
    m += more ? 256 : 0;
  }

  __device__ __forceinline__ void step(uint32_t b, int c, const int32_t* lens, int nint) {
    d = ((d << 1) | T(1)) & m[b];
    if (d & hi) found(c, lens, nint);  // rare
  }

  // The 4 bytes of x, from byte c on. Their 4 table entries are loaded
  // before any step and the 4 steps run without a branch between them;
  // only when a segment ends inside the word, which is rare, is the word
  // redone a byte at a time from the state before it (a found segment
  // moves the automaton to the next segment's table).
  __device__ __forceinline__ void word(uint32_t x, int c, const int32_t* lens, int nint) {
    const T e0 = m[__byte_perm(x, 0, 0x4440)];
    const T e1 = m[__byte_perm(x, 0, 0x4441)];
    const T e2 = m[__byte_perm(x, 0, 0x4442)];
    const T e3 = m[__byte_perm(x, 0, 0x4443)];
    const T d1 = ((d << 1) | T(1)) & e0;
    const T d2 = ((d1 << 1) | T(1)) & e1;
    const T d3 = ((d2 << 1) | T(1)) & e2;
    const T d4 = ((d3 << 1) | T(1)) & e3;
    if (((d1 | d2 | d3 | d4) & hi) == 0) {
      d = d4;
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) step(__byte_perm(x, 0, 0x4440 + j), c + j, lens, nint);
  }
};

// The Shift-And matchers (T = uint32_t or unsigned long long masks).
template <typename T>
__device__ __forceinline__ bool shift_and_row(const uint32_t* base, int off, int width,
                                              const uint32_t* prog) {
  const int32_t* h = reinterpret_cast<const int32_t*>(prog);
  if (h[kEvery]) return true;
  const int start = h[kStartLen];
  const int end = h[kEndLen];
  const int nint = h[kInterior];
  bool ok = true;
  if (start > 0) ok = start <= width && equal_words(base, off, prog + h[kStartAt], start);
  int pos = start;
  if (nint > 0 && start < width) {
    Automaton<T> a;
    a.m = reinterpret_cast<const T*>(prog + h[kTablesAt]);
    a.hi = T(1) << (h[kLens] - 1);
    a.pos = start;
    const int32_t* lens = h + kLens;
    // the bytes from `start` on, 4 at a time from aligned words, the
    // next word's load in flight while this one is matched
    const int at = off + start;
    const int count = width - start;
    const uint32_t* w = base + (at >> 2);
    const uint32_t sh = (at & 3) * 8;
    uint32_t lo = w[0];
    uint32_t up = w[1];
    int c = 0;
    for (; c + 4 <= count; c += 4) {
      const uint32_t ahead = w[2];
      const uint32_t x = __funnelshift_r(lo, up, sh);
      lo = up;
      up = ahead;
      ++w;
      a.word(x, start + c, lens, nint);
    }
    if (c < count) {
      const uint32_t x = __funnelshift_r(lo, up, sh);
      for (int j = 0; j < count - c; ++j)
        a.step(__byte_perm(x, 0, 0x4440 + j), start + c + j, lens, nint);
    }
    ok = ok && a.seg == nint;
    pos = a.pos;
  } else if (nint > 0) {
    ok = false;  // no byte left for an interior segment
  }
  const int need = h[kNeedLen];
  if (end > 0 || need >= 0) {
    const int length = row_length(base, off, width);
    if (need >= 0) ok = ok && length == need;
    if (end > 0) {
      const int s = length - end;  // s + end <= width always
      ok = ok && end <= width && s >= pos && equal_words(base, off + s, prog + h[kEndAt], end);
    }
  }
  return ok;
}

// ---------------------------------------------------------------------------
// The bytes matcher (any pattern): the program of like_program, its
// segment bytes after the lengths. Control flow: a lane that leaves a loop
// early must wait for its warp at the loop's end, never run ahead on its
// own (a mismatch that jumped out of two loops at once let each lane that
// had matched a first byte split from its warp), so the byte comparisons
// run to the end of the segment and only a found position or the end of
// the row leaves the scan.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool bytes_equal_at(const uint8_t* row, int s, const uint8_t* seg,
                                               int len) {
  bool eq = true;
  for (int j = 0; j < len; ++j) eq &= row[s + j] == seg[j];
  return eq;
}

__device__ __forceinline__ int bytes_length(const uint8_t* row, int width) {
  int length = 0;
  for (int c = 0; c < width; ++c) length += row[c] != 0;
  return length;
}

// The earliest s in [pos, last] at which `seg` (len >= 1) occurs, or -1.
__device__ __forceinline__ int bytes_find(const uint8_t* row, int pos, int last,
                                          const uint8_t* seg, int len) {
  const uint8_t first = seg[0];
  int found = -1;
  for (int s = pos; s <= last; ++s) {
    bool hit = row[s] == first;
    if (hit) hit = bytes_equal_at(row, s + 1, seg + 1, len - 1);
    if (hit) {
      found = s;
      break;
    }
  }
  return found;
}

__device__ __forceinline__ bool bytes_row(const uint8_t* row, int width, const uint32_t* prog) {
  const int32_t* p = reinterpret_cast<const int32_t*>(prog);
  const int mode = p[0];
  if (mode == kAll) return true;
  if (mode == kEmpty) return bytes_length(row, width) == 0;
  const int nseg = p[3];
  const int32_t* lens = p + 4;
  const uint8_t* pat = reinterpret_cast<const uint8_t*>(p + 4 + nseg);
  if (mode == kEqual) {
    // the literal zero-padded to W: its bytes, then zeros to the end
    const int len = lens[0];
    if (len > width) return false;
    bool eq = bytes_equal_at(row, 0, pat, len);
    for (int c = len; c < width; ++c) eq &= row[c] == 0;
    return eq;
  }
  const bool anchored_start = p[1] != 0;
  const bool anchored_end = p[2] != 0;
  const int inner = anchored_end ? nseg - 1 : nseg;
  bool ok = true;
  int pos = 0;
  int off = 0;
  for (int i = 0; i < inner && ok; ++i) {
    const int len = lens[i];
    const uint8_t* seg = pat + off;
    off += len;
    if (len > width) {
      ok = false;
    } else if (i == 0 && anchored_start) {
      ok = bytes_equal_at(row, 0, seg, len);
      pos = len;
    } else {
      const int s = bytes_find(row, pos, width - len, seg, len);
      ok = s >= 0;
      pos = s + len;
    }
  }
  if (ok && anchored_end) {
    const int len = lens[nseg - 1];
    const int s = bytes_length(row, width) - len;  // s + len <= width always
    ok = len <= width && s >= pos && s >= 0 && bytes_equal_at(row, s, pat + off, len);
  }
  return ok;
}

template <int M>
__device__ __forceinline__ bool match_row(const unsigned char* tile, int off, int width,
                                          const uint32_t* prog) {
  if constexpr (M == kShift32) {
    return shift_and_row<uint32_t>(reinterpret_cast<const uint32_t*>(tile), off, width, prog);
  } else if constexpr (M == kShift64) {
    return shift_and_row<unsigned long long>(reinterpret_cast<const uint32_t*>(tile), off,
                                             width, prog);
  } else {
    return bytes_row(tile + off, width, prog);
  }
}

// the consumers' own barrier (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

template <int M>
__global__ void __launch_bounds__(kThreads) like_kernel(LikeArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint32_t* staged_prog = reinterpret_cast<uint32_t*>(smem + kBarrierBytes);
  unsigned char* ring = smem + kBarrierBytes + a.prog_bytes;
  const int64_t rows_per_tile = a.tile_rows;
  const int64_t tiles = (a.n + rows_per_tile - 1) / rows_per_tile;
  int64_t first, last;
  presto::block_tiles(tiles, first, last);
  const int64_t staged_end = a.stages > 0 ? a.n / rows_per_tile : 0;  // full tiles only
  const int64_t ring_last = last < staged_end ? last : staged_end;

  // The producer sets up the ring and starts the copies of the first
  // tiles (as many as there are stages) before the block waits for the
  // program, so the two overlap; the rest follow as stages free up.
  const bool producer = threadIdx.x == kConsumers;
  int64_t t_next = first;
  presto::RingPos next;
  const auto issue = [&]() {
    presto::mbar_expect_tx(&full[next.stage], a.tile_bytes);
    presto::bulk_load(ring + static_cast<size_t>(next.stage) * a.tile_bytes,
                      a.data + t_next * static_cast<int64_t>(a.tile_bytes), a.tile_bytes,
                      &full[next.stage]);
    ++t_next;
    next.next(a.stages);
  };
  if (producer) {
    for (int s = 0; s < a.stages; ++s) {
      presto::mbar_init(&full[s], 1);
      presto::mbar_init(&empty[s], kConsumers / 32);
    }
    presto::mbar_init_fence();
    while (t_next < ring_last && !next.reuse) issue();
  }
  for (int i = threadIdx.x; a.prog_bytes != 0 && i < a.prog_words; i += blockDim.x)
    staged_prog[i] = __ldg(a.prog + i);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (producer) {
      while (t_next < ring_last) {
        presto::mbar_wait(&empty[next.stage], next.parity ^ 1u);
        issue();
      }
    }
    __syncwarp();
    return;
  }

  const int ct = threadIdx.x;
  // the Shift-And programs are always staged, so their table loads are
  // shared-memory loads; the bytes matcher's may stay in device memory
  const uint32_t* prog = M != kBytes || a.prog_bytes != 0 ? staged_prog : a.prog;
  presto::RingPos p;
  for (int64_t t = first; t < last; ++t) {
    const int64_t r0 = t * rows_per_tile;
    const int64_t left = a.n - r0;
    const int rows = static_cast<int>(left < rows_per_tile ? left : rows_per_tile);
    const bool from_ring = t < ring_last;
    const unsigned char* tile = ring;
    int off = ct * a.width;
    if (from_ring) {
      presto::mbar_wait(&full[p.stage], p.parity);
      tile = ring + static_cast<size_t>(p.stage) * a.tile_bytes;
    } else {
      // read directly: the tile's bytes land at the base's offset modulo
      // 16, by aligned 16-byte loads and stores
      const uint8_t* src = a.data + r0 * a.width;
      const int head = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
      const uint4* from = reinterpret_cast<const uint4*>(src - head);
      const int nvec = (head + rows * a.width + 15) >> 4;
      consumers_sync();  // every consumer is done with the buffer's last use
      uint4* to = reinterpret_cast<uint4*>(ring);
      for (int v = ct; v < nvec; v += kConsumers) to[v] = __ldg(from + v);
      consumers_sync();
      off += head;
    }
    if (ct < rows) a.out[r0 + ct] = match_row<M>(tile, off, a.width, prog);
    if (from_ring) {
      __syncwarp();
      if ((ct & 31) == 0) presto::mbar_arrive(&empty[p.stage]);
      p.next(a.stages);
    }
  }
}

// The prefix's words, by value in the launch's parameters.
struct PrefixWords {
  uint32_t w[kParamWords];
};

// The prefix's last word holds len & 3 of its bytes (4 when that is 0).
__device__ __forceinline__ uint32_t tail_mask(int len) {
  const int r = len & 3;
  return r ? (1u << (8 * r)) - 1u : 0xffffffffu;
}

// NW > 0: a prefix of NW words in `pre`; NW == 0: a longer one, `staged`
// from `long_pre` (len bytes as words). `words` is the rows' base rounded
// down to 4 bytes and `head` the base's offset from it (0-3). A row a
// thread, each grid pass.
template <int NW>
__global__ void __launch_bounds__(kPrefixThreads)
prefix_kernel(const uint32_t* __restrict__ words, int head, int64_t n, int width,
              const PrefixWords pre, int len, const uint32_t* __restrict__ long_pre,
              bool* __restrict__ out) {
  extern __shared__ uint32_t staged[];
  const int nw = NW > 0 ? NW : (len + 3) >> 2;
  if constexpr (NW == 0) {
    for (int k = threadIdx.x; k < nw; k += blockDim.x) staged[k] = long_pre[k];
    __syncthreads();
  }
  const uint32_t last = tail_mask(len);
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int64_t s = head + i * width;
    const uint32_t* p = words + (s >> 2);
    const int off = static_cast<int>(s & 3);
    const uint32_t shift = 8u * off;
    uint32_t diff = 0;
    if constexpr (NW > 0) {
      // every load first ...
      uint32_t w[NW + 1];
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = __ldg(p + k);
      w[NW] = off + len > 4 * NW ? __ldg(p + NW) : 0u;
      // ... then the compares, with no branch
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        uint32_t x = __funnelshift_r(w[k], w[k + 1], shift) ^ pre.w[k];
        if (k == NW - 1) x &= last;
        diff |= x;
      }
    } else {
      uint32_t cur = __ldg(p);
#pragma unroll 8
      for (int k = 0; k < nw; ++k) {
        const uint32_t nxt = k + 1 < nw || off + len > 4 * nw ? __ldg(p + k + 1) : 0u;
        uint32_t x = __funnelshift_r(cur, nxt, shift) ^ staged[k];
        if (k == nw - 1) x &= last;
        diff |= x;
        cur = nxt;
      }
    }
    out[i] = diff == 0;
  }
}

using PrefixKernel = void (*)(const uint32_t*, int, int64_t, int, PrefixWords, int,
                              const uint32_t*, bool*);

// prefix_kernel<nw> for nw = 0 (the staged path) .. kParamWords
template <int... NW>
PrefixKernel prefix_instance(int nw, std::integer_sequence<int, NW...>) {
  static const PrefixKernel table[] = {prefix_kernel<NW>...};
  return table[nw];
}

}  // namespace

// Launch LIKE over `n` rows of `width` bytes on `stream`. `prog` holds
// `prog_words` words of ops/cuda_strings.py::like_kernel_program;
// `instance` (cuda_strings.LIKE_INSTANCES): the matcher (0 Shift-And over
// 32-bit masks, 1 over 64-bit masks, 2 bytes), plus 3 for the direct
// instance. A staged instance needs `data` 16-byte aligned and width > 0.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// an unknown instance or a row too wide for 16 rows of shared memory,
// cudaErrorMisalignedAddress for a staged launch on an unaligned base.
extern "C" int like_launch(const void* data, long long n, int width, const void* prog,
                           int prog_words, int instance, void* out, void* stream) {
  if (instance < 0 || instance > 5 || width < 0 || prog_words < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int matcher = instance % 3;
  const bool staged = instance < 3;
  if (staged && (width == 0 || reinterpret_cast<uintptr_t>(data) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n <= 0) return 0;
  LikeArgs a = {};
  a.data = static_cast<const uint8_t*>(data);
  a.n = n;
  a.out = static_cast<bool*>(out);
  a.prog = static_cast<const uint32_t*>(prog);
  a.prog_words = prog_words;
  const long long prog_room = (4LL * prog_words + 15) / 16 * 16;
  // the Shift-And programs are always staged (at most 8.8 KB)
  a.prog_bytes = prog_room <= kMaxStagedProgram ? static_cast<unsigned int>(prog_room) : 0u;
  if (matcher != kBytes && a.prog_bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  a.width = width;
  // tile rows: 256, fewer (a multiple of 16) when 2 stages (1 buffer for
  // the direct instance) of them do not fit
  const long long fixed = kBarrierBytes + a.prog_bytes + kPadBytes;
  const int least = staged ? 2 : 1;
  long long rows = kConsumers;
  while (rows > 16 && fixed + least * rows * width > kSmemBudget) rows -= 16;
  if (fixed + least * rows * width > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  a.tile_rows = static_cast<int>(rows);
  a.tile_bytes = static_cast<unsigned int>(rows * width);
  int stages = 1;
  if (staged) {
    const long long fit = (kSmemBudget - fixed) / a.tile_bytes;
    const long long want = kRingTarget / a.tile_bytes;
    stages = static_cast<int>(want < 2 ? 2 : (want > kMaxStages ? kMaxStages : want));
    stages = stages < fit ? stages : static_cast<int>(fit);
  }
  a.stages = staged ? stages : 0;
  const int smem = static_cast<int>(fixed + stages * static_cast<long long>(a.tile_bytes));
  const auto go = [&](auto kernel) {
    const int64_t tiles = (n + rows - 1) / rows;
    const int most = presto::resident_blocks(kernel, kThreads, smem);
    const int blocks = static_cast<int>(tiles < most ? tiles : most);
    kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
  };
  switch (matcher) {
    case kShift32: return go(like_kernel<kShift32>);
    case kShift64: return go(like_kernel<kShift64>);
    default: return go(like_kernel<kBytes>);
  }
}

// Launch the prefix test over `n` rows of `width` bytes at `data` (any
// alignment) on `stream`: out[i] = the first `len` bytes of row i equal the
// prefix (1 <= len <= width, checked in Python, which answers the empty and
// the too-long prefix itself). The prefix is ceil(len / 4) little-endian
// words: `host_words` (host memory, copied into the launch's parameters)
// when there are at most 16, else `dev_words` (device memory, staged in
// shared memory; at most 48 KB). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments outside those limits.
extern "C" int prefix_launch(const void* data, long long n, int width, const void* host_words,
                             const void* dev_words, int len, void* out, void* stream) {
  if (n <= 0) return 0;
  if (len < 1 || len > width) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (len + 3) / 4;
  const bool param = nw <= kParamWords;
  if (param ? host_words == nullptr : (dev_words == nullptr || 4 * nw > kMaxStagedPrefix))
    return static_cast<int>(cudaErrorInvalidValue);
  PrefixWords pw = {};
  if (param) memcpy(pw.w, host_words, 4 * static_cast<size_t>(nw));
  const uintptr_t at = reinterpret_cast<uintptr_t>(data);
  const PrefixKernel kernel =
      prefix_instance(param ? nw : 0, std::make_integer_sequence<int, kParamWords + 1>{});
  const int smem = param ? 0 : 4 * nw;
  const int blocks = presto::grid_blocks(kernel, n, kPrefixThreads, smem, 1);
  kernel<<<blocks, kPrefixThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(at & ~static_cast<uintptr_t>(3)),
      static_cast<int>(at & 3), n, width, pw, len, static_cast<const uint32_t*>(dev_words),
      static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* strings_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
