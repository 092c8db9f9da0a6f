// String predicates over fixed-width byte rows: SQL LIKE with '%' and the
// prefix test.
//
// Replaces presto_tpu/ops/pallas_strings.py::like_mask_pallas (Pallas body
// `_like_kernel`) and ::starts_with_pallas (`_prefix_kernel`). Rows are
// [n, W] uint8, zero-padded on the right (a zero byte never appears in
// content); the result is a bool per row over EVERY row (dead rows are not
// masked). The logical length of a row is its count of nonzero bytes.
//
// LIKE. The pattern is split on '%' on the host into a program: a mode and,
// for the general mode, its nonempty literal segments and two anchor flags.
//   mode 0  ''              rows of length 0
//   mode 1  only '%'        every row
//   mode 2  no '%'          the row equals the literal zero-padded to W
//                           (a literal longer than W matches no row)
//   mode 3  segments        a leading segment (pattern does not start with
//                           '%') is compared at offset 0; each interior
//                           segment at its greedy EARLIEST occurrence at or
//                           after the running position; the last segment of
//                           an end-anchored pattern only as the suffix at
//                           the logical length, at or after the running
//                           position ('%1' matches '...011'). A segment
//                           longer than W matches no row.
// This is the algorithm of presto_tpu/ops/strings.py::like_mask.
//
// Bound on the H100: the bytes moved, n * (W + 1) (each row read once, one
// bool written); at 3.35 TB/s a 1.5M-row 79-byte column is about 36 us.
// Design: one block per tile of rows (256 rows, fewer for wide rows so the
// tile stays within 48 KB of shared memory). The tile is one contiguous run
// of rows * W bytes in device memory; the block reads it with 16-byte
// vector loads (a byte head and tail take the unaligned ends) and scatters
// it into shared memory with a row stride padded to an odd number of
// 32-bit words, so the 32 threads of a warp, each reading the same column
// of its own row, hit 32 different banks. Then each thread matches one row
// from shared memory and may stop at the first failed segment. The pattern
// program is a small device buffer, so the kernel takes any number of
// segments and any width. The TPU kernel's int32 widening of the bytes,
// its [tile, 1] column vectors and its fully unrolled per-pattern program
// have no counterpart: the pattern is data here, not code.
//
// Prefix. One thread per row in a grid-stride loop reads the first L bytes
// of its row straight from device memory and stops at the first mismatch;
// nothing else of the row is touched. Bound: n * (L + 1) bytes.

#include "common.cuh"

namespace {

constexpr int kMaxTileRows = 256;
constexpr int kTileBytes = 48 * 1024;
constexpr int kPrefixThreads = 256;
constexpr int kPrefixRows = 4;  // rows a thread covers per grid pass, for sizing

enum Mode { kEmpty = 0, kAll = 1, kEqual = 2, kSegments = 3 };

// Program layout (int32): [mode, anchored_start, anchored_end, nseg,
// len_0, ..., len_{nseg-1}]; the segment bytes follow one another in `pat`.
//
// Control flow: a lane that leaves a loop early must wait for its warp at
// the loop's end, never run ahead on its own. A mismatch that jumps out of
// two loops at once (return from inside the byte loop of the position
// loop) let each lane that had matched a first byte split from its warp
// and run alone until the next full match: the first version of this
// kernel ran 10x slower on a pattern whose first byte is common. So the
// byte comparisons below run to the end of the segment (no early exit),
// and only a found position or the end of the row leaves the scan.
__device__ __forceinline__ bool equal_at(const uint8_t* row, int s, const uint8_t* seg,
                                         int len) {
  bool eq = true;
  for (int j = 0; j < len; ++j) eq &= row[s + j] == __ldg(&seg[j]);
  return eq;
}

// The count of nonzero bytes (not the index of the first zero).
__device__ __forceinline__ int row_length(const uint8_t* row, int width) {
  int length = 0;
  for (int c = 0; c < width; ++c) length += row[c] != 0;
  return length;
}

// The earliest s in [pos, last] at which `seg` (len >= 1) occurs in the
// row, or -1. The first byte filters each position; the rest of the
// segment is compared only where it matched.
__device__ __forceinline__ int find_from(const uint8_t* row, int pos, int last,
                                         const uint8_t* seg, int len) {
  const uint8_t first = __ldg(&seg[0]);
  int found = -1;
  for (int s = pos; s <= last; ++s) {
    bool hit = row[s] == first;
    if (hit) hit = equal_at(row, s + 1, seg + 1, len - 1);
    if (hit) {
      found = s;
      break;
    }
  }
  return found;
}

__device__ __forceinline__ bool like_row(const uint8_t* row, int width,
                                         const int32_t* __restrict__ prog,
                                         const uint8_t* __restrict__ pat) {
  const int mode = __ldg(&prog[0]);
  if (mode == kAll) return true;
  if (mode == kEmpty) return row_length(row, width) == 0;
  const int nseg = __ldg(&prog[3]);
  const int32_t* lens = prog + 4;
  if (mode == kEqual) {
    // the literal zero-padded to W: its bytes, then zeros to the end
    const int len = __ldg(&lens[0]);
    if (len > width) return false;
    bool eq = equal_at(row, 0, pat, len);
    for (int c = len; c < width; ++c) eq &= row[c] == 0;
    return eq;
  }
  const bool anchored_start = __ldg(&prog[1]) != 0;
  const bool anchored_end = __ldg(&prog[2]) != 0;
  const int inner = anchored_end ? nseg - 1 : nseg;
  bool ok = true;
  int pos = 0;
  int off = 0;
  for (int i = 0; i < inner && ok; ++i) {
    const int len = __ldg(&lens[i]);
    const uint8_t* seg = pat + off;
    off += len;
    if (len > width) {
      ok = false;
    } else if (i == 0 && anchored_start) {
      ok = equal_at(row, 0, seg, len);
      pos = len;
    } else {
      const int s = find_from(row, pos, width - len, seg, len);
      ok = s >= 0;
      pos = s + len;
    }
  }
  if (ok && anchored_end) {
    const int len = __ldg(&lens[nseg - 1]);
    const int s = row_length(row, width) - len;  // s + len <= width always
    ok = len <= width && s >= pos && s >= 0 && equal_at(row, s, pat + off, len);
  }
  return ok;
}

__global__ void __launch_bounds__(kMaxTileRows)
like_kernel(const uint8_t* __restrict__ data, int64_t n, int width, int stride,
            int tile_rows, const int32_t* __restrict__ prog, const uint8_t* __restrict__ pat,
            bool* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t tile[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int64_t rows = n - row0 < tile_rows ? n - row0 : tile_rows;
  const int64_t nbytes = rows * width;
  const uint8_t* src = data + row0 * width;
  // the tile's bytes: an unaligned head, 16-byte vectors, an unaligned tail
  const int64_t mis = (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(src) & 15)) & 15;
  const int64_t head = mis < nbytes ? mis : nbytes;
  const int64_t nvec = (nbytes - head) >> 4;
  const int64_t tail = head + (nvec << 4);
  for (int64_t b = threadIdx.x; b < head; b += blockDim.x) {
    const int r = static_cast<int>(b / width);
    tile[r * stride + static_cast<int>(b - static_cast<int64_t>(r) * width)] = src[b];
  }
  const uint4* vec = reinterpret_cast<const uint4*>(src + head);
  for (int64_t v = threadIdx.x; v < nvec; v += blockDim.x) {
    const uint4 x = __ldg(&vec[v]);
    const uint8_t* xb = reinterpret_cast<const uint8_t*>(&x);
    const int64_t b = head + (v << 4);
    int r = static_cast<int>(b / width);
    int c = static_cast<int>(b - static_cast<int64_t>(r) * width);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      tile[r * stride + c] = xb[j];
      if (++c == width) {
        c = 0;
        ++r;
      }
    }
  }
  for (int64_t b = tail + threadIdx.x; b < nbytes; b += blockDim.x) {
    const int r = static_cast<int>(b / width);
    tile[r * stride + static_cast<int>(b - static_cast<int64_t>(r) * width)] = src[b];
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;
  out[row0 + threadIdx.x] = like_row(tile + threadIdx.x * stride, width, prog, pat);
}

__global__ void __launch_bounds__(kPrefixThreads)
prefix_kernel(const uint8_t* __restrict__ data, int64_t n, int width,
              const uint8_t* __restrict__ prefix, int len, bool* __restrict__ out) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const uint8_t* row = data + i * width;
    bool ok = true;
    for (int j = 0; j < len && ok; ++j) ok = __ldg(&row[j]) == __ldg(&prefix[j]);
    out[i] = ok;
  }
}

}  // namespace

// Launch LIKE over `n` rows of `width` bytes on `stream`. `prog` and `pat`
// are the device program (see above). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a row too wide for 32 rows of shared
// memory.
extern "C" int like_launch(const void* data, long long n, int width, const void* prog,
                           const void* pat, void* out, void* stream) {
  if (n <= 0) return 0;
  if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
  int words = (width + 3) / 4;
  if (words % 2 == 0) words += 1;  // odd stride: a warp's rows in distinct banks
  const int stride = 4 * words;
  int tile_rows = kTileBytes / stride;
  tile_rows = tile_rows >= kMaxTileRows ? kMaxTileRows : tile_rows / 32 * 32;
  if (tile_rows < 32) tile_rows = 32;
  const int smem = tile_rows * stride;
  if (smem > kTileBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        like_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (n + tile_rows - 1) / tile_rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  like_kernel<<<static_cast<unsigned>(blocks), tile_rows, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, width, stride, tile_rows,
      static_cast<const int32_t*>(prog), static_cast<const uint8_t*>(pat),
      static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launch the prefix test over `n` rows of `width` bytes on `stream`:
// out[i] = the first `len` bytes of row i equal `prefix` (1 <= len <= width,
// checked in Python, which answers the empty and the too-long prefix itself).
extern "C" int prefix_launch(const void* data, long long n, int width, const void* prefix,
                             int len, void* out, void* stream) {
  if (n <= 0) return 0;
  if (len < 1 || len > width) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = presto::grid_blocks(prefix_kernel, n, kPrefixThreads, 0, kPrefixRows);
  prefix_kernel<<<blocks, kPrefixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, width, static_cast<const uint8_t*>(prefix), len,
      static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* strings_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
