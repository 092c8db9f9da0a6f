// Fused equi-join probes against small flat lookup tables.
//
// Replaces presto_tpu/ops/pallas_join.py::exists_probe (Pallas body
// `_exists_kernel`), ::payload_probe (`_payload_kernel`), ::sketch_probe
// (`_sketch_kernel`) and ::q3_probe_step (`_q3_kernel`):
// - exists:  hit = kmin <= key <= kmax && bit (key - kmin) of the int32
//            word table is set; out = live && valid && hit (keep), or
//            live && !(valid && hit) (anti), bool.
// - payload: hit = live && valid && kmin <= key <= kmax && present[key -
//            kmin]; matched = hit (and, for an inner join, its new live
//            mask: the same bytes in a tensor of its own), and each of the
//            nval int32 value tables gives out_j = hit ? table_j[key -
//            kmin] : 0, stored in the build column's width (1, 2 or 4
//            bytes truncated, 8 sign-extended, as .to(dtype) casts).
// - sketch:  (s1, s2) = the two Bloom slots of int32(key) (the murmur3
//            finalizer of the key and of key ^ kSketchSeed, masked to
//            nbits, as ops/hashing.py::mix32_slots; int8 and int16 keys
//            sign-extended first); out = live && valid && bit s1 && bit
//            s2 of the word table. Approximate by construction.
// - q3:      over one lineitem batch, hit = live && shipdate > cutoff &&
//            0 <= slot && slot / 32 < W && bit slot (slot = key - kmin);
//            out = (count of hits, sum over hits of ep * (100 - disc)),
//            int64.
// The in-range tests compare in 64 bits, never through the subtraction,
// so an out-of-domain key can never alias into a table; the slot is
// formed only under that test.
//
// Bound on the H100: the bytes moved. A probe row reads its key (1, 2 or
// 4 bytes as the connector narrowed it), its live byte and, when the key
// has one, its validity byte, and writes one bool (payload: one or two
// mask bytes, plus each value in its column's width); at 3.35 TB/s a
// 2^20-row exists probe of int32 keys moves 6 MB, about 2 us. The exists,
// payload and sketch tables are at most 64 KB (16384 words), so after the
// first touches they live in L1/L2 and their reads cost no device-memory
// bytes. The q3 step reads 12 bytes a row (key 4, shipdate 2, ep 4, disc
// 1, live 1) and its bitmask (750 KB at SF1) stays in L2: lineitem
// arrives order by order, so neighbouring rows hit the same words.
//
// The exists, sketch and payload probes are latency-bound at the main
// path's sizes (131,072 to 2^20 rows): a row's table read waits on its
// key. So each thread of their vector instances owns a group of R = 16 /
// key bytes consecutive rows (4 int32, 8 int16 or 16 int8 keys) and
// issues every load of the group before it uses one: one 16-byte load of
// keys, one R-byte load of live bytes (and of validity bytes), then all
// the group's table words (R for exists and payload's present test, 2R
// for sketch), independent of each other, then R-byte stores. A thread
// pays two round trips, not two a row. A dead row or a NULL key reads
// word 0, which its warp shares, so only live keys gather. The grid
// covers ceil(n / R) threads, in blocks of 256 when that gives every SM a
// block and of 128 otherwise, so 2^20 int32 rows are one wave and 131,072
// rows spread over every SM; past one wave a thread takes further groups
// and issues the next group's key and live loads before the current
// group's table reads. The exists and sketch tables stay in L2 through
// __ldg (staging 64 KB in every block would move more bytes than the
// probe reads); the threads first ask L2 for the table's lines, so a cold
// launch's table reads do not wait on device memory. The ragged tail (n
// mod R rows) is done a row a thread in the same launch. A view that does
// not start aligned to its group (keys 16 bytes, live, validity and the
// masks R bytes) takes a scalar instance, a row a thread. The exists and
// sketch kernels take an output mode at compile time: keep (out = live &&
// valid && hit: the semi join's and the payload-free inner join's new live
// mask, and the plain probe with no validity) or anti (out = live &&
// !(valid && hit): a NULL key is kept). No validity pointer means every
// key is valid. Every output byte of a mask is 0 or 1.
//
// The payload kernel does the operator's whole probe batch in its launch:
// the probe key's validity, the narrowing of each value to its build
// column's storage type and the inner join's new live mask, where the
// operator used to add 2-4 launches around the probe. Its tables are small
// on the main path (Q10's and Q9's nation joins: 64 slots, 256 bytes), so
// when present and values together hold at most 2048 slots (8 KB) every
// block copies them into shared memory first (the staged instances: a
// gather is then a shared-memory load, not an L1/L2 round trip; the copy
// overlaps the first group's key loads, which are issued before it);
// larger tables are read through __ldg after an L2 prefetch, as the exists
// table is. Its vector instances give a thread 4 rows whatever the key
// width (a first version gave it the exists probe's 16-byte group, 16
// int8 rows, and ran slower than the kernel it replaced: 2^20 rows were
// 16 warps an SM, too few to hide a round trip). A thread holds its 4
// slots and hit bits and walks the value columns one at a time: 4
// independent table reads, then the column's 4 values in one store of 4
// to 32 bytes. The width is the same for every thread of a launch, so its
// switch does not diverge.
//
// The q3 step keeps one thread per row in a grid-stride loop, its four
// columns read through load_int, table words through the read-only cache.
// It keeps an int64 count and revenue per thread, reduces them by warp
// shuffles and a shared-memory pass per block, and adds each block's two
// totals with one 64-bit atomic each (integers, so the order of the adds
// changes nothing). Every launcher sizes its grid from a cached count of
// resident blocks (common.cuh: grid_blocks), with no runtime query after a
// kernel's first launch. The TPU kernels' 128-lane table replication,
// [blocks, 128] reshapes, capacity-multiple rule, bitmask partitions and
// 8-bit revenue lanes have no counterpart: any capacity works and the
// ragged tail is masked.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // q3
constexpr int kRows = 4;       // rows a q3 thread covers per grid pass, for sizing
// exists, sketch and payload: blocks of 256 threads when the launch has a
// block's worth for every SM, else of 128, so a small launch still
// spreads over every SM
constexpr int kProbeThreads = 256;
constexpr int kSmallProbeThreads = 128;
constexpr int kMaxValues = 16;
// payload: the table slots (present + values, int32) a block stages in
// shared memory, 8 KB; larger tables are read through the read-only path
constexpr int kStagedSlots = 2048;
constexpr uint32_t kSketchSeed = 0x9E3779B9u;  // ops/hashing.py SKETCH_SEED

// the exists and sketch instances, in the launch entries' numbering
enum Instance : int { kVector = 0, kScalar = 1 };
// the payload instances (cuda_join.PAYLOAD_INSTANCES): a thread a group
// of rows or a row a thread, the tables staged in shared memory or not
enum PayloadInstance : int {
  kVectorStaged = 0,
  kVectorGlobal = 1,
  kScalarStaged = 2,
  kScalarGlobal = 3,
};

// Everything of a payload launch but the keys and the live mask.
struct PayloadArgs {
  const int32_t* present;
  const int32_t* table[kMaxValues];
  void* out[kMaxValues];
  int width[kMaxValues];  // bytes of out[j]'s elements: 1, 2, 4 or 8
  const uint8_t* valid;   // null: every key valid
  uint8_t* matched;
  uint8_t* live_out;      // null: no new live mask (the inner join's)
  long long kmin;
  long long kmax;
  long long domain;       // kmax - kmin + 1: the slots of each table a probe reads
  int nval;
};

// murmur3 finalizer (ops/hashing.py::mix32 on the unsigned bit pattern)
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t table_word(const int32_t* words, uint32_t s) {
  return static_cast<uint32_t>(__ldg(&words[s >> 5]));
}

__device__ __forceinline__ bool word_bit(const int32_t* __restrict__ words, uint32_t s) {
  return (table_word(words, s) >> (s & 31u)) & 1u;
}

// ---------------------------------------------------------------------------
// exists and sketch: what a row's key asks of the table. slots() gives
// the kWords table bits the key needs (bit s of the table is bit s & 31
// of word s >> 5) and whether the key can hit at all; every slot is a
// valid table bit, so the word loads need no guard.
// ---------------------------------------------------------------------------

struct ExistsProbe {
  static constexpr int kWords = 1;
  const int32_t* words;
  long long kmin;
  long long kmax;

  // 128-byte lines of the table the domain covers
  __device__ __forceinline__ int64_t lines() const { return ((kmax - kmin) >> 10) + 1; }

  __device__ __forceinline__ bool slots(int32_t key, uint32_t (&s)[1]) const {
    const long long k = key;
    const bool inr = k >= kmin && k <= kmax;  // in 64 bits, never through k - kmin
    s[0] = inr ? static_cast<uint32_t>(k - kmin) : 0u;
    return inr;
  }
};

struct SketchProbe {
  static constexpr int kWords = 2;
  const int32_t* words;
  uint32_t mask;  // nbits - 1

  __device__ __forceinline__ int64_t lines() const { return (static_cast<int64_t>(mask) >> 10) + 1; }

  __device__ __forceinline__ bool slots(int32_t key, uint32_t (&s)[2]) const {
    const uint32_t u = static_cast<uint32_t>(key);
    s[0] = fmix32(u) & mask;
    s[1] = fmix32(u ^ kSketchSeed) & mask;
    return true;
  }
};

// The new live bit of a row: keep (semi joins, the payload-free inner
// join, and the plain probe with no validity) or anti. A byte is true
// when it is not 0.
template <bool Anti>
__device__ __forceinline__ uint32_t keep_bit(uint32_t live, uint32_t valid, bool hit) {
  const bool l = live != 0;
  const bool v = valid != 0;
  return Anti ? (l && !(v && hit)) : (l && v && hit);
}

// one row, by plain loads (the ragged tail and the scalar instance)
template <bool Anti, typename K, class P>
__device__ __forceinline__ void probe_row(const P& p, const K* __restrict__ keys,
                                          const uint8_t* __restrict__ live,
                                          const uint8_t* __restrict__ valid, int64_t i,
                                          uint8_t* __restrict__ out) {
  const uint32_t l = live[i];
  const uint32_t v = valid == nullptr ? 1u : valid[i];
  uint32_t s[P::kWords];
  bool hit = p.slots(static_cast<int32_t>(keys[i]), s);  // int8/int16 sign-extend
  if (l && v) {  // a dead row or a NULL key reads no table word
#pragma unroll
    for (int j = 0; j < P::kWords; ++j) hit = hit & word_bit(p.words, s[j]);
  }
  out[i] = static_cast<uint8_t>(keep_bit<Anti>(l, v, hit));
}

// R bytes of R consecutive rows (live, validity or out) as R / 4 words,
// row r in byte r % 4 of word r / 4 (little-endian)
template <int R>
struct RowBytes {
  uint32_t w[R / 4];
};

template <int R>
__device__ __forceinline__ uint32_t byte_of(const RowBytes<R>& b, int r) {
  return (b.w[r >> 2] >> ((r & 3) * 8)) & 0xFFu;
}

// group g's R bytes, one load of R bytes (R-byte aligned)
template <int R>
__device__ __forceinline__ RowBytes<R> load_bytes(const uint8_t* p, int64_t g) {
  RowBytes<R> b;
  if constexpr (R == 4) {
    b.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p) + g);
  } else if constexpr (R == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + g);
    b.w[0] = v.x;
    b.w[1] = v.y;
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + g);
    b.w[0] = v.x;
    b.w[1] = v.y;
    b.w[2] = v.z;
    b.w[3] = v.w;
  }
  return b;
}

template <int R>
__device__ __forceinline__ void store_bytes(uint8_t* p, int64_t g, const RowBytes<R>& b) {
  if constexpr (R == 4) {
    reinterpret_cast<unsigned int*>(p)[g] = b.w[0];
  } else if constexpr (R == 8) {
    reinterpret_cast<uint2*>(p)[g] = make_uint2(b.w[0], b.w[1]);
  } else {
    reinterpret_cast<uint4*>(p)[g] = make_uint4(b.w[0], b.w[1], b.w[2], b.w[3]);
  }
}

// rows of keys of type K in one 16-byte group
template <typename K>
constexpr int kGroupRows = 16 / static_cast<int>(sizeof(K));

// the loads of one group: 16 bytes of keys, R live bytes, R validity
// bytes (every row valid without a validity pointer)
template <typename K, int R = kGroupRows<K>>
struct Group {
  uint4 keys;
  RowBytes<R> live;
  RowBytes<R> valid;
};

// key r of a group, widened to int32 (sign-extended)
template <typename K>
__device__ __forceinline__ int32_t key_of(const uint4& kv, int r) {
  const uint32_t w[4] = {kv.x, kv.y, kv.z, kv.w};
  if constexpr (sizeof(K) == 4) {
    return static_cast<int32_t>(w[r]);
  } else if constexpr (sizeof(K) == 2) {
    return static_cast<int16_t>(w[r >> 1] >> ((r & 1) * 16));
  } else {
    return static_cast<int8_t>(w[r >> 2] >> ((r & 3) * 8));
  }
}

template <typename K, int R = kGroupRows<K>>
__device__ __forceinline__ Group<K> load_group(const K* keys, const uint8_t* live,
                                               const uint8_t* valid, int64_t g) {
  Group<K> x;
  x.keys = __ldg(reinterpret_cast<const uint4*>(keys) + g);
  x.live = load_bytes<R>(live, g);
  if (valid != nullptr) {
    x.valid = load_bytes<R>(valid, g);
  } else {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) x.valid.w[i] = 0x01010101u;
  }
  return x;
}

// Probe a loaded group: every table word of its R rows is loaded before
// any is tested, then one R-byte store.
template <bool Anti, typename K, class P, int R = kGroupRows<K>>
__device__ __forceinline__ void probe_group(const P& p, const Group<K>& x,
                                            uint8_t* __restrict__ out, int64_t g) {
  constexpr int W = P::kWords;
  uint32_t s[R][W];
  bool inr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    inr[r] = p.slots(key_of<K>(x.keys, r), s[r]);
    // a dead row or a NULL key needs no table word: it reads word 0,
    // which the whole warp shares, so only live keys gather
    if (!(byte_of(x.live, r) && byte_of(x.valid, r))) {
#pragma unroll
      for (int j = 0; j < W; ++j) s[r][j] = 0;
    }
  }
  uint32_t w[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < W; ++j) w[r][j] = table_word(p.words, s[r][j]);
  }
  RowBytes<R> o;
#pragma unroll
  for (int i = 0; i < R / 4; ++i) o.w[i] = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bool hit = inr[r];
#pragma unroll
    for (int j = 0; j < W; ++j) hit = hit & ((w[r][j] >> (s[r][j] & 31u)) & 1u);
    o.w[r >> 2] |= keep_bit<Anti>(byte_of(x.live, r), byte_of(x.valid, r), hit)
                   << ((r & 3) * 8);
  }
  store_bytes<R>(out, g, o);
}

// The vector instance: thread t owns groups t, t + stride, ...; the next
// group's loads are issued before the current group's table reads. The
// n mod R rows past the last whole group go a row a thread.
template <bool Anti, typename K, class P>
__device__ __forceinline__ void probe_groups(const P& p, const K* __restrict__ keys,
                                             const uint8_t* __restrict__ live,
                                             const uint8_t* __restrict__ valid, int64_t n,
                                             uint8_t* __restrict__ out) {
  constexpr int R = kGroupRows<K>;
  const int64_t groups = n / R;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // ask L2 for the table's lines while the keys are on their way, so the
  // first table reads of a cold launch do not wait on device memory
  for (int64_t line = t; line < p.lines(); line += step)
    asm volatile("prefetch.L2 [%0];" ::"l"(p.words + 32 * line));
  if (t < groups) {
    Group<K> cur = load_group(keys, live, valid, t);
    for (int64_t g = t;;) {
      const int64_t next = g + step;
      const bool more = next < groups;
      Group<K> ahead = cur;
      if (more) ahead = load_group(keys, live, valid, next);
      probe_group<Anti, K>(p, cur, out, g);
      if (!more) break;
      cur = ahead;
      g = next;
    }
  }
  if (t < n - groups * R) probe_row<Anti>(p, keys, live, valid, groups * R + t, out);
}

// The scalar instance: a row a thread, grid-stride (views that do not
// start aligned to their group).
template <bool Anti, typename K, class P>
__device__ __forceinline__ void probe_rows(const P& p, const K* __restrict__ keys,
                                           const uint8_t* __restrict__ live,
                                           const uint8_t* __restrict__ valid, int64_t n,
                                           uint8_t* __restrict__ out) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step)
    probe_row<Anti>(p, keys, live, valid, i, out);
}

template <typename K, bool Anti, bool Vector>
__global__ void __launch_bounds__(kProbeThreads)
exists_kernel(ExistsProbe p, const K* __restrict__ keys, const uint8_t* __restrict__ live,
              const uint8_t* __restrict__ valid, int64_t n, uint8_t* __restrict__ out) {
  if constexpr (Vector) {
    probe_groups<Anti>(p, keys, live, valid, n, out);
  } else {
    probe_rows<Anti>(p, keys, live, valid, n, out);
  }
}

template <typename K, bool Vector>
__global__ void __launch_bounds__(kProbeThreads)
sketch_kernel(SketchProbe p, const K* __restrict__ keys, const uint8_t* __restrict__ live,
              const uint8_t* __restrict__ valid, int64_t n, uint8_t* __restrict__ out) {
  if constexpr (Vector) {
    probe_groups<false>(p, keys, live, valid, n, out);
  } else {
    probe_rows<false>(p, keys, live, valid, n, out);
  }
}

// ---------------------------------------------------------------------------
// payload: the present test and the value gathers of a group of rows,
// the values narrowed to their columns' storage widths.
// ---------------------------------------------------------------------------

// slot s of the table at `g` (global) or at `sm` (its staged copy)
template <bool Staged>
__device__ __forceinline__ int32_t slot_value(const int32_t* g, const int32_t* sm, uint32_t s) {
  if constexpr (Staged) {
    return sm[s];
  } else {
    return __ldg(g + s);
  }
}

// NW consecutive words at word offset g * NW of `p` in one store (NW 1,
// 2) or NW / 4 16-byte stores; `p` aligned to min(16, 4 * NW) bytes
template <int NW>
__device__ __forceinline__ void store_words(void* p, int64_t g, const uint32_t (&w)[NW]) {
  if constexpr (NW == 1) {
    reinterpret_cast<unsigned int*>(p)[g] = w[0];
  } else if constexpr (NW == 2) {
    reinterpret_cast<uint2*>(p)[g] = make_uint2(w[0], w[1]);
  } else {
    static_assert(NW % 4 == 0, "whole 16-byte stores");
    uint4* q = reinterpret_cast<uint4*>(p) + g * (NW / 4);
#pragma unroll
    for (int i = 0; i < NW / 4; ++i)
      q[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
}

// R int32 values of group g into an output of W-byte elements: truncated
// to W < 4 bytes, sign-extended to W = 8 (the casts of .to(dtype))
template <int R, int W>
__device__ __forceinline__ void store_narrowed(void* out, int64_t g, const int32_t (&v)[R]) {
  constexpr int NW = R * W / 4;
  uint32_t q[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) q[i] = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t u = static_cast<uint32_t>(v[r]);
    if constexpr (W == 8) {
      q[2 * r] = u;
      q[2 * r + 1] = static_cast<uint32_t>(v[r] >> 31);
    } else if constexpr (W == 4) {
      q[r] = u;
    } else {
      q[r * W / 4] |= (u & ((1u << (8 * W)) - 1u)) << ((r * W) % 4 * 8);
    }
  }
  store_words<NW>(out, g, q);
}

template <int R>
__device__ __forceinline__ void store_group_values(void* out, int width, int64_t g,
                                                   const int32_t (&v)[R]) {
  switch (width) {  // the same for every thread
    case 1: store_narrowed<R, 1>(out, g, v); break;
    case 2: store_narrowed<R, 2>(out, g, v); break;
    case 4: store_narrowed<R, 4>(out, g, v); break;
    default: store_narrowed<R, 8>(out, g, v); break;
  }
}

__device__ __forceinline__ void store_value(void* out, int width, int64_t i, int32_t v) {
  switch (width) {
    case 1: static_cast<int8_t*>(out)[i] = static_cast<int8_t>(v); break;
    case 2: static_cast<int16_t*>(out)[i] = static_cast<int16_t>(v); break;
    case 4: static_cast<int32_t*>(out)[i] = v; break;
    default: static_cast<long long*>(out)[i] = v; break;
  }
}

// the slot a key reads and whether it can hit: live, valid and in the
// domain (compared in 64 bits, never through key - kmin); any other row
// reads slot 0, which the warp shares
__device__ __forceinline__ bool payload_slot(const PayloadArgs& a, int32_t key, uint32_t live,
                                             uint32_t valid, uint32_t* s) {
  const long long k = key;
  const bool inr = live != 0 && valid != 0 && k >= a.kmin && k <= a.kmax;
  *s = inr ? static_cast<uint32_t>(k - a.kmin) : 0u;
  return inr;
}

// one row, by plain loads (the ragged tail and the scalar instances)
template <bool Staged, typename K>
__device__ __forceinline__ void payload_row(const PayloadArgs& a, const int32_t* stage,
                                            const K* __restrict__ keys,
                                            const uint8_t* __restrict__ live, int64_t i) {
  uint32_t s;
  const bool inr = payload_slot(a, static_cast<int32_t>(keys[i]), live[i],
                                a.valid == nullptr ? 1u : a.valid[i], &s);
  const bool hit = inr && slot_value<Staged>(a.present, stage, s) != 0;
  a.matched[i] = hit;
  if (a.live_out != nullptr) a.live_out[i] = hit;
  for (int j = 0; j < a.nval; ++j) {
    const int32_t v = slot_value<Staged>(a.table[j], stage + (1 + j) * a.domain, s);
    store_value(a.out[j], a.width[j], i, hit ? v : 0);
  }
}

// The payload kernel's vector instances: a thread owns 4 consecutive rows
// whatever the key width (16 int8 rows a thread would leave 2^20 rows to
// 16 warps an SM, too few to hide a load's latency): one 4-, 8- or
// 16-byte load of keys and 4-byte loads of live and validity bytes.
constexpr int kPayloadRows = 4;

struct PayloadGroup {
  int32_t key[kPayloadRows];
  RowBytes<kPayloadRows> live;
  RowBytes<kPayloadRows> valid;
};

template <typename K>
__device__ __forceinline__ PayloadGroup load_payload_group(const K* keys, const uint8_t* live,
                                                           const uint8_t* valid, int64_t g) {
  PayloadGroup x;
  if constexpr (sizeof(K) == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(keys) + g);
    x.key[0] = static_cast<int32_t>(v.x);
    x.key[1] = static_cast<int32_t>(v.y);
    x.key[2] = static_cast<int32_t>(v.z);
    x.key[3] = static_cast<int32_t>(v.w);
  } else if constexpr (sizeof(K) == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(keys) + g);
    x.key[0] = static_cast<int16_t>(v.x & 0xFFFFu);
    x.key[1] = static_cast<int16_t>(v.x >> 16);
    x.key[2] = static_cast<int16_t>(v.y & 0xFFFFu);
    x.key[3] = static_cast<int16_t>(v.y >> 16);
  } else {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(keys) + g);
#pragma unroll
    for (int r = 0; r < kPayloadRows; ++r) x.key[r] = static_cast<int8_t>(v >> (8 * r));
  }
  x.live = load_bytes<kPayloadRows>(live, g);
  x.valid.w[0] = valid == nullptr ? 0x01010101u : load_bytes<kPayloadRows>(valid, g).w[0];
  return x;
}

// A loaded group: its 4 present words are read before any is tested,
// then the mask bytes are stored (one 4-byte store each); then, a value
// column at a time with the group's slots held, its 4 words are read
// before any is used and stored in the column's width (4 to 32 bytes).
template <bool Staged>
__device__ __forceinline__ void payload_group(const PayloadArgs& a, const int32_t* stage,
                                              const PayloadGroup& x, int64_t g) {
  constexpr int R = kPayloadRows;
  uint32_t s[R];
  bool inr[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    inr[r] = payload_slot(a, x.key[r], byte_of(x.live, r), byte_of(x.valid, r), &s[r]);
  int32_t p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) p[r] = slot_value<Staged>(a.present, stage, s[r]);
  uint32_t hits = 0;
  RowBytes<R> m;
  m.w[0] = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t h = inr[r] && p[r] != 0;
    hits |= h << r;
    m.w[0] |= h << (r * 8);
  }
  store_bytes<R>(a.matched, g, m);
  if (a.live_out != nullptr) store_bytes<R>(a.live_out, g, m);
  for (int j = 0; j < a.nval; ++j) {
    const int32_t* sm = stage + (1 + j) * a.domain;
    int32_t v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = slot_value<Staged>(a.table[j], sm, s[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = (hits >> r) & 1u ? v[r] : 0;
    store_group_values<R>(a.out[j], a.width[j], g, v);
  }
}

// Copy the present and value tables' first `domain` slots into `stage`
// (present first, then each value table), or ask L2 for their lines.
template <bool Staged>
__device__ __forceinline__ void payload_tables(const PayloadArgs& a, int32_t* stage, int64_t t,
                                               int64_t step) {
  if constexpr (Staged) {
    // one flat pass over every table's slots, so a block's threads load
    // them all at once (a pass per table would wait out a round trip each)
    const int d = static_cast<int>(a.domain);
    const int total = (1 + a.nval) * d;
    for (int f = threadIdx.x; f < total; f += blockDim.x) {
      const int j = f / d - 1;
      stage[f] = __ldg((j < 0 ? a.present : a.table[j]) + (f - (j + 1) * d));
    }
    __syncthreads();
  } else {
    const int64_t lines = (a.domain + 31) / 32;
    for (int j = -1; j < a.nval; ++j) {
      const int32_t* src = j < 0 ? a.present : a.table[j];
      for (int64_t line = t; line < lines; line += step)
        asm volatile("prefetch.L2 [%0];" ::"l"(src + 32 * line));
    }
  }
}

// The payload kernel. The vector instances: thread t owns groups t, t +
// stride, ...; its first group's key, live and validity loads are issued
// before the tables are staged, and each next group's before the current
// group's table reads; the n mod R rows past the last whole group go a
// row a thread. The scalar instances: a row a thread, grid-stride.
template <typename K, bool Vector, bool Staged>
__global__ void __launch_bounds__(kProbeThreads)
payload_kernel(PayloadArgs a, const K* __restrict__ keys, const uint8_t* __restrict__ live,
               int64_t n) {
  __shared__ int32_t stage[Staged ? kStagedSlots : 1];
  constexpr int R = kPayloadRows;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if constexpr (Vector) {
    const int64_t groups = n / R;
    PayloadGroup cur;
    if (t < groups) cur = load_payload_group(keys, live, a.valid, t);
    payload_tables<Staged>(a, stage, t, step);  // every thread reaches the barrier
    if (t < groups) {
      for (int64_t g = t;;) {
        const int64_t next = g + step;
        const bool more = next < groups;
        PayloadGroup ahead = cur;
        if (more) ahead = load_payload_group(keys, live, a.valid, next);
        payload_group<Staged>(a, stage, cur, g);
        if (!more) break;
        cur = ahead;
        g = next;
      }
    }
    if (t < n - groups * R) payload_row<Staged>(a, stage, keys, live, groups * R + t);
  } else {
    payload_tables<Staged>(a, stage, t, step);
    for (int64_t i = t; i < n; i += step) payload_row<Staged>(a, stage, keys, live, i);
  }
}

__global__ void __launch_bounds__(kThreads)
q3_kernel(const void* __restrict__ keys, int ksz, const void* __restrict__ ship, int ssz,
          const void* __restrict__ ep, int esz, const void* __restrict__ disc, int dsz,
          const bool* __restrict__ live, int64_t n, const int32_t* __restrict__ words,
          int64_t nwords, long long kmin, long long cutoff,
          unsigned long long* __restrict__ out) {
  long long count = 0;
  long long revenue = 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long slot = static_cast<long long>(presto::load_int(keys, ksz, i)) - kmin;
    const bool in = live[i] && presto::load_int(ship, ssz, i) > cutoff && slot >= 0 &&
                    (slot >> 5) < nwords;
    if (in && word_bit(words, static_cast<uint32_t>(slot))) {
      count += 1;
      revenue += static_cast<long long>(presto::load_int(ep, esz, i)) *
                 (100 - static_cast<long long>(presto::load_int(disc, dsz, i)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
    revenue += __shfl_down_sync(0xffffffffu, revenue, off);
  }
  __shared__ long long partial[2][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    partial[0][warp] = count;
    partial[1][warp] = revenue;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    count = lane < warps ? partial[0][lane] : 0;
    revenue = lane < warps ? partial[1][lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_down_sync(0xffffffffu, count, off);
      revenue += __shfl_down_sync(0xffffffffu, revenue, off);
    }
    if (lane == 0) {
      // two's complement: unsigned adds give the signed int64 sums
      if (count != 0) atomicAdd(&out[0], static_cast<unsigned long long>(count));
      if (revenue != 0) atomicAdd(&out[1], static_cast<unsigned long long>(revenue));
    }
  }
}

// Whether a vector launch's pointers start aligned to their group: keys
// 16 bytes, live, validity and out R bytes.
bool group_aligned(const void* keys, int key_size, const void* live, const void* valid,
                   const void* out) {
  const uintptr_t r = static_cast<uintptr_t>(16 / key_size);
  const auto at = [](const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  return at(keys, 16) && at(live, r) && (valid == nullptr || at(valid, r)) && at(out, r);
}

// Launch one exists or sketch instance: the vector one covers ceil(n / R)
// threads (at least the n mod R tail rows), the scalar one n.
template <typename K, typename Kernel, class P>
cudaError_t launch_probe(Kernel kernel, bool vector, const P& p, const void* keys,
                         const void* live, const void* valid, int64_t n, void* out,
                         cudaStream_t stream) {
  constexpr int64_t R = kGroupRows<K>;
  const int64_t work = vector ? (n / R > n % R ? n / R : n % R) : n;
  const int threads =
      work >= static_cast<int64_t>(presto::sm_count()) * kProbeThreads ? kProbeThreads
                                                                         : kSmallProbeThreads;
  const int blocks = presto::grid_blocks(kernel, work, threads, 0, 1);
  kernel<<<blocks, threads, 0, stream>>>(
      p, static_cast<const K*>(keys), static_cast<const uint8_t*>(live),
      static_cast<const uint8_t*>(valid), n, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_exists(const ExistsProbe& p, bool anti, bool vector, const void* keys,
                          const void* live, const void* valid, int64_t n, void* out,
                          cudaStream_t s) {
  const auto go = [&](auto kernel) {
    return launch_probe<K>(kernel, vector, p, keys, live, valid, n, out, s);
  };
  if (anti) return vector ? go(exists_kernel<K, true, true>) : go(exists_kernel<K, true, false>);
  return vector ? go(exists_kernel<K, false, true>) : go(exists_kernel<K, false, false>);
}

template <typename K>
cudaError_t launch_sketch(const SketchProbe& p, bool vector, const void* keys,
                          const void* live, const void* valid, int64_t n, void* out,
                          cudaStream_t s) {
  const auto go = [&](auto kernel) {
    return launch_probe<K>(kernel, vector, p, keys, live, valid, n, out, s);
  };
  return vector ? go(sketch_kernel<K, true>) : go(sketch_kernel<K, false>);
}

// The checks the exists and sketch entries share: a key width of 1, 2 or
// 4 bytes, a known instance, and a vector launch's pointers aligned to
// their group. cudaSuccess when the launch may go ahead.
cudaError_t probe_args_ok(int key_size, int instance, const void* keys, const void* live,
                          const void* valid, const void* out) {
  if (key_size != 1 && key_size != 2 && key_size != 4) return cudaErrorInvalidValue;
  if (instance != kVector && instance != kScalar) return cudaErrorInvalidValue;
  if (instance == kVector && !group_aligned(keys, key_size, live, valid, out))
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

// Launch one payload instance: the vector ones cover ceil(n / R) threads
// (at least the n mod R tail rows), the scalar ones n.
template <typename K>
cudaError_t launch_payload(const PayloadArgs& a, int instance, const void* keys,
                           const void* live, int64_t n, cudaStream_t stream) {
  constexpr int64_t R = kPayloadRows;
  const bool vector = instance == kVectorStaged || instance == kVectorGlobal;
  const int64_t work = vector ? (n / R > n % R ? n / R : n % R) : n;
  const int threads =
      work >= static_cast<int64_t>(presto::sm_count()) * kProbeThreads ? kProbeThreads
                                                                         : kSmallProbeThreads;
  const auto go = [&](auto kernel) {
    const int blocks = presto::grid_blocks(kernel, work, threads, 0, 1);
    kernel<<<blocks, threads, 0, stream>>>(a, static_cast<const K*>(keys),
                                           static_cast<const uint8_t*>(live), n);
    return cudaGetLastError();
  };
  switch (instance) {
    case kVectorStaged: return go(payload_kernel<K, true, true>);
    case kVectorGlobal: return go(payload_kernel<K, true, false>);
    case kScalarStaged: return go(payload_kernel<K, false, true>);
    default: return go(payload_kernel<K, false, false>);
  }
}

}  // namespace

// Launch the exists probe on `stream`: out = live && valid && hit, or
// with `anti` live && !(valid && hit) (hit: kmin <= key <= kmax and the
// key's bit set), one bool a row. `key_size` is the key width in bytes
// (1, 2 or 4); `valid` may be null (every key valid); `words` covers the
// domain (>= (kmax-kmin)/32 + 1 words, checked in Python). `instance`: 0
// the vector instance (keys 16-byte aligned, live, valid and out aligned
// to 16 / key_size bytes), 1 the scalar one (any alignment). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for an
// unsupported key width or instance, cudaErrorMisalignedAddress for a
// vector launch on unaligned pointers.
extern "C" int exists_probe_launch(const void* keys, int key_size, const void* live,
                                   const void* valid, long long n, const void* words,
                                   long long kmin, long long kmax, int anti, int instance,
                                   void* out, void* stream) {
  const cudaError_t ok = probe_args_ok(key_size, instance, keys, live, valid, out);
  if (ok != cudaSuccess) return static_cast<int>(ok);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ExistsProbe p{static_cast<const int32_t*>(words), kmin, kmax};
  const bool vector = instance == kVector;
  switch (key_size) {
    case 1: return static_cast<int>(launch_exists<int8_t>(p, anti != 0, vector, keys, live, valid, n, out, s));
    case 2: return static_cast<int>(launch_exists<int16_t>(p, anti != 0, vector, keys, live, valid, n, out, s));
    default: return static_cast<int>(launch_exists<int32_t>(p, anti != 0, vector, keys, live, valid, n, out, s));
  }
}

// Launch the payload probe on `stream`: hit = live && valid && kmin <=
// key <= kmax && present[key - kmin]; matched (and live_out, when not
// null: the inner join's new live mask) = hit, one bool a row; outs[j] =
// hit ? tables[j][key - kmin] : 0 in elements of widths[j] bytes (1, 2 or
// 4: truncated, 8: sign-extended). `present` and the nval <= 16 value
// tables each cover the domain (checked in Python); `valid` may be null
// (every key valid). `instance` (cuda_join.PAYLOAD_INSTANCES): 0 vector
// staged, 1 vector, 2 scalar staged, 3 scalar. A vector instance needs
// the keys aligned to 4 * key_size bytes, live, valid, matched and
// live_out to 4 bytes and each out to min(16, 4 * width); a staged one
// (1 + nval) * (kmax - kmin + 1) <= 2048 slots. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for
// arguments the kernel does not take, cudaErrorMisalignedAddress for a
// vector launch on unaligned pointers.
extern "C" int payload_probe_launch(const void* keys, int key_size, const void* live,
                                    const void* valid, long long n, const void* present,
                                    const void* const* tables, void* const* outs,
                                    const int* widths, int nval, long long kmin,
                                    long long kmax, int instance, void* matched,
                                    void* live_out, void* stream) {
  if ((key_size != 1 && key_size != 2 && key_size != 4) || nval < 0 || nval > kMaxValues ||
      kmin > kmax || instance < kVectorStaged || instance > kScalarGlobal)
    return static_cast<int>(cudaErrorInvalidValue);
  PayloadArgs a = {};
  a.present = static_cast<const int32_t*>(present);
  a.valid = static_cast<const uint8_t*>(valid);
  a.matched = static_cast<uint8_t*>(matched);
  a.live_out = static_cast<uint8_t*>(live_out);
  a.kmin = kmin;
  a.kmax = kmax;
  a.nval = nval;
  a.domain = kmax - kmin + 1;
  const uintptr_t r = kPayloadRows;
  const auto at = [](const void* p, uintptr_t align) {
    return reinterpret_cast<uintptr_t>(p) % align == 0;
  };
  bool aligned = at(keys, r * key_size) && at(live, r) && (valid == nullptr || at(valid, r)) &&
                 at(matched, r) && (live_out == nullptr || at(live_out, r));
  for (int j = 0; j < nval; ++j) {
    const int w = widths[j];
    if (w != 1 && w != 2 && w != 4 && w != 8) return static_cast<int>(cudaErrorInvalidValue);
    a.table[j] = static_cast<const int32_t*>(tables[j]);
    a.out[j] = outs[j];
    a.width[j] = w;
    aligned = aligned && at(outs[j], r * w < 16 ? r * w : 16);
  }
  const bool staged = instance == kVectorStaged || instance == kScalarStaged;
  if (staged && static_cast<long long>(1 + nval) * a.domain > kStagedSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((instance == kVectorStaged || instance == kVectorGlobal) && !aligned)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_size) {
    case 1: return static_cast<int>(launch_payload<int8_t>(a, instance, keys, live, n, s));
    case 2: return static_cast<int>(launch_payload<int16_t>(a, instance, keys, live, n, s));
    default: return static_cast<int>(launch_payload<int32_t>(a, instance, keys, live, n, s));
  }
}

// Launch the sketch probe on `stream`: out = live && valid && bit s1 &&
// bit s2, one bool a row. `words` holds nbits / 32 int32 words of the
// two-hash Bloom bitmask; nbits is a power of two (checked in Python);
// `valid` may be null; `instance` as for exists_probe_launch. Returns
// cudaGetLastError() after the launch, or an error code as
// exists_probe_launch does.
extern "C" int sketch_probe_launch(const void* keys, int key_size, const void* live,
                                   const void* valid, long long n, const void* words,
                                   long long nbits, int instance, void* out, void* stream) {
  const cudaError_t ok = probe_args_ok(key_size, instance, keys, live, valid, out);
  if (ok != cudaSuccess) return static_cast<int>(ok);
  if (nbits <= 0 || (nbits & (nbits - 1)) != 0 || nbits > (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SketchProbe p{static_cast<const int32_t*>(words), static_cast<uint32_t>(nbits - 1)};
  const bool vector = instance == kVector;
  switch (key_size) {
    case 1: return static_cast<int>(launch_sketch<int8_t>(p, vector, keys, live, valid, n, out, s));
    case 2: return static_cast<int>(launch_sketch<int16_t>(p, vector, keys, live, valid, n, out, s));
    default: return static_cast<int>(launch_sketch<int32_t>(p, vector, keys, live, valid, n, out, s));
  }
}

// Launch the Q3 join step on `stream`: four integer columns of 1, 2 or 4
// bytes each (key, shipdate, extendedprice, discount), the live mask,
// the nwords-word bitmask over keys from kmin; `out` is int64[2], zeroed
// by the caller, and receives (count, revenue).
extern "C" int q3_probe_launch(const void* keys, int ksz, const void* ship, int ssz,
                               const void* ep, int esz, const void* disc, int dsz,
                               const void* live, long long n, const void* words,
                               long long nwords, long long kmin, long long cutoff, void* out,
                               void* stream) {
  const auto width_ok = [](int sz) { return sz == 1 || sz == 2 || sz == 4; };
  if (!width_ok(ksz) || !width_ok(ssz) || !width_ok(esz) || !width_ok(dsz))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = presto::grid_blocks(q3_kernel, n, kThreads, 0, kRows);
  q3_kernel<<<blocks, kThreads, 0, s>>>(
      keys, ksz, ship, ssz, ep, esz, disc, dsz, static_cast<const bool*>(live), n,
      static_cast<const int32_t*>(words), nwords, kmin, cutoff,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* join_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
