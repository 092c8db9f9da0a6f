// Fused equi-join probes against small flat lookup tables.
//
// Replaces presto_tpu/ops/pallas_join.py::exists_probe (Pallas body
// `_exists_kernel`), ::payload_probe (`_payload_kernel`), ::sketch_probe
// (`_sketch_kernel`) and ::q3_probe_step (`_q3_kernel`):
// - exists:  hit = kmin <= key <= kmax && bit (key - kmin) of the int32
//            word table is set; out = live && valid && hit (keep), or
//            live && !(valid && hit) (anti), bool.
// - payload: hit = live && kmin <= key <= kmax && present[key - kmin];
//            matched = hit, and each of the nval int32 value tables gives
//            out_j = hit ? table_j[key - kmin] : 0.
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
// 4 bytes as the connector narrowed it) and its live byte and writes one
// bool (payload: plus 4 bytes per value column; the exists and sketch
// probes: plus the validity byte when the key has one); at 3.35 TB/s a
// 2^20-row exists probe of int32 keys moves 6 MB, about 2 us. The exists,
// payload and sketch tables are at most 64 KB (16384 words), so after the
// first touches they live in L1/L2 and their reads cost no device-memory
// bytes. The q3 step reads 12 bytes a row (key 4, shipdate 2, ep 4, disc
// 1, live 1) and its bitmask (750 KB at SF1) stays in L2: lineitem
// arrives order by order, so neighbouring rows hit the same words.
//
// The exists and sketch probes are latency-bound at the main path's
// sizes (131,072 to 2^20 rows): a row's table read waits on its key. So
// each thread of their vector instance owns a group of R = 16 / key
// bytes consecutive rows (4 int32, 8 int16 or 16 int8 keys) and issues
// every load of the group before it uses one: one 16-byte load of keys,
// one R-byte load of live bytes (and of validity bytes), then all the
// group's table words (R for exists, 2R for sketch) through the
// read-only path, independent of each other, then one R-byte store. A
// thread pays two round trips, not two a row. A dead row or a NULL key
// reads word 0, which its warp shares, so only live keys gather. The
// grid covers ceil(n / R) threads, in blocks of 256 when that gives
// every SM a block and of 128 otherwise, so 2^20 int32 rows are one wave
// and 131,072 rows spread over every SM; past one wave a thread takes
// further groups and issues the next group's key and live loads before
// the current group's table reads. The tables stay in L2 through __ldg
// (staging 64 KB in every block would move more bytes than the probe
// reads); the threads first ask L2 for the table's lines, so a cold
// launch's table reads do not wait on device memory. The ragged tail (n
// mod R rows) is done a row a thread in the same launch. A view that
// does not start aligned to its group (keys 16 bytes, live, validity
// and out R bytes) takes the scalar instance, a row a thread. Both take
// an output mode at compile time: keep (out = live && valid && hit: the
// semi join's and the payload-free inner join's new live mask, and the
// plain probe with no validity) or anti (out = live && !(valid && hit):
// a NULL key is kept). No validity pointer means every key is valid.
// Every output byte is 0 or 1.
//
// The payload probe and the q3 step keep one thread per row in a
// grid-stride loop, keys read in their stored width (a template per
// width, chosen once per launch; the q3 step reads its four columns
// through load_int), table words through the read-only cache. The q3
// step keeps an int64 count and revenue per thread, reduces them by warp
// shuffles and a shared-memory pass per block, and adds each block's two
// totals with one 64-bit atomic each (integers, so the order of the adds
// changes nothing). Every launcher sizes its grid from a cached count of
// resident blocks (common.cuh: grid_blocks), with no runtime query
// after a kernel's first launch. The TPU kernels' 128-lane table
// replication, [blocks, 128] reshapes, capacity-multiple rule, bitmask
// partitions and 8-bit revenue lanes have no counterpart: any capacity
// works and the ragged tail is masked.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // payload and q3
constexpr int kRows = 4;       // rows a payload or q3 thread covers per grid pass, for sizing
// exists and sketch: blocks of 256 threads when the launch has a block's
// worth for every SM, else of 128, so a small launch still spreads over
// every SM
constexpr int kProbeThreads = 256;
constexpr int kSmallProbeThreads = 128;
constexpr int kMaxValues = 16;
constexpr uint32_t kSketchSeed = 0x9E3779B9u;  // ops/hashing.py SKETCH_SEED

// the exists and sketch instances, in the launch entries' numbering
enum Instance : int { kVector = 0, kScalar = 1 };

struct PayloadArgs {
  const int32_t* table[kMaxValues];
  int32_t* out[kMaxValues];
};

template <typename K>
__device__ __forceinline__ bool in_domain(const K* keys, const bool* live, int64_t i,
                                          long long kmin, long long kmax, int32_t* slot) {
  const long long k = static_cast<long long>(keys[i]);
  const bool inr = live[i] && k >= kmin && k <= kmax;
  *slot = inr ? static_cast<int32_t>(k - kmin) : 0;
  return inr;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
payload_kernel(const K* __restrict__ keys, const bool* __restrict__ live, int64_t n,
               const int32_t* __restrict__ present, PayloadArgs a, int nval,
               long long kmin, long long kmax, bool* __restrict__ matched) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    int32_t slot;
    const bool inr = in_domain(keys, live, i, kmin, kmax, &slot);
    const bool hit = inr && __ldg(&present[slot]) != 0;
    matched[i] = hit;
    for (int j = 0; j < nval; ++j) a.out[j][i] = hit ? __ldg(&a.table[j][slot]) : 0;
  }
}

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

template <typename K>
cudaError_t launch_payload(const void* keys, const void* live, int64_t n,
                           const void* present, const PayloadArgs& a, int nval,
                           long long kmin, long long kmax, void* matched,
                           cudaStream_t stream) {
  const int blocks = presto::grid_blocks(payload_kernel<K>, n, kThreads, 0, kRows);
  payload_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const K*>(keys), static_cast<const bool*>(live), n,
      static_cast<const int32_t*>(present), a, nval, kmin, kmax,
      static_cast<bool*>(matched));
  return cudaGetLastError();
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

// Launch the payload probe on `stream`: `present` and the `nval` value
// tables (nval <= 16) each cover the domain; `outs` are int32[n] outputs.
extern "C" int payload_probe_launch(const void* keys, int key_size, const void* live,
                                    long long n, const void* present,
                                    const void* const* tables, void* const* outs, int nval,
                                    long long kmin, long long kmax, void* matched,
                                    void* stream) {
  if (nval < 0 || nval > kMaxValues) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  PayloadArgs a = {};
  for (int j = 0; j < nval; ++j) {
    a.table[j] = static_cast<const int32_t*>(tables[j]);
    a.out[j] = static_cast<int32_t*>(outs[j]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_size) {
    case 1: return static_cast<int>(launch_payload<int8_t>(keys, live, n, present, a, nval, kmin, kmax, matched, s));
    case 2: return static_cast<int>(launch_payload<int16_t>(keys, live, n, present, a, nval, kmin, kmax, matched, s));
    case 4: return static_cast<int>(launch_payload<int32_t>(keys, live, n, present, a, nval, kmin, kmax, matched, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
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
