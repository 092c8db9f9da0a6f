// Fused equi-join probes against small flat lookup tables.
//
// Replaces presto_tpu/ops/pallas_join.py::exists_probe (Pallas body
// `_exists_kernel`), ::payload_probe (`_payload_kernel`), ::sketch_probe
// (`_sketch_kernel`) and ::q3_probe_step (`_q3_kernel`):
// - exists:  hit = live && kmin <= key <= kmax && bit (key - kmin) of the
//            int32 word table is set; out = hit (bool).
// - payload: hit = live && kmin <= key <= kmax && present[key - kmin];
//            matched = hit, and each of the nval int32 value tables gives
//            out_j = hit ? table_j[key - kmin] : 0.
// - sketch:  (s1, s2) = the two Bloom slots of int32(key) (the murmur3
//            finalizer of the key and of key ^ kSketchSeed, masked to
//            nbits, as ops/hashing.py::mix32_slots); out = live && bit s1
//            && bit s2 of the word table. Approximate by construction.
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
// bool (payload: plus 4 bytes per value column); at 3.35 TB/s a 2^20-row
// exists probe of int32 keys moves 6 MB, about 2 us. The exists, payload
// and sketch tables are at most 64 KB (16384 words), so after the first
// touches they live in L1/L2 and their reads cost no device-memory bytes.
// The q3 step reads 12 bytes a row (key 4, shipdate 2, ep 4, disc 1, live
// 1) and its bitmask (750 KB at SF1) stays in L2: lineitem arrives order
// by order, so neighbouring rows hit the same words.
//
// Design against that bound: one thread per row in a grid-stride loop,
// keys read in their stored width (a template per width, chosen once per
// launch; the q3 step reads its four columns through load_int), table
// words through the read-only cache. Nothing is staged in shared memory
// and no loads are vectorised yet: at these sizes the launch latency
// dominates. The q3 step keeps an int64 count and revenue per thread,
// reduces them by warp shuffles and a shared-memory pass per block, and
// adds each block's two totals with one 64-bit atomic each (integers, so
// the order of the adds changes nothing). The TPU kernels' 128-lane table
// replication, [blocks, 128] reshapes, capacity-multiple rule, bitmask
// partitions and 8-bit revenue lanes have no counterpart: any capacity
// works and the ragged tail is masked by the loop bound.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread covers per grid pass, for sizing
constexpr int kMaxValues = 16;
constexpr uint32_t kSketchSeed = 0x9E3779B9u;  // ops/hashing.py SKETCH_SEED

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
exists_kernel(const K* __restrict__ keys, const bool* __restrict__ live, int64_t n,
              const int32_t* __restrict__ words, long long kmin, long long kmax,
              bool* __restrict__ out) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    int32_t slot;
    const bool inr = in_domain(keys, live, i, kmin, kmax, &slot);
    const uint32_t w = static_cast<uint32_t>(__ldg(&words[slot >> 5]));
    out[i] = inr && ((w >> (slot & 31)) & 1u);
  }
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

__device__ __forceinline__ bool word_bit(const int32_t* __restrict__ words, uint32_t s) {
  return (static_cast<uint32_t>(__ldg(&words[s >> 5])) >> (s & 31u)) & 1u;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
sketch_kernel(const K* __restrict__ keys, const bool* __restrict__ live, int64_t n,
              const int32_t* __restrict__ words, uint32_t mask, bool* __restrict__ out) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    // int8/int16 keys sign-extend to int32 first, as the JAX package's
    // astype(int32) does
    const uint32_t k = static_cast<uint32_t>(static_cast<int32_t>(keys[i]));
    const uint32_t s1 = fmix32(k) & mask;
    const uint32_t s2 = fmix32(k ^ kSketchSeed) & mask;
    out[i] = live[i] && word_bit(words, s1) && word_bit(words, s2);
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

template <typename K>
cudaError_t launch_sketch(const void* keys, const void* live, int64_t n, const void* words,
                          uint32_t mask, void* out, cudaStream_t stream) {
  const int blocks = presto::grid_blocks(sketch_kernel<K>, n, kThreads, 0, kRows);
  sketch_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const K*>(keys), static_cast<const bool*>(live), n,
      static_cast<const int32_t*>(words), mask, static_cast<bool*>(out));
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_exists(const void* keys, const void* live, int64_t n, const void* words,
                          long long kmin, long long kmax, void* out, cudaStream_t stream) {
  const int blocks = presto::grid_blocks(exists_kernel<K>, n, kThreads, 0, kRows);
  exists_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const K*>(keys), static_cast<const bool*>(live), n,
      static_cast<const int32_t*>(words), kmin, kmax, static_cast<bool*>(out));
  return cudaGetLastError();
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

// Launch the exists probe on `stream`. `key_size` is the key width in
// bytes (1, 2 or 4); `words` covers the domain (>= (kmax-kmin)/32 + 1
// words, checked in Python). Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for an unsupported key width.
extern "C" int exists_probe_launch(const void* keys, int key_size, const void* live,
                                   long long n, const void* words, long long kmin,
                                   long long kmax, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (key_size) {
    case 1: return static_cast<int>(launch_exists<int8_t>(keys, live, n, words, kmin, kmax, out, s));
    case 2: return static_cast<int>(launch_exists<int16_t>(keys, live, n, words, kmin, kmax, out, s));
    case 4: return static_cast<int>(launch_exists<int32_t>(keys, live, n, words, kmin, kmax, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
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

// Launch the sketch probe on `stream`: `words` holds nbits / 32 int32
// words of the two-hash Bloom bitmask; nbits is a power of two (checked
// in Python). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unsupported key width.
extern "C" int sketch_probe_launch(const void* keys, int key_size, const void* live,
                                   long long n, const void* words, long long nbits, void* out,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits <= 0 || (nbits & (nbits - 1)) != 0 || nbits > (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const uint32_t mask = static_cast<uint32_t>(nbits - 1);
  switch (key_size) {
    case 1: return static_cast<int>(launch_sketch<int8_t>(keys, live, n, words, mask, out, s));
    case 2: return static_cast<int>(launch_sketch<int16_t>(keys, live, n, words, mask, out, s));
    case 4: return static_cast<int>(launch_sketch<int32_t>(keys, live, n, words, mask, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
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
