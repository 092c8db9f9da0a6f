// Fused equi-join probes against small flat lookup tables.
//
// Replaces presto_tpu/ops/pallas_join.py::exists_probe (Pallas body
// `_exists_kernel`) and ::payload_probe (`_payload_kernel`). Both look each
// probe key up in a table over the stats-proven build-key domain
// [kmin, kmax]:
// - exists:  hit = live && kmin <= key <= kmax && bit (key - kmin) of the
//            int32 word table is set; out = hit (bool).
// - payload: hit = live && kmin <= key <= kmax && present[key - kmin];
//            matched = hit, and each of the nval int32 value tables gives
//            out_j = hit ? table_j[key - kmin] : 0.
// The in-range test compares in 64 bits, never through the subtraction,
// so an out-of-domain key can never alias into the table; the slot is
// formed only under that test.
//
// Bound on the H100: the bytes moved. A probe row reads its key (1, 2 or
// 4 bytes as the connector narrowed it) and its live byte and writes one
// bool (payload: plus 4 bytes per value column); at 3.35 TB/s a 2^20-row
// exists probe of int32 keys moves 6 MB, about 2 us. The tables are at
// most 64 KB (16384 words), so after the first touches they live in L1/L2
// and their reads cost no device-memory bytes.
//
// Design against that bound: one thread per row in a grid-stride loop,
// keys read in their stored width (a template per width, chosen once per
// launch), table words through the read-only cache. Nothing is staged in
// shared memory and no loads are vectorised yet: at these sizes the
// launch latency dominates. The TPU kernel's 128-lane table replication,
// [blocks, 128] reshapes and capacity-multiple rule have no counterpart:
// any capacity works and the ragged tail is masked by the loop bound.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread covers per grid pass, for sizing
constexpr int kMaxValues = 16;

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

extern "C" const char* join_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
