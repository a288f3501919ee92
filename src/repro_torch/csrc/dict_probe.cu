// B5: Tdic32 dictionary probe against a frozen table, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `src/repro/kernels/dict_hash.py: probe`
// (`_probe_kernel`), oracle `src/repro/kernels/ref.py: probe_ref`. Widened
// to per-lane tables: x (L, N), table (L, TS), valid (L, TS) with
// TS = 2^idx_bits; L = 1 is the Pallas contract. Per symbol:
//   h   = (x * 2654435761) >> (32 - idx_bits)        (uint32 arithmetic)
//   hit = valid[h] && table[h] == x
//   hit:  c0 = 1 | h << 1, c1 = 0,      bitlen = 1 + idx_bits
//   miss: c0 = x << 1,     c1 = x >> 31, bitlen = 33
//
// What bounds it: bytes and, at the main path's shape, the launch. One
// micro-batch block (4 lanes x 512 tuples, idx_bits 12) reads 8 KiB of x
// and at most 64 KiB of table and 16 KiB of valid, and writes 24 KiB:
// about 0.034 us at 3.35 TB/s, far under the few microseconds a launch
// costs. The TPU kernel keeps the whole table in VMEM for every grid step;
// here one thread per symbol gathers its one table word and valid byte
// straight from device memory (the L2 holds the block's tables), which is
// all the work there is: there is no reuse that shared memory would buy.
// idx_bits is a runtime argument, checked by the wrapper to lie in
// [1, 31], so the shift is never 32.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kKnuth = 2654435761u;

__global__ void __launch_bounds__(kThreads)
dict_probe_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ table,
                  const uint8_t* __restrict__ valid, long long total, int n, int idx_bits,
                  uint32_t* __restrict__ c0, uint32_t* __restrict__ c1,
                  int* __restrict__ bitlen) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long lane = i / n;
  const uint32_t v = x[i];
  const uint32_t h = (v * kKnuth) >> (32 - idx_bits);
  const long long slot = (lane << idx_bits) + h;
  const bool hit = valid[slot] != 0 && table[slot] == v;
  c0[i] = hit ? (1u | (h << 1)) : (v << 1);
  c1[i] = hit ? 0u : (v >> 31);
  bitlen[i] = hit ? 1 + idx_bits : 33;
}

}  // namespace

// x uint32[lanes, n], table uint32[lanes, 2^idx_bits], valid uint8[lanes,
// 2^idx_bits] -> c0, c1 uint32[lanes, n], bitlen int32[lanes, n].
extern "C" int repro_dict_probe(const void* x, const void* table, const void* valid,
                                int lanes, int n, int idx_bits, void* c0, void* c1,
                                void* bitlen, void* stream) {
  const long long total = static_cast<long long>(lanes) * n;
  if (total == 0) return 0;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  dict_probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(table),
      static_cast<const uint8_t*>(valid), total, n, idx_bits, static_cast<uint32_t*>(c0),
      static_cast<uint32_t*>(c1), static_cast<int*>(bitlen));
  return static_cast<int>(cudaGetLastError());
}
