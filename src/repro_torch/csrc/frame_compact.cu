// B3 and B4: device-resident frame compaction, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of `src/repro/kernels/frame_compact.py`:
//   * B3 `compact_blocks` (`_compact_kernel`), oracle `bits.compact_payload`:
//     each block's live prefix of ceil(nbits/32) words, out of its (n, OW)
//     worst-case buffer, at its exclusive-prefix-sum offset in one payload;
//     zeros past `total`.
//   * B4 `pack_meta7_blocks` (`_meta7_kernel`), oracle `bits.pack_meta7`:
//     (n, S) bit lengths at 7 bits each into (n, ceil(7S/32)) words.
//
// What bounds them: bytes. Both move words and do a handful of integer
// operations per word.
//
// B3: the Pallas kernel relies on its grid running in order, so that block
// b+1's store overwrites block b's zeroed dead tail. CTAs on a GPU run in no
// order, so nothing here overwrites anything: each CTA sums ceil(nbits/32)
// over the blocks before it (n <= 128 counts in the executor, so the O(n)
// per-CTA reduction is cheap), copies exactly its own live words, and
// zero-fills its grid-stride share of [total, n*OW). Zero-width blocks copy
// nothing and stay transparent. CTA 0 writes `total`.
//
// B4: one thread per output word. 32 symbols fill exactly 7 words, so word
// w of a row collects the <= 6 fields whose 7-bit range [7j, 7j+7) overlaps
// [32w, 32w+32), each shifted by the static amount 7j - 32w; the threads
// write disjoint words and need no atomics. A ragged row pads with zero
// symbols, as the reference does.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
compact_blocks_kernel(const uint32_t* __restrict__ words, const int* __restrict__ nbits,
                      int n, int ow, uint32_t* __restrict__ payload,
                      int* __restrict__ total_out) {
  __shared__ long long red_before[kThreads / 32];
  __shared__ long long red_all[kThreads / 32];
  const int blk = blockIdx.x;
  long long before = 0, all = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const long long nw = (static_cast<long long>(nbits[j]) + 31) >> 5;
    all += nw;
    if (j < blk) before += nw;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    before += __shfl_down_sync(0xFFFFFFFFu, before, d);
    all += __shfl_down_sync(0xFFFFFFFFu, all, d);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_before[warp] = before;
    red_all[warp] = all;
  }
  __syncthreads();
  before = 0;
  all = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    before += red_before[k];
    all += red_all[k];
  }

  const long long cap = static_cast<long long>(n) * ow;
  const long long src0 = static_cast<long long>(blk) * ow;
  const long long nw_b = (static_cast<long long>(nbits[blk]) + 31) >> 5;
  for (long long i = threadIdx.x; i < nw_b; i += kThreads) {
    const long long src = min(src0 + i, cap - 1);  // the reference's clipped gather
    payload[before + i] = words[src];
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = all + static_cast<long long>(blk) * kThreads + threadIdx.x; k < cap;
       k += stride) {
    payload[k] = 0u;
  }
  if (blk == 0 && threadIdx.x == 0) *total_out = static_cast<int>(all);
}

__global__ void __launch_bounds__(kThreads)
pack_meta7_kernel(const int* __restrict__ bitlen, int n, int symbols, int mw,
                  uint32_t* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * mw) return;
  const int row = static_cast<int>(t / mw);
  const int w = static_cast<int>(t % mw);
  const int* bl = bitlen + static_cast<long long>(row) * symbols;
  uint32_t acc = 0u;
  // field j0 = floor(32w/7) is the first whose range reaches into word w
  for (int j = (32 * w) / 7; j < symbols && 7 * j < 32 * (w + 1); ++j) {
    const uint32_t v = static_cast<uint32_t>(bl[j]) & 0x7Fu;
    const int sh = 7 * j - 32 * w;  // in (-7, 32)
    acc |= sh >= 0 ? (v << sh) : (v >> -sh);
  }
  out[t] = acc;
}

}  // namespace

// words uint32[n, ow], nbits int32[n] -> payload uint32[n*ow], total int32[1].
extern "C" int repro_compact_blocks(const void* words, const void* nbits, int n, int ow,
                                    void* payload, void* total, void* stream) {
  if (n == 0) return 0;
  compact_blocks_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(nbits), n, ow,
      static_cast<uint32_t*>(payload), static_cast<int*>(total));
  return static_cast<int>(cudaGetLastError());
}

// bitlen int32[n, symbols] -> out uint32[n, mw], mw = ceil(7*symbols/32).
extern "C" int repro_pack_meta7_blocks(const void* bitlen, int n, int symbols, int mw,
                                       void* out, void* stream) {
  const long long count = static_cast<long long>(n) * mw;
  if (count == 0) return 0;
  const unsigned grid = static_cast<unsigned>((count + kThreads - 1) / kThreads);
  pack_meta7_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bitlen), n, symbols, mw, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
