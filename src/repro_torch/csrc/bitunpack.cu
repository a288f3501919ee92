// B2: block-local bitstream unpacking, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `src/repro/kernels/bitunpack.py: unpack_blocks`
// (`_unpack_kernel`); its oracle is `bits.unpack_symbols` per block.
//
// What bounds it: bytes. Per symbol it reads a bit length and writes an
// 8-byte code; only the packed words the symbols cover need reading. On the
// codec path a launch is 128 blocks of 2,048 symbols in rows padded to
// 4,098 words, of which ~680 are live, one CTA per block on 132 SMs, so
// each CTA's chain of latencies is the time. The TPU kernel walks the
// symbols in order with a loop-carried offset; here one CTA of 256 threads
// owns one block:
//   * lengths first: each thread owns K = 8 consecutive symbols of a round
//     of 2,048 and loads their bit lengths (two 16-byte loads; scalar loads
//     for blocks whose size is not a multiple of 4 or unaligned tensors)
//     together with one speculative quad of the row, so the row's first
//     ~1,020 words are in flight with the lengths;
//   * one block scan per round: a scan of the K lengths in registers, then
//     one `block_exclusive_scan` of the per-thread totals (3 barriers); the
//     thread writes its K bit offsets to shared memory;
//   * stage the live words only: the round's end offset gives the words any
//     window can read, min(in_words, ((end - 1) >> 5) + 3); the prefetched
//     quads go to shared memory and only words past them are loaded, as
//     16-byte quads (shared index = row word + mis, mis the row's
//     misalignment in words, so the quads line up); one barrier;
//   * extraction by pairs: thread t takes symbols 2p and 2p + 1 for p = t,
//     t + 256, ..., so a warp's 16-byte stores of two codes each are
//     contiguous (K consecutive symbols per thread would leave each store
//     instruction a quarter of every line it touches). A symbol's length is
//     its offset's difference to the next one's (the round's end after its
//     last symbol); its 3-word window comes from shared memory. Blocks of
//     more than 2,048 symbols take rounds with a running carry, staging
//     further words as their offsets grow.
// A window that starts past the row reads its last word, then zeros: the
// reference pads two zero words and clamps the window's start.
//
// A row whose copy does not fit shared memory (in_words past ~58,000: a
// planner candidate's LAZY micro-batch block of 49,152 symbols has 98,306)
// takes the kernel's unstaged instance (kStaged false): the windows read
// the row in device memory, nothing is staged.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;  // consecutive symbols per thread in a round
constexpr int kRound = kThreads * kPer;

// Quad q of the row (row words 4q - mis .. 4q - mis + 3), zeros outside it.
__device__ __forceinline__ uint4 load_quad(const uint32_t* __restrict__ row, int in_words,
                                           int mis, int q) {
  const int w0 = 4 * q - mis;
  if (w0 >= 0 && w0 + 4 <= in_words) return *reinterpret_cast<const uint4*>(row + w0);
  uint32_t e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = w0 + j >= 0 && w0 + j < in_words ? row[w0 + j] : 0u;
  return make_uint4(e[0], e[1], e[2], e[3]);
}

// The <=64-bit code of n bits at bit offset o, from the staged row (B1's
// code64 window read back): the window's start clamps to the last word and
// words past the row read as zeros.
__device__ __forceinline__ uint2 extract(const uint32_t* buf, int mis, int in_words, int o, int n) {
  if (n <= 0) return make_uint2(0u, 0u);
  const int w = o >> 5;
  const int s = o & 31;
  const uint32_t g0 = buf[mis + min(w, in_words - 1)];
  const uint32_t g1 = w + 1 < in_words ? buf[mis + w + 1] : 0u;
  const uint32_t g2 = w + 2 < in_words ? buf[mis + w + 2] : 0u;
  return make_uint2(((g0 >> s) | repro::shl(g1, 32 - s)) & repro::mask_bits(min(n, 32)),
                    ((g1 >> s) | repro::shl(g2, 32 - s)) & repro::mask_bits(n - 32));
}

template <bool kVec, bool kStaged>
__global__ void __launch_bounds__(kThreads)
unpack_blocks_kernel(const uint32_t* __restrict__ words, int in_words,
                     const int* __restrict__ bitlen, int symbols,
                     uint2* __restrict__ codes) {
  extern __shared__ uint4 quads[];  // kStaged: (in_words + mis + 3) / 4 quads
  __shared__ int warp_sums[kThreads / 32];
  __shared__ __align__(16) int offs[kRound + 4];  // the round's bit offsets, then its end
  const size_t blk = blockIdx.x;
  const uint32_t* row = words + blk * in_words;
  const int* bl = bitlen + blk * symbols;
  uint2* out = codes + blk * symbols;
  // the row the windows read: its staged copy in shared memory, or itself
  const uint32_t* buf = kStaged ? reinterpret_cast<const uint32_t*>(quads) : row;
  const int mis = kStaged ? static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3) : 0;
  const int nq = (in_words + mis + 3) >> 2;

  const bool prefetched = kStaged && threadIdx.x < nq;
  const uint4 pre = prefetched ? load_quad(row, in_words, mis, threadIdx.x)
                               : make_uint4(0u, 0u, 0u, 0u);
  int staged = 0;  // quads in shared memory, block-uniform
  int carry = 0;
  for (int base = 0; base < symbols; base += kRound) {
    const int first = base + threadIdx.x * kPer;
    int n[kPer];
    repro::load_ints<kVec>(bl, first, symbols, n);
    int local[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) local[k] = sum, sum += n[k];
    int round_total;
    const int off = carry + repro::block_exclusive_scan<kThreads>(sum, warp_sums, &round_total);
#pragma unroll
    for (int g = 0; g < kPer; g += 4)
      *reinterpret_cast<int4*>(&offs[threadIdx.x * kPer + g]) =
          make_int4(off + local[g], off + local[g + 1], off + local[g + 2], off + local[g + 3]);
    carry += round_total;
    if (threadIdx.x == 0) offs[kRound] = carry;  // symbols past the block have n = 0

    // the words any window of this round can read, as quads
    if constexpr (kStaged) {
      const int need = min(in_words, max(1, ((carry - 1) >> 5) + 3));
      const int need_q = (need + mis + 3) >> 2;
      if (need_q > staged) {
        if (staged == 0 && prefetched) quads[threadIdx.x] = pre;
        const int from = staged == 0 ? min(nq, kThreads) : staged;
        for (int q = from + threadIdx.x; q < need_q; q += kThreads)
          quads[q] = load_quad(row, in_words, mis, q);
        staged = max(need_q, from);
      }
    }
    __syncthreads();

    // pairs of symbols, consecutive across the threads: coalesced stores;
    // a symbol's length is the difference of its offset and the next one's
#pragma unroll
    for (int j = 0; j < kPer / 2; ++j) {
      const int i = 2 * (threadIdx.x + j * kThreads);
      if (base + i >= symbols) break;
      const int2 o = *reinterpret_cast<const int2*>(&offs[i]);
      const int o2 = offs[i + 2];
      const uint2 a = extract(buf, mis, in_words, o.x, o.y - o.x);
      const uint2 b = extract(buf, mis, in_words, o.y, o2 - o.y);
      if (kVec) {
        *reinterpret_cast<uint4*>(out + base + i) = make_uint4(a.x, a.y, b.x, b.y);
      } else {
        out[base + i] = a;
        if (base + i + 1 < symbols) out[base + i + 1] = b;
      }
    }
  }
}

}  // namespace

// words uint32[nblocks, in_words], bitlen int32[nblocks*symbols] ->
// codes uint32[nblocks*symbols, 2]. in_words must be >= 1.
extern "C" int repro_unpack_blocks(const void* words, int nblocks, int in_words,
                                   const void* bitlen, int symbols, void* codes,
                                   void* stream) {
  if (nblocks == 0) return 0;
  size_t smem = static_cast<size_t>((in_words + 6) / 4) * sizeof(uint4);
  const bool vec = symbols % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(bitlen) | reinterpret_cast<uintptr_t>(codes)) & 15) == 0;
  auto kernel = vec ? unpack_blocks_kernel<true, true> : unpack_blocks_kernel<false, true>;
  if (!repro::fits_smem(kernel, smem)) {  // the row read in device memory
    kernel = vec ? unpack_blocks_kernel<true, false> : unpack_blocks_kernel<false, false>;
    smem = 0;
  }
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), in_words, static_cast<const int*>(bitlen),
      symbols, static_cast<uint2*>(codes));
  return static_cast<int>(cudaGetLastError());
}
