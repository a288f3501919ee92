// B2: block-local bitstream unpacking, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `src/repro/kernels/bitunpack.py: unpack_blocks`
// (`_unpack_kernel`); its oracle is `bits.unpack_symbols` per block.
//
// What bounds it: bytes. Per symbol it reads a bit length and writes an
// 8-byte code; the packed words are read once. The TPU kernel walks the
// symbols in order with a loop-carried offset; here one CTA owns one block:
//   * a coalesced pass stages the block's packed words in shared memory, so
//     the 3-word windows below are gathered from shared memory, not HBM;
//   * a block-wide exclusive scan of the bit lengths (256-symbol tiles with
//     a running carry) gives every symbol its bit offset;
//   * one thread per symbol gathers its 3-word window, shifts and masks the
//     <=64-bit code out, and stores it with a coalesced 8-byte write.
// Reads past the end of the row see the last word, then zeros: the
// reference pads two zero words and clamps the window's start.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
unpack_blocks_kernel(const uint32_t* __restrict__ words, int in_words,
                     const int* __restrict__ bitlen, int symbols,
                     uint2* __restrict__ codes) {
  extern __shared__ uint32_t buf[];  // in_words
  __shared__ int warp_sums[kThreads / 32];
  const size_t blk = blockIdx.x;
  const uint32_t* row = words + blk * in_words;
  const int* bl = bitlen + blk * symbols;
  uint2* out = codes + blk * symbols;
  for (int i = threadIdx.x; i < in_words; i += kThreads) buf[i] = row[i];
  __syncthreads();

  int carry = 0;
  for (int base = 0; base < symbols; base += kThreads) {
    const int i = base + threadIdx.x;
    const int n = i < symbols ? bl[i] : 0;
    int tile_total;
    const int off = carry + repro::block_exclusive_scan<kThreads>(n, warp_sums, &tile_total);
    if (i < symbols) {
      const int w = off >> 5;
      const int s = off & 31;
      const uint32_t g0 = buf[min(w, in_words - 1)];
      const uint32_t g1 = w + 1 < in_words ? buf[w + 1] : 0u;
      const uint32_t g2 = w + 2 < in_words ? buf[w + 2] : 0u;
      uint32_t lo = (g0 >> s) | repro::shl(g1, 32 - s);
      uint32_t hi = (g1 >> s) | repro::shl(g2, 32 - s);
      lo &= repro::mask_bits(min(n, 32));
      hi &= repro::mask_bits(n - 32);
      out[i] = make_uint2(lo, hi);
    }
    carry += tile_total;
  }
}

}  // namespace

// words uint32[nblocks, in_words], bitlen int32[nblocks*symbols] ->
// codes uint32[nblocks*symbols, 2]. in_words must be >= 1.
extern "C" int repro_unpack_blocks(const void* words, int nblocks, int in_words,
                                   const void* bitlen, int symbols, void* codes,
                                   void* stream) {
  if (nblocks == 0) return 0;
  const size_t smem = static_cast<size_t>(in_words) * sizeof(uint32_t);
  cudaError_t err = repro::allow_smem(unpack_blocks_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_blocks_kernel<<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), in_words, static_cast<const int*>(bitlen),
      symbols, static_cast<uint2*>(codes));
  return static_cast<int>(cudaGetLastError());
}
