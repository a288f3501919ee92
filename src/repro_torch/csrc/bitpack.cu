// B1: block-local bitstream packing, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `src/repro/kernels/bitpack.py: pack_blocks`
// (`_pack_kernel`). It also meets the wire contract of
// `src/repro/core/bits.py: pack_bits` for one micro-batch block: the output
// width `out_words` is a parameter, 2*block+1 for the kernel contract and
// lanes*B*2+2 for a frame block; the live prefix is the same.
//
// What bounds it: bytes. Per symbol it reads 12 bytes (two code words and a
// bit length) and does a few shifts, so device memory, not arithmetic, sets
// the floor. The TPU kernel folds symbols one after another because a grid
// step is sequential; here one CTA owns one block and its 256 threads work
// on 256 symbols at a time:
//   * a block-wide exclusive scan of the bit lengths gives every symbol its
//     bit offset (a running carry links the 256-symbol tiles);
//   * each symbol ORs its lo/mid/hi words into a shared-memory copy of the
//     block's output with shared atomicOr. Symbols own disjoint bit ranges,
//     so the OR is exact and order-free (the argument of bits.py's header);
//   * one coalesced pass stores the buffer, and thread 0 the bit count.
// Reads of codes are coalesced 8-byte loads; the only global writes are the
// final coalesced store. Contributions past `out_words` are dropped, as the
// reference's `.at[].add(mode="drop")` drops them.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_blocks_kernel(const uint2* __restrict__ codes, const int* __restrict__ bitlen,
                   int symbols, int out_words, uint32_t* __restrict__ words,
                   int* __restrict__ nbits) {
  extern __shared__ uint32_t buf[];  // out_words
  __shared__ int warp_sums[kThreads / 32];
  const size_t blk = blockIdx.x;
  const uint2* c = codes + blk * symbols;
  const int* bl = bitlen + blk * symbols;
  for (int i = threadIdx.x; i < out_words; i += kThreads) buf[i] = 0u;
  __syncthreads();

  int carry = 0;
  for (int base = 0; base < symbols; base += kThreads) {
    const int i = base + threadIdx.x;
    const int n = i < symbols ? bl[i] : 0;
    int tile_total;
    const int off = carry + repro::block_exclusive_scan<kThreads>(n, warp_sums, &tile_total);
    if (i < symbols && n > 0) {
      const uint2 cc = c[i];
      const uint32_t c0 = cc.x & repro::mask_bits(min(n, 32));
      const uint32_t c1 = cc.y & repro::mask_bits(n - 32);
      const int w = off >> 5;
      const int s = off & 31;
      // bits.code64_shift: the 96-bit image of the code shifted left by s
      const uint32_t lo = c0 << s;
      const uint32_t mid = repro::shr(c0, 32 - s) | (c1 << s);
      const uint32_t hi = repro::shr(c1, 32 - s);
      if (lo && w < out_words) atomicOr(&buf[w], lo);
      if (mid && w + 1 < out_words) atomicOr(&buf[w + 1], mid);
      if (hi && w + 2 < out_words) atomicOr(&buf[w + 2], hi);
    }
    carry += tile_total;
  }
  __syncthreads();

  uint32_t* out = words + blk * out_words;
  for (int i = threadIdx.x; i < out_words; i += kThreads) out[i] = buf[i];
  if (threadIdx.x == 0) nbits[blk] = carry;
}

}  // namespace

// codes uint32[nblocks*symbols, 2], bitlen int32[nblocks*symbols] ->
// words uint32[nblocks, out_words], nbits int32[nblocks].
extern "C" int repro_pack_blocks(const void* codes, const void* bitlen, int nblocks,
                                 int symbols, int out_words, void* words, void* nbits,
                                 void* stream) {
  if (nblocks == 0) return 0;
  const size_t smem = static_cast<size_t>(out_words) * sizeof(uint32_t);
  cudaError_t err = repro::allow_smem(pack_blocks_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_blocks_kernel<<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(codes), static_cast<const int*>(bitlen), symbols,
      out_words, static_cast<uint32_t*>(words), static_cast<int*>(nbits));
  return static_cast<int>(cudaGetLastError());
}
