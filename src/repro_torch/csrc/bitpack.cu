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
// the floor. On the codec path a launch is 128 blocks of 2,048 symbols, one
// CTA per block on 132 SMs, so each CTA's chain of latencies is the time.
// The TPU kernel folds symbols one after another because a grid step is
// sequential; here one CTA of 256 threads owns one block and keeps that
// chain short:
//   * every load up front: each thread owns K = 8 consecutive symbols of a
//     round of 2,048 and issues its bit lengths (two 16-byte loads) and its
//     codes (four 16-byte loads, two codes each) before any barrier, so the
//     block's 24 KB is in flight at once. Blocks whose size is not a
//     multiple of 4 (or unaligned tensors) take scalar loads; blocks of more
//     than 2,048 symbols take rounds with a running carry;
//   * one block scan per round: each thread scans its K lengths in
//     registers, then one `block_exclusive_scan` of the per-thread totals
//     (3 barriers) gives every symbol its bit offset;
//   * each symbol ORs its lo/mid/hi words into a shared-memory copy of the
//     row with shared atomicOr. Symbols own disjoint bit ranges, so the OR
//     is exact and order-free (the argument of bits.py's header); K
//     consecutive symbols per thread leave few conflicts;
//   * the row goes out with 16-byte stores: shared memory holds row word i
//     at index i + mis, mis the row's misalignment in words, so shared and
//     global quads line up (a row of 4,098 words starts 8 bytes off every
//     second time); the zero tail past the live prefix is stored from
//     registers, and thread 0 stores the bit count.
// Contributions past `out_words` are dropped, as the reference's
// `.at[].add(mode="drop")` drops them.
//
// A row whose copy does not fit shared memory (out_words past ~58,000: a
// planner candidate's LAZY micro-batch block of 49,152 symbols has 98,306)
// takes the kernel's unstaged instance (kStaged false): the CTA zeroes its
// row in device memory, the scan's barriers order that before the ORs, and
// the symbols OR into the row there with global atomicOr; no store pass.
//
// With the template flag kMeta the same launch also does B4's work
// (`src/repro/kernels/frame_compact.py: pack_meta7_blocks`, plain version
// `kernels/ref.py: pack_meta7_ref`) for blocks of a multiple of 32
// symbols: the block's bit lengths at 7 bits each (`uint32(n) & 0x7F`,
// as B4 masks them) into its row of ceil(7S/32) = 7S/32 metadata words.
// B4 as a launch of its own re-read the lengths this kernel has just loaded
// and spent ~1.7-1.9 us of its ~2.8 us outside its CTAs. Here each thread
// forms the 56-bit value of its 8 loaded lengths; 4 consecutive threads
// hold 32 symbols = 224 bits = exactly 7 words, and thread p of the 4
// takes its 64-bit window [64p, 64p + 64) of them from its own value and
// its neighbour's (one shuffle), storing words 2p and 2p + 1 (thread 3
// only word 6). Round r of a block lands at meta word r*448 (2,048
// symbols fill 448 words). The stores go out as soon as the lengths are
// in, with no barrier added. Without the flag the kernel is B1 alone.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;  // consecutive symbols per thread in a round
constexpr int kRound = kThreads * kPer;

// Thread's K codes of the round from `first` (zeros past `symbols`); kVec as
// for repro::load_ints (pairs of codes in one 16-byte load).
template <bool kVec>
__device__ __forceinline__ void load_codes(const uint2* __restrict__ c, int first, int symbols,
                                           uint2 (&code)[kPer]) {
#pragma unroll
  for (int g = 0; g < kPer; g += 2) {
    if (kVec) {
      const uint4 v = first + g < symbols ? *reinterpret_cast<const uint4*>(c + first + g)
                                          : make_uint4(0u, 0u, 0u, 0u);
      code[g] = make_uint2(v.x, v.y), code[g + 1] = make_uint2(v.z, v.w);
    } else {
      code[g] = first + g < symbols ? c[first + g] : make_uint2(0u, 0u);
      code[g + 1] = first + g + 1 < symbols ? c[first + g + 1] : make_uint2(0u, 0u);
    }
  }
}

// The round's 7-bit metadata from each thread's 8 loaded lengths `n` (of
// symbols [first, first + 8)), into the block's metadata row `row`.
__device__ __forceinline__ void store_meta7(const int (&n)[kPer], int first, int symbols,
                                            uint32_t* __restrict__ row) {
  uint64_t v = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) v |= static_cast<uint64_t>(static_cast<uint32_t>(n[k]) & 0x7Fu) << (7 * k);
  const uint64_t next = __shfl_down_sync(0xFFFFFFFFu, v, 1);  // the group's next thread
  const int p = threadIdx.x & 3;
  const int group = first - p * kPer;  // the group's first symbol, a multiple of 32
  const uint64_t w = (v >> (8 * p)) | (next << (56 - 8 * p));  // group bits [64p, 64p + 64)
  if (group < symbols) {
    uint32_t* dst = row + group / 32 * 7 + 2 * p;
    dst[0] = static_cast<uint32_t>(w);
    if (p < 3) dst[1] = static_cast<uint32_t>(w >> 32);
  }
}

// The staged row out with 16-byte stores: quad q holds row words 4q - mis ..
// 4q - mis + 3; the ends are partial, the zero tail past the live prefix
// comes from registers.
__device__ __forceinline__ void store_row(const uint4* quads, int carry, int out_words, int mis, int nq,
                                          uint32_t* __restrict__ out) {
  const int live = min(out_words, (carry + 31) >> 5);
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int w0 = 4 * q - mis;
    const uint4 v = w0 < live ? quads[q] : make_uint4(0u, 0u, 0u, 0u);
    if (w0 >= 0 && w0 + 4 <= out_words) {
      *reinterpret_cast<uint4*>(out + w0) = v;
    } else {
      const uint32_t e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (w0 + j >= 0 && w0 + j < out_words) out[w0 + j] = e[j];
    }
  }
}

template <bool kVec, bool kMeta, bool kStaged>
__global__ void __launch_bounds__(kThreads)
pack_blocks_kernel(const uint2* __restrict__ codes, const int* __restrict__ bitlen,
                   int symbols, int out_words, uint32_t* __restrict__ words,
                   int* __restrict__ nbits, uint32_t* __restrict__ meta) {
  extern __shared__ uint4 quads[];  // kStaged: (out_words + mis + 3) / 4 quads
  __shared__ int warp_sums[kThreads / 32];
  const size_t blk = blockIdx.x;
  const uint2* c = codes + blk * symbols;
  const int* bl = bitlen + blk * symbols;
  uint32_t* out = words + blk * out_words;
  // the row the symbols OR into: a shared-memory copy, or the row itself
  uint32_t* buf = kStaged ? reinterpret_cast<uint32_t*>(quads) : out;
  const int mis = kStaged ? static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3) : 0;
  const int nq = (out_words + mis + 3) >> 2;

  int carry = 0;
  for (int base = 0; base < symbols; base += kRound) {
    const int first = base + threadIdx.x * kPer;
    int n[kPer];
    uint2 code[kPer];
    repro::load_ints<kVec>(bl, first, symbols, n);
    load_codes<kVec>(c, first, symbols, code);
    if constexpr (kMeta) store_meta7(n, first, symbols, meta + blk * (symbols / 32 * 7));
    if (base == 0) {  // ordered before the ORs by the scan's barriers
      if constexpr (kStaged) {
        for (int q = threadIdx.x; q < nq; q += kThreads) quads[q] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int i = threadIdx.x; i < out_words; i += kThreads) out[i] = 0u;
      }
    }
    int local[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) local[k] = sum, sum += n[k];
    int round_total;
    const int off = carry + repro::block_exclusive_scan<kThreads>(sum, warp_sums, &round_total);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (n[k] <= 0) continue;
      const int o = off + local[k];
      const uint32_t c0 = code[k].x & repro::mask_bits(min(n[k], 32));
      const uint32_t c1 = code[k].y & repro::mask_bits(n[k] - 32);
      const int w = o >> 5;
      const int s = o & 31;
      // bits.code64_shift: the 96-bit image of the code shifted left by s
      const uint32_t lo = c0 << s;
      const uint32_t mid = repro::shr(c0, 32 - s) | (c1 << s);
      const uint32_t hi = repro::shr(c1, 32 - s);
      if (lo && w < out_words) atomicOr(&buf[mis + w], lo);
      if (mid && w + 1 < out_words) atomicOr(&buf[mis + w + 1], mid);
      if (hi && w + 2 < out_words) atomicOr(&buf[mis + w + 2], hi);
    }
    carry += round_total;
  }
  if constexpr (kStaged) {
    __syncthreads();
    store_row(quads, carry, out_words, mis, nq, out);
  }
  if (threadIdx.x == 0) nbits[blk] = carry;
}

template <bool kMeta>
int launch_pack(const void* codes, const void* bitlen, int nblocks, int symbols, int out_words,
                void* words, void* nbits, void* meta, void* stream) {
  if (nblocks == 0) return 0;
  size_t smem = static_cast<size_t>((out_words + 6) / 4) * sizeof(uint4);
  const bool vec = symbols % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(bitlen)) & 15) == 0;
  auto kernel = vec ? pack_blocks_kernel<true, kMeta, true> : pack_blocks_kernel<false, kMeta, true>;
  if (!repro::fits_smem(kernel, smem)) {  // the row in device memory
    kernel = vec ? pack_blocks_kernel<true, kMeta, false> : pack_blocks_kernel<false, kMeta, false>;
    smem = 0;
  }
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(codes), static_cast<const int*>(bitlen), symbols,
      out_words, static_cast<uint32_t*>(words), static_cast<int*>(nbits),
      static_cast<uint32_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes uint32[nblocks*symbols, 2], bitlen int32[nblocks*symbols] ->
// words uint32[nblocks, out_words], nbits int32[nblocks].
extern "C" int repro_pack_blocks(const void* codes, const void* bitlen, int nblocks,
                                 int symbols, int out_words, void* words, void* nbits,
                                 void* stream) {
  return launch_pack<false>(codes, bitlen, nblocks, symbols, out_words, words, nbits, nullptr,
                            stream);
}

// repro_pack_blocks, and meta uint32[nblocks, 7*symbols/32], the bit lengths
// at 7 bits each; symbols % 32 == 0.
extern "C" int repro_pack_blocks_meta7(const void* codes, const void* bitlen, int nblocks,
                                       int symbols, int out_words, void* words, void* nbits,
                                       void* meta, void* stream) {
  return launch_pack<true>(codes, bitlen, nblocks, symbols, out_words, words, nbits, meta,
                           stream);
}
