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
// order, so nothing here overwrites anything: CTA b copies exactly block b's
// live words and zero-fills its grid-stride share of [total, n*OW), and CTA 0
// writes `total`. Zero-width blocks copy nothing and stay
// transparent. The design is for latency (the work is ~2.7 MB, a fraction of
// a microsecond of bandwidth):
//   * no barrier: every warp computes its block's offset `before` and the
//     sum `all` itself, 4 counts per lane in one 16-byte load and a 5-step
//     shuffle scan per 128 blocks (a loop over groups of 128 for larger n);
//   * the source loads do not wait for the counts: before the scan, each
//     thread loads the first two rounds of its row's aligned 16-byte quads
//     (2,048 words, past a typical live prefix), clipped to the array;
//   * 16-byte stores: a row starts `blk*OW + mis` words into the source and
//     lands at `before + mis` in the payload, two different offsets mod 4
//     (with OW = 4,098 every second row is 8 bytes off). Thread j holds the
//     source quad q0+j and its neighbour's q0+j-1 (a shuffle), and funnels the
//     two by the rows' relative shift into one aligned destination quad; quads
//     the live range covers whole take one 16-byte store, its two end quads
//     scalar stores of their live words. The zero fill is 16-byte stores with
//     a scalar head up to the first 16-byte boundary after `all`, and tail;
//   * the fill (~72 % of the bytes on the path's chunks) is spread over
//     the n CTAs of the copy, grid-stride in 16-byte quads. Extra fill-only
//     CTAs, so that all 132 SMs take a part (max(n, 2 x SMs) CTAs), and 512
//     threads per CTA were both slower on the path's chunk (by ~0.19 and
//     ~0.26 us, scripts/bitpack_ab.py against trees with those changes):
//     each extra warp pays the counts' round trip and scan again, and the
//     stores, not the SMs, are what they share.
// A live prefix that runs past the end of the array (nbits > 32*OW on a last
// block) takes the reference's clipped gather word by word. nbits are the
// packer's non-negative bit counts.
//
// B4: one thread per output word. 32 symbols fill exactly 7 words, so word
// w of a row collects the <= 6 fields whose 7-bit range [7j, 7j+7) overlaps
// [32w, 32w+32), each shifted by the static amount 7j - 32w; the threads
// write disjoint words and need no atomics. A ragged row pads with zero
// symbols, as the reference does.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 128;  // block counts per warp pass: 4 per lane
constexpr int kSpecRounds = 2;  // source quad rounds loaded before the counts
constexpr unsigned kFull = 0xFFFFFFFFu;

// ceil(nbits/32) as the reference's int64 floor division
__device__ __forceinline__ long long word_count(int nbits) {
  return (static_cast<long long>(nbits) + 31) >> 5;
}

// The warp's own exclusive prefix of the word counts at block `b` and block
// b's count, and the sum over all n blocks; no barrier.
template <bool kVec>
__device__ __forceinline__ void warp_prefix(const int* __restrict__ nbits, int n, int b,
                                            long long* before, long long* nwb, long long* all) {
  const int lane = threadIdx.x & 31;
  long long carry = 0;
  *before = 0;
  *nwb = 0;
  for (int g0 = 0; g0 < n; g0 += kGroup) {
    int v[4];
    repro::load_ints<kVec, 4>(nbits + g0, 4 * lane, n - g0, v);
    const long long w0 = word_count(v[0]), w1 = word_count(v[1]), w2 = word_count(v[2]),
                    w3 = word_count(v[3]);
    const long long s = w0 + w1 + w2 + w3;
    long long inc = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    const int rel = b - g0;
    if (rel >= 0 && rel < kGroup) {  // the same for every lane
      const int k = rel & 3;
      const long long mine = inc - s + (k > 0 ? w0 : 0) + (k > 1 ? w1 : 0) + (k > 2 ? w2 : 0);
      const long long own = k == 0 ? w0 : (k == 1 ? w1 : (k == 2 ? w2 : w3));
      *before = carry + __shfl_sync(kFull, mine, rel >> 2);
      *nwb = __shfl_sync(kFull, own, rel >> 2);
    }
    carry += __shfl_sync(kFull, inc, 31);
  }
  *all = carry;
}

// Aligned source quad `q` (in quads of the 16-byte-aligned base), or zeros
// when it holds no word of [lo, hi) (absolute words of that base).
__device__ __forceinline__ uint4 quad_in(const uint4* __restrict__ base, long long q, long long lo,
                                         long long hi) {
  return (4 * q + 3 >= lo && 4 * q < hi) ? base[q] : make_uint4(0u, 0u, 0u, 0u);
}

// Destination words [0, 4) of a quad whose source words start `r` words into
// `prev` and run on into `own`.
__device__ __forceinline__ uint4 funnel(const uint4& prev, const uint4& own, int r) {
  switch (r) {
    case 0: return prev;
    case 1: return make_uint4(prev.y, prev.z, prev.w, own.x);
    case 2: return make_uint4(prev.z, prev.w, own.x, own.y);
    default: return make_uint4(prev.w, own.x, own.y, own.z);
  }
}

__device__ __forceinline__ uint4 shfl_up_quad(const uint4& v) {
  return make_uint4(__shfl_up_sync(kFull, v.x, 1), __shfl_up_sync(kFull, v.y, 1),
                    __shfl_up_sync(kFull, v.z, 1), __shfl_up_sync(kFull, v.w, 1));
}

__global__ void __launch_bounds__(kThreads)
compact_blocks_kernel(const uint32_t* __restrict__ words, const int* __restrict__ nbits, int n,
                      int ow, uint32_t* __restrict__ payload, int* __restrict__ total_out) {
  const int blk = blockIdx.x, t = threadIdx.x, lane = t & 31;
  const long long cap = static_cast<long long>(n) * ow;
  // absolute words from each array's 16-byte-aligned base
  const int wm = static_cast<int>((reinterpret_cast<uintptr_t>(words) >> 2) & 3);
  const int pm = static_cast<int>((reinterpret_cast<uintptr_t>(payload) >> 2) & 3);
  const uint4* __restrict__ wq = reinterpret_cast<const uint4*>(words - wm);
  uint4* pq = reinterpret_cast<uint4*>(payload - pm);  // 16-byte stores
  uint32_t* pw = payload - pm;  // scalar stores at the ends
  const long long a0 = wm + static_cast<long long>(blk) * ow;  // the row's first source word
  const long long qs0 = a0 >> 2;

  // the row's first rounds of source quads, before the counts are known
  uint4 own[kSpecRounds], prev[kSpecRounds];
#pragma unroll
  for (int k = 0; k < kSpecRounds; ++k) {
    const long long j = t + k * kThreads;
    own[k] = quad_in(wq, qs0 + j, a0, wm + cap);
    prev[k] = lane == 0 ? quad_in(wq, qs0 + j - 1, a0, wm + cap) : make_uint4(0u, 0u, 0u, 0u);
  }

  long long before, nwb, all;
  if ((reinterpret_cast<uintptr_t>(nbits) & 15) == 0 && (n & 3) == 0) {
    warp_prefix<true>(nbits, n, blk, &before, &nwb, &all);
  } else {
    warp_prefix<false>(nbits, n, blk, &before, &nwb, &all);
  }

  // live words that land inside the payload
  const long long live = max(0LL, min(nwb, cap - before));
  if (static_cast<long long>(blk) * ow + live > cap) {
    // the live prefix runs past the array: the reference's clipped gather
    for (long long i = t; i < live; i += kThreads) {
      payload[before + i] = words[min(static_cast<long long>(blk) * ow + i, cap - 1)];
    }
  } else if (live > 0) {
    const long long d0 = pm + before, d1 = d0 + live;  // destination words [d0, d1)
    const long long delta = a0 - d0;
    const long long dq = delta >> 2;  // floor
    const int r = static_cast<int>(delta & 3);
    // thread j writes destination quad qs0 + j - 1 - dq
    const long long jend = ((d1 - 1) >> 2) + 2 + dq - qs0;
    for (int k = 0; static_cast<long long>(k) * kThreads < jend; ++k) {
      const long long j = t + static_cast<long long>(k) * kThreads;
      uint4 o, p;
      if (k < kSpecRounds) {
        o = own[k];
        p = prev[k];
      } else {
        o = quad_in(wq, qs0 + j, a0, a0 + live);
        p = lane == 0 ? quad_in(wq, qs0 + j - 1, a0, a0 + live) : make_uint4(0u, 0u, 0u, 0u);
      }
      const uint4 up = shfl_up_quad(o);
      if (lane != 0) p = up;
      const long long q = qs0 + j - 1 - dq;
      if (j >= jend || 4 * q + 3 < d0 || 4 * q >= d1) continue;
      const uint4 v = funnel(p, o, r);
      if (4 * q >= d0 && 4 * q + 4 <= d1) {
        pq[q] = v;
      } else {
        const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (4 * q + i >= d0 && 4 * q + i < d1) pw[4 * q + i] = vs[i];
        }
      }
    }
  }

  // zeros on [all, cap): scalar head and tail, 16-byte quads between
  const long long f0 = pm + min(max(all, 0LL), cap), f1 = pm + cap;
  const long long qa = (f0 + 3) >> 2, qb = f1 >> 2;
  if (blk == 0 && t < 4) {
    const long long h = f0 + t;
    if (h < min(4 * qa, f1)) pw[h] = 0u;
    const long long e = 4 * qb + t;
    if (qa <= qb && e < f1) pw[e] = 0u;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long q = qa + static_cast<long long>(blk) * kThreads + t; q < qb; q += stride) {
    pq[q] = zero;
  }
  if (blk == 0 && t == 0) *total_out = static_cast<int>(all);
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
