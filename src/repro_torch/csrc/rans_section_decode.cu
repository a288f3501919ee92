// B9 in its section form: a frame section's packed u16 stream words, lane
// states and lane counts in, the section's bytes out, for Hopper (sm_90a).
//
// Replaces, on the entropy stage's path, the Pallas kernel of
// `src/repro/kernels/rans.py` (`decode_rows`, `_dec_kernel`) together with
// its caller's int32 route (`src/repro/core/entropy.py: _decode_device`:
// the stream widened to one u16 per int32, the byte mask, the int32 symbol
// grid). The plain version is `kernels/ref.py: rans_section_decode_ref`
// (the u16s unpacked, `rans_decode_ref` on the section's chunk grid with
// `cap = decode_cap(C)`, narrowed to bytes). The contract kernel
// `csrc/rans.cu: rans_decode` stays, for the Pallas contract's grids.
//
// The coder: lane j of chunk c decodes bytes c*4096 + 8t + j (t < 512, up
// to byte n) from state states[c, j], reading u16s from its offset in the
// stream (the exclusive sum of the counts before it, taken by the wrapper
// with `torch.cumsum` in int32, as the reference's decoder takes it). A read
// at position p sees the stream as the reference's padded copy does: the
// u16 at min(max(p, 0), cap - 1) when that is below `total`, else 0 (so the
// odd pad half of the last word reads 0 whatever the wire holds, and a
// corrupt lane reads on into its neighbours' u16s as in the reference).
//
// What bounds it: bytes (~2 per u16 read, 1 per byte written, a state and a
// count per lane) and the chain: 512 dependent steps per lane, one thread
// per lane stream being all the parallelism the coder has (~67,600 threads
// on a 34.6 MB section, ~16 warps per SM). The design shortens each step and
// keeps every global access off the chain:
//   * one table lookup per step: each CTA builds a 32-bit entry per slot in
//     shared memory (16 KB), `sym | (f - 1) << 8 | (slot - cum) << 20`,
//     exact for every table the decoder accepts (non-negative frequencies
//     summing to 4096: the slot's symbol has 1 <= f <= 4096 and
//     slot - cum < f). The step is x2 = f*(x >> 12) + (slot - cum), one
//     shared-memory load on the chain instead of three in series. The
//     table is built from marks (symbol s + 1 at its first slot, for f > 0)
//     and a running maximum over the 4,096 slots: 16 consecutive slots a
//     thread, then one block scan of the threads' maxima.
//   * the stream staged ahead: each thread keeps a ring of 64 u16s of its
//     lane's stream in shared memory, filled a quad (16 bytes, 8 u16s) at
//     a time by asynchronous copies (`cp.async`); the next u16 is read from
//     the ring right after the previous one is used, so its shared-memory
//     load is off the chain too. Copies are issued and waited for only at
//     checkpoints every 8 steps, the same for the whole warp: one quad more
//     where fewer than 32 u16s are staged ahead, and a wait that leaves the
//     two latest checkpoints' copies in flight, so a copy has 16 steps to
//     land. (A register window that each lane refilled on entering a new
//     quad was 2.7x slower: a warp's scoreboard is shared by its lanes, so
//     one lane's refill waited for the loads other lanes had just issued.
//     Reading the ring two or four u16s at a time was slower too.) A quad
//     wholly inside the stream is one copy when the words are 16-byte
//     aligned; any other is built from the guarded u16 reads of the rule
//     above and stored at once.
//   * bytes out through a warp tile: a warp's 32 threads are 4 chunks x 8
//     lanes; every 16 steps each lane has written its bytes into the warp's
//     shared tile (4 chunks x 128 contiguous bytes, rows padded to 144 so
//     the 4 chunks' byte stores fall in different banks), and the warp then
//     stores the tile with 16-byte stores, one per thread, between two
//     `__syncwarp`s and no CTA barrier (a byte store to global memory per
//     step instead was 1.25x slower). Bytes at or past n are not stored.
// A CTA is 8 warps (32 chunks); a CTA size chosen per launch to spread the
// warps evenly over the SMs timed the same (scripts/bitpack_ab.py).

#include "common.cuh"

namespace {

constexpr int kLanes = 8;
constexpr int kRows = 512;
constexpr int kChunkBytes = kRows * kLanes;
constexpr int kProbBits = 12;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kTileRows = 16;  // rows between two tile stores
constexpr int kTileStride = kTileRows * kLanes + 16;  // a chunk's 128 bytes, padded
constexpr int kWarpTile = 4 * kTileStride;  // 4 chunks per warp
constexpr int kRingQuads = 8;  // a lane's ring of staged quads
constexpr int kRingU16 = 8 * kRingQuads;
constexpr int kCheck = 8;  // steps between two checkpoints
constexpr int kAhead = 32;  // u16s staged ahead of the read position after a checkpoint
constexpr int kThreads = 256;  // 8 warps; thread t builds table slots [16t, 16t + 16)
constexpr int kTableBytes = kProbScale * 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Stream {
  const uint32_t* words;  // two u16 to a word, low half first
  long long total;  // u16s in the stream
  long long cap;  // the reference's padded length, >= total
  bool vec;  // words 16-byte aligned
};

// u16 at position p, read as the reference reads its padded stream.
__device__ __forceinline__ uint32_t read_u16(const Stream& s, long long p) {
  const long long e = p < 0 ? 0 : (p > s.cap - 1 ? s.cap - 1 : p);
  return e < s.total ? (s.words[e >> 1] >> (16 * (e & 1))) & 0xFFFFu : 0u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem));
}

// One lane's decoder: the state, the u16 at the read position, the read
// position and the staged frontier (both relative to `base`, a multiple of
// 8; the ring holds relative positions [f - 64, f) at index pos & 63).
struct Lane {
  uint32_t x;
  uint32_t val;
  int r;
  int f;
  long long base;
};

// Stage the quad at relative position d.f into the lane's ring: a 16-byte
// asynchronous copy when it lies wholly inside the stream and the words are
// aligned, else the guarded reads, stored at once.
__device__ __forceinline__ void stage(Lane& d, uint16_t* ring, const Stream& s) {
  const long long lo = d.base + d.f;
  uint16_t* dst = ring + (d.f & (kRingU16 - 1));
  if (s.vec && lo >= 0 && lo + 8 <= s.total) {
    cp_async16(dst, s.words + (lo >> 1));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = read_u16(s, lo + 2 * i) | (read_u16(s, lo + 2 * i + 1) << 16);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  d.f += 8;
}

// Every kCheck steps, for the whole warp: one more quad staged where fewer
// than kAhead u16s are staged ahead of the read position, and a wait for
// every copy but the two latest checkpoints' (so a copy has 16 steps to
// land; a window of kCheck steps reads at most positions r .. r + 8, which
// the copies up to two checkpoints back cover).
__device__ __forceinline__ void checkpoint(Lane& d, uint16_t* ring, const Stream& s) {
  if (d.f - d.r < kAhead) stage(d, ring, s);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 2;\n" ::);
}

// One decode step of lane `d`; returns the table entry (its low byte is the
// byte decoded).
__device__ __forceinline__ uint32_t step(Lane& d, const uint32_t* __restrict__ tab,
                                         const uint16_t* ring) {
  const uint32_t e = tab[d.x & (kProbScale - 1u)];
  const uint32_t xs = d.x >> kProbBits;
  const uint32_t x2 = ((e >> 8) & 0xFFFu) * xs + (xs + (e >> 20));  // f*xs + (slot - cum)
  const bool need = x2 < kRansL;
  d.x = need ? __byte_perm(d.val, x2, 0x5410) : x2;  // (x2 << 16) | the u16 read
  if (need) d.val = ring[++d.r & (kRingU16 - 1)];  // the next u16, ready by the next step
  return e;
}

// 16 rows from t0 for the warp: each lane's bytes into the tile (`col`, its
// column of its chunk's tile row), with a checkpoint every 8, then the tile
// to global memory, thread l storing the 16 bytes of piece l & 7 of its
// chunk's 128.
template <bool kRagged>
__device__ __forceinline__ void rows16(Lane& d, int t0, int rows, const uint32_t* __restrict__ tab,
                                       uint16_t* ring, const Stream& s, uint8_t* col,
                                       const uint8_t* piece, uint8_t* __restrict__ out,
                                       long long dst0, long long n, bool vec_out) {
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    if (!kRagged || t0 + r < rows) col[r * kLanes] = static_cast<uint8_t>(step(d, tab, ring));
    if (r % kCheck == kCheck - 1) checkpoint(d, ring, s);
  }
  __syncwarp();
  const long long dst = dst0 + t0 * kLanes;
  if (vec_out && dst + 16 <= n) {
    *reinterpret_cast<uint4*>(out + dst) = *reinterpret_cast<const uint4*>(piece);
  } else {
    for (int b = 0; b < 16 && dst + b < n; ++b) out[dst + b] = piece[b];
  }
  __syncwarp();  // the tile is read before it is written again
}

// The slot table (entry per slot as above) from the frequencies; every
// thread of the CTA calls it, and it ends with a barrier. Thread t owns
// slots [16t, 16t + 16): the running maximum of the marks over its slots,
// then over the threads before it (one block scan), gives each slot's
// symbol.
__device__ __forceinline__ void build_table(const int* __restrict__ freqs, uint32_t* tab,
                                            uint32_t* fr, uint32_t* cu, uint32_t* warp_max) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {  // the exclusive cumulative frequencies, mod 2^32, 8 symbols a lane
    uint32_t f[8], sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = static_cast<uint32_t>(freqs[8 * lane + i]);
      sum += f[i];
    }
    uint32_t inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    uint32_t run = inc - sum;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fr[8 * lane + i] = f[i];
      cu[8 * lane + i] = run;
      run += f[i];
    }
  }
  uint4* mine = reinterpret_cast<uint4*>(tab) + 4 * tid;
#pragma unroll
  for (int i = 0; i < 4; ++i) mine[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (fr[tid] != 0u && cu[tid] < kProbScale) tab[cu[tid]] = tid + 1u;  // symbol tid's mark
  __syncthreads();
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 v = mine[i];
    m[4 * i] = v.x, m[4 * i + 1] = v.y, m[4 * i + 2] = v.z, m[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int k = 1; k < 16; ++k) m[k] = max(m[k], m[k - 1]);
  uint32_t inc = m[15];  // the maximum up to this thread's last slot, by a warp scan
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = max(inc, y);
  }
  const uint32_t in_warp = __shfl_up_sync(kFull, inc, 1);
  if (lane == 31) warp_max[warp] = inc;
  __syncthreads();
  uint32_t before = lane ? in_warp : 0u;
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
  uint32_t e[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t slot = 16u * tid + k;
    const uint32_t s = (max(m[k], before) - 1u) & 0xFFu;  // the last mark at or before the slot
    e[k] = s | ((fr[s] - 1u) & 0xFFFu) << 8 | ((slot - cu[s]) & 0xFFFu) << 20;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) mine[i] = make_uint4(e[4 * i], e[4 * i + 1], e[4 * i + 2], e[4 * i + 3]);
  __syncthreads();
}

// Dynamic shared memory of a CTA: the table, the lanes' rings, the warps'
// tiles.
constexpr int kSmemBytes = kTableBytes + kThreads * kRingU16 * 2 + kThreads / 32 * kWarpTile;

__global__ void __launch_bounds__(kThreads)
rans_section_decode_kernel(Stream s, const int* __restrict__ freqs,
                           const uint32_t* __restrict__ states, const int* __restrict__ counts,
                           const int* __restrict__ ends, long long n_streams, long long n,
                           uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t fr[256], cu[256], warp_max[kThreads / 32];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + kTableBytes) + threadIdx.x * kRingU16;
  uint8_t* tiles = smem + kTableBytes + kThreads * kRingU16 * 2;

  const int lane = threadIdx.x & 31, j = lane & 7;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long c = g >> 3;  // the thread's chunk; lane j of it
  const bool real = g < n_streams;
  // the lane's real rows: byte c*4096 + 8t + j < n
  const long long left = n - c * kChunkBytes - j;
  const int rows = !real || left <= 0 ? 0 : static_cast<int>(min(static_cast<long long>(kRows), (left + 7) / 8));
  Lane d;
  d.x = real ? states[g] : 0u;
  // the lane's offset, an int32 difference as the reference's (wrapping)
  const long long p0 = real ? static_cast<int>(static_cast<uint32_t>(ends[g]) - static_cast<uint32_t>(counts[g])) : 0;
  d.base = p0 & ~7LL;
  d.r = static_cast<int>(p0 - d.base);
  d.f = 0;
  if (real) {  // the first kAhead u16s, under the table's build
#pragma unroll
    for (int i = 0; i < kAhead / 8; ++i) stage(d, ring, s);
  } else {
    d.f = 1 << 30;  // never stages
  }
  asm volatile("cp.async.commit_group;\n" ::);
  build_table(freqs, tab, fr, cu, warp_max);
  asm volatile("cp.async.wait_group 0;\n" ::);
  d.val = ring[d.r];

  uint8_t* tile = tiles + (threadIdx.x >> 5) * kWarpTile + (lane >> 3) * kTileStride;
  uint8_t* col = tile + j;
  const uint8_t* piece = tile + 16 * j;
  const long long dst0 = c * kChunkBytes + 16 * j;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int lo = __reduce_min_sync(kFull, rows), hi = __reduce_max_sync(kFull, rows);
  int t0 = 0;
  for (; t0 + kTileRows <= lo; t0 += kTileRows) {
    rows16<false>(d, t0, rows, tab, ring, s, col, piece, out, dst0, n, vec_out);
  }
  for (; t0 < hi; t0 += kTileRows) {  // a ragged last chunk, or past the last chunk
    rows16<true>(d, t0, rows, tab, ring, s, col, piece, out, dst0, n, vec_out);
  }
}

}  // namespace

// words uint32[ceil(total/2)] (the packed stream), freqs int32[256] (non-
// negative, summing to 4096), states uint32[C*8], counts int32[C*8], ends
// int32[C*8] (inclusive sums of the counts) -> out uint8[n], C = ceil(n /
// 4096); reads as over the stream zero-padded to cap >= total entries.
extern "C" int repro_rans_section_decode(const void* words, long long total, long long cap,
                                         const void* freqs, const void* states, const void* counts,
                                         const void* ends, long long n, void* out, void* stream) {
  const long long chunks = (n + kChunkBytes - 1) / kChunkBytes;
  if (chunks == 0) return 0;
  cudaError_t err = repro::allow_smem(rans_section_decode_kernel, kSmemBytes);
  // without it the shared-memory carveout may fit only one CTA per SM
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(rans_section_decode_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const Stream s{static_cast<const uint32_t*>(words), total, cap,
                 (reinterpret_cast<uintptr_t>(words) & 15) == 0};
  const unsigned grid = static_cast<unsigned>((chunks * kLanes + kThreads - 1) / kThreads);
  rans_section_decode_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const int*>(freqs), static_cast<const uint32_t*>(states),
      static_cast<const int*>(counts), static_cast<const int*>(ends), chunks * kLanes, n,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
